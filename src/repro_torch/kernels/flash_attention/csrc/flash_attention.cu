// Flash attention forward for Hopper (sm_90a): causal or not, sliding window, tanh softcap,
// q_offset and GQA, with an fp32 online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (_fa_kernel).  Computes exactly repro_torch/kernels/flash_attention/ref.py::
// flash_attention_ref, in the model's own layout: q (B, S, H, D), k and v (B, T, K, D), each
// read through its strides (unit stride over D), out (B, S, H, D) contiguous in q's type.
// H = K * G; query head h reads kv head h / G (the Pallas index map b // g).  Query row i sits
// at absolute position i + q_offset; key j is visible to it when j <= i + q_offset (causal)
// and j > i + q_offset - window (sliding window).  Scores are (q . k) / sqrt(D), then
// softcap * tanh(s / softcap).  A row with no visible key is written as 0, as the Pallas
// kernel writes it (its denominator is max(l, 1e-30)).
//
// Bound: operations at the prefill shapes.  A call does 4 * D flops per visible (query, key)
// pair and head (q . k and p . v); gemma3-4b's global layer at B = 2, S = T = 4096, H = 8,
// D = 256, causal, is 137.4 GFLOP against 101 MB of q, k, v and out: 139 us at the bf16
// tensor-core peak, against 30 us for the bytes.
//
// Three designs; the wrapper (ops.py) picks one by type and D (ops.route) after checking
// shapes, types, strides and alignment:
//   * bfloat16 at D in {64, 128, 256} (every model path: gemma3-4b D 256, the moe archs D 128,
//     hymba D 64), fa_fwd_wgmma_kernel: one block per 128-row query tile of one (b, h), three
//     warpgroups.  A producer warpgroup (one thread issuing TMA, its registers lowered with
//     setmaxnreg) loads the Q tile once and keeps a ring of 2 stages of K and V tiles full (64
//     keys a stage at D 256, 128 below; 128-byte swizzle; a full and an empty mbarrier per
//     stage).  Two consumer warpgroups of 64 query rows each compute S = Q K^T with wgmma
//     (m64nBKk16, both operands in shared memory), the online softmax in registers on the
//     accumulator layout (exp2 of scores pre-scaled by log2(e) / sqrt(D); the mask only on
//     tiles that cross the causal diagonal, the window's lower edge or T's tail), and O += P V
//     with wgmma (P rounded to bf16 and repacked into A registers, V from shared memory through
//     the transpose bit), O in fp32 registers rescaled by alpha per tile.  The TMA maps are 4-D
//     over (D, heads, S or T, B) with the tensors' own strides, so the zero fill past S and T
//     stops at each sequence's own end.  The maps are encoded on the host at every call.
//     Blocks are issued with every (b, h)'s heaviest query tile first.
//   * bfloat16 at D in {16, 32} (smoke configs), fa_fwd_mma_kernel: grid (ceil(S / 64), H,
//     B), one block per 64-row query tile of one head of one sequence, 4 warps of 16 query rows
//     each, warp mma.sync m16n8k16 (bf16 in, fp32 accumulators) for S = Q K^T and for P V with
//     P rounded to bf16, fragments loaded with ldmatrix from bf16 tiles staged by all threads
//     with 16-byte loads (101 KB at D = 256, two blocks per SM).  It takes every D, and the
//     tests and chip_smoke.py hold and time it beside the wgmma design on the model shapes.
//   * float32, fa_fwd_kernel: the same grid, products on CUDA cores in fp32 (FMA).  q (64 x
//     D), the K and V tiles (64 x D) and the probabilities (64 x 64) sit in shared memory (211
//     KB at D = 256).  Each of 256 threads owns 4 query rows (ty + 16 i) x 4 keys (tx + 16 j)
//     of the score tile, and the same 4 rows x D / 16 output dims (owned_dim) of the
//     accumulator; Q and K rows are read as float4 with a padded row stride, so a
//     quarter-warp's reads fall in distinct banks.  A row's 16 threads are one half-warp, so
//     the row max and sum are shuffles.
// In every design a loop inside the block walks the key tiles of its query tile in order (the
// TPU kernel's "arbitrary" grid axis, with (m, l, acc) in VMEM scratch there and in registers
// here), and the block skip needs no host sync: the visible key range of the tile, [lo, hi),
// follows from S, T, window, q_offset and the tile index alone (host ints and blockIdx), and
// the loop runs over the key tiles from the one holding lo, rounded down to a tile edge, to the
// last one below hi; a tile wholly outside the range is never loaded.  A masked score gives
// p = 0 exactly, so a row with no visible key is written as 0.
// Supports D in {16, 32, 64, 128, 256}, any S, T >= 1, any G, T = float or bfloat16.  The
// wrapper (ops.py) checks shapes, types, strides and alignment before the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads per block: 16 (tx) x 16 (ty)
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int QK_STRIDE = D + 4;   // floats per staged q / k row (padded)
  static constexpr int V_STRIDE = D;
  static constexpr int P_STRIDE = BK + 4;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QK_STRIDE;
  static constexpr int V_OFF = K_OFF + BK * QK_STRIDE;
  static constexpr int P_OFF = V_OFF + BK * V_STRIDE;
  static constexpr int BYTES = (P_OFF + BQ * P_STRIDE) * (int)sizeof(float);
  static_assert(D % 16 == 0, "each of a row's 16 threads owns D / 16 dims");
};

// The j-th of the D / 16 output dims that thread tx owns: float4 chunks 64 apart for
// D >= 64 (16-byte reads of V), single dims 16 apart below.
template <int D>
__device__ __forceinline__ int owned_dim(int j, int tx) {
  if constexpr (D >= 64) return 4 * tx + 64 * (j / 4) + (j % 4);
  else return tx + 16 * j;
}

// Stage rows [0, 64) of a (rows, D) float slab, row r at base + r * row_stride, into shared
// memory with `stride` floats per row; rows at or past n_valid are written as zeros.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* base,
                                           long long row_stride, int n_valid) {
  constexpr int CH = D / 4;                  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, cc = c % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = reinterpret_cast<const float4*>(base + r * row_stride)[cc];
    *reinterpret_cast<float4*>(dst + r * stride + cc * 4) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int s_len, int t_len,
              int h, int g_n, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
              long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
              int causal, int window, int q_offset, float scale, float softcap) {
  using SM = Smem<D>;
  constexpr int DPT = D / 16;                // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + SM::Q_OFF;
  float* Ks = smem + SM::K_OFF;
  float* Vs = smem + SM::V_OFF;
  float* Ps = smem + SM::P_OFF;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / g_n;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, s_len - q0);

  // keys any row of this tile can see: [k_lo, k_hi)
  const int p_first = q0 + q_offset, p_last = q0 + q_rows - 1 + q_offset;
  int k_lo = 0, k_hi = t_len;
  if (causal) k_hi = min(k_hi, p_last + 1);
  if (window > 0) k_lo = max(k_lo, p_first - window + 1);
  const int tile_lo = (k_lo / BK) * BK;

  stage_rows<D>(Qs, SM::QK_STRIDE, q + b * q_sb + (long long)q0 * q_ss + hh * q_sh, q_ss,
                q_rows);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const float* kb = k + b * k_sb + kh * k_sh;
  const float* vb = v + b * v_sb + kh * v_sh;
  for (int k0 = tile_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // readers of the previous tile (and of nothing, the first time) are done
    const int n_keys = min(BK, t_len - k0);
    stage_rows<D>(Ks, SM::QK_STRIDE, kb + (long long)k0 * k_st, k_st, n_keys);
    stage_rows<D>(Vs, SM::V_STRIDE, vb + (long long)k0 * v_st, v_st, n_keys);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * SM::QK_STRIDE + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * SM::QK_STRIDE + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(qa[i].x, kv[j].x, s);
          s = fmaf(qa[i].y, kv[j].y, s);
          s = fmaf(qa[i].z, kv[j].z, s);
          s = fmaf(qa[i].w, kv[j].w, s);
          sc[i][j] = s;
        }
    }

    // mask, online softmax; the probabilities go to shared memory for p . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row + q_offset;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < t_len && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        s = ok[j] ? s : NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[row * SM::P_STRIDE + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p . v over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * SM::P_STRIDE + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * SM::V_STRIDE;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
        if constexpr (D >= 64) {
#pragma unroll
          for (int c = 0; c < DPT / 4; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * tx + 64 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][4 * c + 0] = fmaf(p[i], vv.x, acc[i][4 * c + 0]);
              acc[i][4 * c + 1] = fmaf(p[i], vv.y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(p[i], vv.z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(p[i], vv.w, acc[i][4 * c + 3]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            const float vv = vrow[owned_dim<D>(c, tx)];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30): 0 for a row that saw no key
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row < q_rows) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* o = out + (((long long)b * s_len + q0 + row) * h + hh) * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) o[owned_dim<D>(c, tx)] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------------------
// bfloat16: the same algorithm on the tensor cores (warp mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------------------

constexpr int MMA_NT = 128;      // 4 warps, 16 query rows each

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [0, 64) of a (rows, D) bf16 slab into shared memory as they are (ld elements per
// row); rows at or past n_valid are zeros.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld, const __nv_bfloat16* base,
                                           long long row_stride, int n_valid) {
  constexpr int CH = D / 8;                  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CH; c += MMA_NT) {
    const int r = c / CH, cc = c % CH;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) raw = reinterpret_cast<const uint4*>(base + r * row_stride)[cc];
    *reinterpret_cast<uint4*>(dst + r * ld + cc * 8) = raw;
  }
}

template <int D>
struct MmaSmem {
  static constexpr int LD = D + 8;           // bf16 per staged row (16-byte pad: no bank conflicts)
  static constexpr int BYTES = 3 * 64 * LD * (int)sizeof(__nv_bfloat16);
};

// Warp w owns query rows 16 w .. 16 w + 15 of the tile.  Fragment layouts are those of
// mma.m16n8k16: a thread (g = lane / 4, t = lane % 4) holds score / accumulator elements of
// rows g and g + 8, columns 2 t and 2 t + 1 of each 8-wide n-tile.  S = Q K^T takes its A
// fragments from Q and its B fragments from K rows with ldmatrix; the probabilities P are
// rounded to bf16 and fed back as A fragments of P V, with V's B fragments from
// ldmatrix.trans.  The row max and sum are reduced over the 4 threads of a row group.
template <int D>
__global__ void __launch_bounds__(MMA_NT, 2)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  int s_len, int t_len, int h, int g_n, long long q_sb, long long q_ss,
                  long long q_sh, long long k_sb, long long k_st, long long k_sh,
                  long long v_sb, long long v_st, long long v_sh, int causal, int window,
                  int q_offset, float scale, float softcap) {
  constexpr int LD = MmaSmem<D>::LD;
  constexpr int NT_D = D / 8;                // n-tiles of the output
  static_assert(D % 16 == 0, "D must be a multiple of the mma depth 16");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / g_n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, s_len - q0);

  const int p_first = q0 + q_offset, p_last = q0 + q_rows - 1 + q_offset;
  int k_lo = 0, k_hi = t_len;
  if (causal) k_hi = min(k_hi, p_last + 1);
  if (window > 0) k_lo = max(k_lo, p_first - window + 1);
  const int tile_lo = (k_lo / BK) * BK;

  stage_bf16<D>(Qs, LD, q + b * q_sb + (long long)q0 * q_ss + hh * q_sh, q_ss, q_rows);

  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // absolute positions of this thread's two rows
  const int qpos0 = q0 + 16 * warp + g + q_offset;

  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;
  for (int k0 = tile_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    const int n_keys = min(BK, t_len - k0);
    stage_bf16<D>(Ks, LD, kb + (long long)k0 * k_st, k_st, n_keys);
    stage_bf16<D>(Vs, LD, vb + (long long)k0 * v_st, v_st, n_keys);
    __syncthreads();

    // S (16 x 64 per warp) = Q K^T
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, Ks + (8 * j + (lane & 7) + (lane >> 4) * 8) * LD + kk + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[j], a, bk[0], bk[1]);
        mma_bf16(sc[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, mask; online softmax per row (r = 0: row g, r = 1: row g + 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + e;
          float x = sc[j][2 * r + e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          const bool ok = kpos < t_len && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : NEG_INF;
          sc[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[j][2 * r + e];
          const float p = x == NEG_INF ? 0.f : expf(x - m_new);
          sc[j][2 * r + e] = p;
          ps += p;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[r] = alpha * l[r] + ps;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // acc (16 x D per warp) += P V, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT_D; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * n +
                              (lane >> 4) * 8);
        mma_bf16(acc[n], a, bv[0], bv[1]);
        mma_bf16(acc[n + 1], a, bv[2], bv[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30): 0 for a row that saw no key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row < q_rows) {
      const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* o = out + (((long long)b * s_len + q0 + row) * h + hh) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        *reinterpret_cast<uint32_t*>(o + 8 * n) =
            pack_bf16(acc[n][2 * r] * inv_l, acc[n][2 * r + 1] * inv_l);
    }
  }
}

// ---------------------------------------------------------------------------------------
// bfloat16 at D in {64, 128, 256}: a TMA ring and wgmma, producer and consumer warpgroups
// ---------------------------------------------------------------------------------------

constexpr int WG_BQ = 128;       // query rows per block: consumer warpgroups 0 and 1, 64 each
constexpr int WG_NT = 384;       // and the producer, warpgroup 2
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU alone (ex2.approx.ftz: relative error about 2^-22; a subnormal result, a p
// below 2^-126 of its row's max, is flushed to 0).  exp2f adds the handling of subnormals
// around the same instruction, and the softmax's exponents are a bottleneck at D 128: the
// deepseek-moe-16b layer read 96.8 us with exp2f, 91.0 with this (PERF.md, section 6).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct WgCfg {
  static constexpr int BK = D == 256 ? 64 : 128;   // keys per stage
  static constexpr int STAGES = 2;
  static constexpr int BOXES = D / 64;             // 64-column (128-byte) TMA boxes per row
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // the K (or the V) of one stage
  static constexpr int STAGE = 2 * KV_BYTES;
  // Q, the ring, Q's barrier, full[] and empty[], and room to align Q to 1024 bytes
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

// One block per 128-row query tile of one (b, h); blockIdx.x = b * H + h, blockIdx.y the
// tile, taken from the last: every head's heaviest tiles (under a causal mask) are issued
// first, and the G query heads of a kv head run side by side, sharing its K and V in L2.
//
// Shared memory, every tile as TMA writes it (rows of 128 bytes, 128-byte swizzle), in boxes
// of 64 columns: Q (D / 64 boxes of 128 rows), then STAGES stages of [K: D / 64 boxes of BK
// rows][V: the same], then the barriers.  The producer's one thread loads Q once and keeps the
// ring full: it waits on a stage's empty barrier (one arrival per consumer warpgroup), then
// loads K and V into it against its full barrier.  Consumer warpgroup c owns rows
// [64 c, 64 c + 64) of the tile: for every key tile it
//   * S (64 x BK, fp32) = Q K^T, wgmma m64nBKk16 with both operands in shared memory,
//     K-major (Q's rows and K's rows hold D);
//   * takes the online softmax on S's accumulator layout (thread g = lane / 4, t = lane % 4
//     of warp w holds rows 16 w + g and + 8, columns 8 j + 2 t and + 1; a row's values lie on
//     the 4 threads of a quad), in log2 units (2^x of scores times log2(e) / sqrt(D)); the
//     mask and the per-element bounds run only on a tile that crosses the causal diagonal, the
//     window's lower edge or T's tail for one of its rows;
//   * rounds P to bf16 into the A-register layout of wgmma (that of mma.m16n8k16's A
//     fragment, which S's accumulators already follow two n-tiles at a time), and
//     O (64 x D, fp32) = alpha O + P V, wgmma m64nDk16 with A from registers and V
//     MN-major through the transpose bit;
//   * releases the stage.
// A key tile that no row of a warpgroup sees (outside [w_lo, w_hi)) is waited for and
// released, never multiplied.  TMA's zero fill covers S's and T's tails: the maps are 4-D
// over (D, heads, S or T, B), so a box never reaches into the next sequence.
template <int D>
__global__ void __launch_bounds__(WG_NT, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                    int s_len, int t_len, int h, int g_n, int causal, int window, int q_offset,
                    float scale, float softcap) {
  using Cfg = WgCfg<D>;
  constexpr int BK = Cfg::BK, STAGES = Cfg::STAGES;
  extern __shared__ __align__(1024) unsigned char fa_wg_smem[];
  const uint32_t qs = (smem_u32(fa_wg_smem) + 1023) & ~1023u;
  const uint32_t ring = qs + Cfg::Q_BYTES;
  const uint32_t q_bar = ring + STAGES * Cfg::STAGE;
  const uint32_t full0 = q_bar + 8, empty0 = full0 + 8 * STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int hh = blockIdx.x % h, b = blockIdx.x / h;
  const int kh = hh / g_n;
  const int q0 = qt * WG_BQ;
  const int q_rows = min(WG_BQ, s_len - q0);

  // keys any row of the block sees, [k_lo, k_hi), from host ints and blockIdx alone
  int k_lo = 0, k_hi = t_len;
  if (causal) k_hi = min(k_hi, q0 + q_rows + q_offset);
  if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
  const int tile_lo = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - tile_lo + BK - 1) / BK : 0;
  const int wgrp = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);     // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2);    // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgrp == 2) {
    // producer: one thread loads Q, then keeps the ring of K and V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(q_bar, Cfg::Q_BYTES);
#pragma unroll
      for (int c = 0; c < Cfg::BOXES; ++c)
        tma_load_4d(qs + c * WG_BQ * 128, &tq, 64 * c, hh, q0, b, q_bar);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, k0 = tile_lo + it * BK;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, (it / STAGES - 1) & 1);
        const uint32_t kt = ring + s * Cfg::STAGE, full = full0 + 8 * s;
        mbar_expect_tx(full, Cfg::STAGE);
#pragma unroll
        for (int c = 0; c < Cfg::BOXES; ++c) {
          tma_load_4d(kt + c * BK * 128, &tk, 64 * c, kh, k0, b, full);
          tma_load_4d(kt + Cfg::KV_BYTES + c * BK * 128, &tv, 64 * c, kh, k0, b, full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + 64 * wgrp;              // the warpgroup's first row
    const int wg_rows = min(64, s_len - r0);    // <= 0: the tile's second half lies past S
    // keys the warpgroup's rows see: [w_lo, w_hi)
    int w_lo = 0, w_hi = wg_rows > 0 ? t_len : 0;
    if (causal) w_hi = min(w_hi, r0 + wg_rows + q_offset);
    if (window > 0) w_lo = max(w_lo, r0 + q_offset - window + 1);
    const int pos_a = r0 + 16 * w + g + q_offset;   // positions of the thread's rows g, g + 8
    const int pos_b = pos_a + 8;
    // a score s becomes s * scale (or softcap * tanh(s * scale / softcap)), times mul: log2 units
    const float mul = softcap > 0.f ? LOG2E : scale * LOG2E;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
    const uint32_t qa = qs + wgrp * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // running max (log2 units) and this thread's share of the row sum, rows g (a) and g + 8 (b)
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    bool ok = true;   // every wait ended (mbar_wait_bounded)
    if (n_tiles > 0) ok = mbar_wait_bounded(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, k0 = tile_lo + it * BK;
      ok &= mbar_wait_bounded(full0 + 8 * s, (it / STAGES) & 1);
      if (k0 < w_hi && k0 + BK > w_lo) {
        const uint32_t kt = ring + s * Cfg::STAGE, vt = kt + Cfg::KV_BYTES;
        // S = Q K^T
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<BK, 0>(sc, gmma_desc(qa + (ks / 4) * WG_BQ * 128 + (ks % 4) * 32, 16, 1024),
                          gmma_desc(kt + (ks / 4) * BK * 128 + (ks % 4) * 32, 16, 1024), ks);
        wgmma_commit();
        fence_acc(sc);
        wgmma_wait<0>();
        fence_acc(sc);

        if (softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) sc[i] = softcap * tanhf(sc[i] * cap_in);
        }
        // every key of the tile visible to every row of the warpgroup: no mask
        const bool whole = k0 + BK <= t_len && (!causal || k0 + BK - 1 <= r0 + q_offset) &&
                           (window <= 0 || k0 > r0 + 63 + q_offset - window);
        if (!whole) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + 2 * t4 + e;
              const bool in = kpos < t_len;
              if (!(in && (!causal || kpos <= pos_a) && (window <= 0 || kpos > pos_a - window)))
                sc[4 * j + e] = -INFINITY;
              if (!(in && (!causal || kpos <= pos_b) && (window <= 0 || kpos > pos_b - window)))
                sc[4 * j + 2 + e] = -INFINITY;
            }
        }

        // online softmax, each row over the 4 threads of its quad
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a * mul), mn_b = fmaxf(m_b, mx_b * mul);
        // a row that has seen no key keeps m = -inf and takes its exponents from 0: its masked
        // scores (-inf) give p = 0 and its alpha 0, so it comes out as 0
        const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
        const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
        const float al_a = exp2_approx(m_a - base_a), al_b = exp2_approx(m_b - base_b);
        m_a = mn_a;
        m_b = mn_b;
        float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], mul, -base_a));
            sc[4 * j + 2 + e] = exp2_approx(fmaf(sc[4 * j + 2 + e], mul, -base_b));
            ps_a += sc[4 * j + e];
            ps_b += sc[4 * j + 2 + e];
          }
        l_a = l_a * al_a + ps_a;   // from the unrounded p
        l_b = l_b * al_b + ps_b;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }
        // P in bf16, as A fragments: keys 16 kk .. 16 kk + 15 are S's n-tiles 2 kk and 2 kk + 1
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }

        // O += P V
        fence_acc(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D, 1>(o, pa[kk], gmma_desc(vt + kk * 16 * 128, BK * 128, 1024), 1);
        wgmma_commit();
        fence_acc(o);
        wgmma_wait<0>();
        fence_acc(o);
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * s);
    }

    // out = O / max(l, 1e-30): 0 for a row that saw no key; NaN if a wait gave up
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float nan = __int_as_float(0x7fc00000);
    const float inv_a = ok ? 1.f / fmaxf(l_a, 1e-30f) : nan;
    const float inv_b = ok ? 1.f / fmaxf(l_b, 1e-30f) : nan;
    const int row_a = r0 + 16 * w + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= s_len) continue;
      const float inv = r ? inv_b : inv_a;
      __nv_bfloat16* po = out + (((long long)b * s_len + row) * h + hh) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(po + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------------------

// Opt a kernel into `bytes` of dynamic shared memory, once (above 48 KB it must be asked for).
template <typename Kernel>
int opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

// One call's arguments, as flash_attention_launch takes them (strides in elements).
struct Call {
  const void *q, *k, *v;
  void* out;
  int b, s_len, t_len, h, kv_heads;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int causal, window, q_offset;
  float scale, softcap;
  cudaStream_t stream;
};

// The grid (ceil(S / 64), H, B) of the FMA and mma.sync kernels.  D keeps one opt-in flag per
// kernel (the kernels of one T share a type).
template <typename T, int D, typename Kernel>
int launch_64(Kernel kernel, int threads, int smem, const Call& c) {
  static bool opted_in = false;
  const int rc = opt_in(kernel, smem, opted_in);
  if (rc != 0) return rc;
  const dim3 grid((c.s_len + BQ - 1) / BQ, c.h, c.b);
  kernel<<<grid, threads, smem, c.stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k), static_cast<const T*>(c.v),
      static_cast<T*>(c.out), c.s_len, c.t_len, c.h, c.h / c.kv_heads, c.q_sb, c.q_ss, c.q_sh,
      c.k_sb, c.k_st, c.k_sh, c.v_sb, c.v_st, c.v_sh, c.causal, c.window, c.q_offset, c.scale,
      c.softcap);
  return 0;
}

// A 4-D map over a bf16 tensor in the model's layout (B, rows, heads, D) with element strides
// (s_b, s_r, s_h, 1): dimensions (D, heads, rows, B), innermost first; boxes of 64 columns x
// 1 head x box_rows rows x 1 sequence; zero fill past every edge.
int encode_4d(CUtensorMap* map, const void* p, int b, int rows, int heads, int d, long long s_b,
              long long s_r, long long s_h, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)b};
  // a dimension of extent 1 is never stepped along: give it the stride of a packed tensor,
  // whatever stride (0, say) the tensor reports there
  cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_r * 2, (cuuint64_t)s_b * 2};
  if (heads == 1) strides[0] = (cuuint64_t)d * 2;
  if (rows == 1) strides[1] = strides[0] * heads;
  if (b == 1) strides[2] = strides[1] * rows;
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                         strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_wgmma(const Call& c) {
  using Cfg = WgCfg<D>;
  const int q_tiles = (c.s_len + WG_BQ - 1) / WG_BQ;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  // encoded on the host at every call (they hold the call's pointers and strides)
  CUtensorMap tq, tk, tv;
  int rc = encode_4d(&tq, c.q, c.b, c.s_len, c.h, D, c.q_sb, c.q_ss, c.q_sh, WG_BQ);
  if (!rc) rc = encode_4d(&tk, c.k, c.b, c.t_len, c.kv_heads, D, c.k_sb, c.k_st, c.k_sh, Cfg::BK);
  if (!rc) rc = encode_4d(&tv, c.v, c.b, c.t_len, c.kv_heads, D, c.v_sb, c.v_st, c.v_sh, Cfg::BK);
  if (rc) return rc;
  static bool opted_in = false;
  rc = opt_in(fa_fwd_wgmma_kernel<D>, Cfg::SMEM, opted_in);
  if (rc) return rc;
  fa_fwd_wgmma_kernel<D><<<dim3(c.h * c.b, q_tiles), WG_NT, Cfg::SMEM, c.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(c.out), c.s_len, c.t_len, c.h, c.h / c.kv_heads,
      c.causal, c.window, c.q_offset, c.scale, c.softcap);
  return 0;
}

// design 0: fa_fwd_kernel (float32), 1: fa_fwd_mma_kernel (bfloat16), 2: fa_fwd_wgmma_kernel
// (bfloat16, D >= 64)
template <int D>
int launch(int design, const Call& c) {
  using bf16 = __nv_bfloat16;
  if (design == 0) return launch_64<float, D>(fa_fwd_kernel<D>, NT, Smem<D>::BYTES, c);
  if (design == 1) return launch_64<bf16, D>(fa_fwd_mma_kernel<D>, MMA_NT, MmaSmem<D>::BYTES, c);
  if constexpr (D >= 64) {
    if (design == 2) return launch_wgmma<D>(c);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// design: 0 = fp32 FMA (float32), 1 = mma.sync (bfloat16, any D), 2 = TMA + wgmma (bfloat16,
// D in {64, 128, 256}).  window <= 0 means none, softcap <= 0 means none, causal is 0 or 1.
// Strides are in elements.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int design, int b, int s_len, int t_len, int h,
                                      int kv_heads, int d, long long q_sb, long long q_ss,
                                      long long q_sh, long long k_sb, long long k_st,
                                      long long k_sh, long long v_sb, long long v_st,
                                      long long v_sh, int causal, int window, int q_offset,
                                      float scale, float softcap, void* stream) {
  if (b < 1 || s_len < 1 || t_len < 1 || kv_heads < 1 || h % kv_heads || q_offset < 0 ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k, v, out, b, s_len, t_len, h, kv_heads, q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
               v_sb, v_st, v_sh, causal, window, q_offset, scale, softcap,
               static_cast<cudaStream_t>(stream)};
  int rc;
  switch (d) {
    case 16: rc = launch<16>(design, c); break;
    case 32: rc = launch<32>(design, c); break;
    case 64: rc = launch<64>(design, c); break;
    case 128: rc = launch<128>(design, c); break;
    case 256: rc = launch<256>(design, c); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
