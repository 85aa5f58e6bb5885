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
// Design (a straightforward first kernel, right before fast):
//   * Grid (ceil(S / 64), H, B): one block per 64-row query tile of one head of one
//     sequence.  The TPU kernel walks the kv blocks of a tile in sequence (the
//     "arbitrary" grid axis) with (m, l, acc) in VMEM scratch; here a loop inside the block
//     does that, with (m, l, acc) in registers.  Tiles are issued heaviest first (the last
//     query tiles of a causal call see the most keys).
//   * Block skip without a host sync: the visible key range of the tile, [lo, hi), follows
//     from S, T, window, q_offset and the tile index alone (host ints and blockIdx).  The loop
//     runs over the 64-key tiles from the one holding lo, rounded down to a tile edge, to the
//     last one below hi; a tile wholly outside the range is never loaded.
//   * Tiles are loaded with 16-byte reads, masked at the S and T tails, into dynamic shared
//     memory (opted in per instantiation above 48 KB).
//   * float32 inputs, fa_fwd_kernel: products on CUDA cores in fp32 (FMA).  q (64 x D), the
//     K and V tiles (64 x D) and the probabilities (64 x 64) sit in shared memory (211 KB at
//     D = 256).  Each of 256 threads owns 4 query rows (ty + 16 i) x 4 keys (tx + 16 j) of
//     the score tile, and the same 4 rows x D / 16 output dims (owned_dim) of the
//     accumulator; Q and K rows are read as float4 with a padded row stride, so a
//     quarter-warp's reads fall in distinct banks.  A row's 16 threads are one half-warp, so
//     the row max and sum are shuffles.
//   * bfloat16 inputs: the same tiling on the tensor cores, fa_fwd_mma_kernel: 4 warps of 16
//     query rows each, warp mma.sync m16n8k16 (bf16 in, fp32 accumulators) for S = Q K^T and
//     for P V with P rounded to bf16, fragments loaded with ldmatrix from bf16 tiles in
//     shared memory (101 KB at D = 256, two blocks per SM).  Softmax, mask and (m, l) stay in
//     fp32 registers.  wgmma and a TMA / cp.async ring are left for later work.
// Supports D in {16, 32, 64, 128, 256}, any S, T >= 1, any G, T = float or bfloat16.  The
// wrapper (ops.py) checks shapes, types, strides and alignment before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s_len,
           int t_len, int h, int kv_heads, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
           long long v_sh, int causal, int window, int q_offset, float scale, float softcap,
           cudaStream_t stream) {
  const dim3 grid((s_len + BQ - 1) / BQ, h, b);
  static bool opted_in = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int rc = opt_in(fa_fwd_mma_kernel<D>, MmaSmem<D>::BYTES, opted_in);
    if (rc != 0) return rc;
    fa_fwd_mma_kernel<D><<<grid, MMA_NT, MmaSmem<D>::BYTES, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), s_len, t_len, h, h / kv_heads, q_sb, q_ss, q_sh, k_sb, k_st,
        k_sh, v_sb, v_st, v_sh, causal, window, q_offset, scale, softcap);
  } else {
    const int rc = opt_in(fa_fwd_kernel<D>, Smem<D>::BYTES, opted_in);
    if (rc != 0) return rc;
    fa_fwd_kernel<D><<<grid, NT, Smem<D>::BYTES, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), s_len, t_len, h, h / kv_heads, q_sb, q_ss, q_sh, k_sb, k_st,
        k_sh, v_sb, v_st, v_sh, causal, window, q_offset, scale, softcap);
  }
  return 0;
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out, int b,
               int s_len, int t_len, int h, int kv_heads, long long q_sb, long long q_ss,
               long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
               long long v_st, long long v_sh, int causal, int window, int q_offset,
               float scale, float softcap, cudaStream_t stream) {
#define FLASH_ATTENTION_CASE(DD)                                                            \
  case DD:                                                                                  \
    return launch<T, DD>(q, k, v, out, b, s_len, t_len, h, kv_heads, q_sb, q_ss, q_sh, k_sb, \
                         k_st, k_sh, v_sb, v_st, v_sh, causal, window, q_offset, scale,     \
                         softcap, stream);
  switch (d) {
    FLASH_ATTENTION_CASE(16)
    FLASH_ATTENTION_CASE(32)
    FLASH_ATTENTION_CASE(64)
    FLASH_ATTENTION_CASE(128)
    FLASH_ATTENTION_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ATTENTION_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means none, softcap <= 0 means none, causal
// is 0 or 1.  Strides are in elements.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int b, int s_len, int t_len, int h,
                                      int kv_heads, int d, long long q_sb, long long q_ss,
                                      long long q_sh, long long k_sb, long long k_st,
                                      long long k_sh, long long v_sb, long long v_st,
                                      long long v_sh, int causal, int window, int q_offset,
                                      float scale, float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s_len < 1 || t_len < 1 || kv_heads < 1 || h % kv_heads || q_offset < 0 ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0)
    rc = dispatch_d<float>(d, q, k, v, out, b, s_len, t_len, h, kv_heads, q_sb, q_ss, q_sh,
                           k_sb, k_st, k_sh, v_sb, v_st, v_sh, causal, window, q_offset,
                           scale, softcap, st);
  else if (dtype == 1)
    rc = dispatch_d<__nv_bfloat16>(d, q, k, v, out, b, s_len, t_len, h, kv_heads, q_sb,
                                   q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, causal,
                                   window, q_offset, scale, softcap, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
