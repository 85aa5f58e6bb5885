// Grouped expert SwiGLU FFN for Hopper (sm_90a): out[e] = (silu(x[e] wg[e]) * (x[e] wu[e])) wo[e].
//
// Replaces the TPU kernel repro/kernels/moe_gemm/kernel.py::moe_expert_ffn_fwd (_moe_kernel, its
// pallas_call at :61).  Computes repro_torch/kernels/moe_gemm/ref.py::moe_expert_ffn_ref: x
// (E, C, d) the experts' capacity buffers, wg and wu (E, d, f), wo (E, f, d), all contiguous
// and of one type (float or bfloat16); h = silu(x wg) * (x wu), out = h wo, sums in fp32, cast
// once to x's type.  Any C >= 1; d and f multiples of 8.  Two passes, as the TPU kernel's f
// blocks are two products: up (h into a workspace (E, C, f)) and down (out).
//
// Bounds.  A call reads the weights, 3 E d f elements, and x, and writes out: (3 E d f +
// 2 E C d) elements; it does 6 E C d f flops, 2 C per weight.  deepseek-moe-16b (E 64, d 2048,
// f 1408, bf16):
//   * prefill call, C 480: 531.5 GFLOP over the 989 TFLOP/s bf16 tensor-core peak = 537.4 us
//     (the bytes take 356 us): bound by operations;
//   * decode call, C 8: 1.107 GB over 3.35 TB/s = 331.8 us (8 flops per weight byte): bound by
//     bytes.  At 2 slots 2 tokens x top-6 occupy at most 12 experts and x is zero in the rest;
//     the weights those 12 need, 207.6 MB, take 62 us.
//
// Three designs; the wrapper (ops.py) picks one by type and C (ops.route) after checking
// shapes, types, contiguity and alignment:
//   * bfloat16, C above ops.STREAM_MAX_C (the prefill call): a grouped GEMM on the tensor cores
//     (moe_up_wgmma_kernel, moe_down_wgmma_kernel).  A block owns one expert, 128 token rows
//     and BN output columns (128 of f for up with gate and up side by side, 256 of d for down).
//     One producer thread keeps a ring of 4 stages of TMA loads in flight (x or h 128 x 64,
//     weights 64 x BN, 48 KB a stage, 128-byte swizzle, one full and one empty mbarrier per
//     stage); two consumer warpgroups of 64 rows each run wgmma m64nBNk16 (bf16 in, fp32
//     accumulators, the weights MN-major through the transpose bit) and write silu(g) * u (up)
//     or the sums (down) as bf16.  The TMA maps are 3-D over (E, rows, cols), so the zero fill
//     past C, d or f never reaches the next expert.  One wave of blocks (one per SM) walks the
//     tiles in order, the token-row tile fastest: the 4 row tiles of one (expert, column tile)
//     run together and read the weight tile through L2, so each weight comes from device
//     memory about once a call rather than once per row tile; and the producer fills a
//     block's next tile during its consumers' epilogue.  h is a bf16 workspace (86.5 MB at
//     C 480), rounded as the bmm chain rounds it.
//   * bfloat16, C <= ops.STREAM_MAX_C (the decode call): a weight stream that skips empty
//     experts (moe_occupancy_kernel, moe_up_stream_kernel, moe_down_stream_kernel).  One block
//     per expert reads x[e]; if every value is 0 (either sign) it writes the expert's zeros
//     (silu(0) * 0 = 0, 0 wo = 0) and flags it empty.  The two passes then launch one wave of
//     blocks that walk the occupied experts' (expert, column tile) items only, so an empty
//     expert costs no weight byte and no block.  A block's 8 warps split the reduction axis;
//     each streams 16-row weight slices of 128 columns with 16-byte cp.async into its own
//     ring (2 stages of 8 KB up, 3 of 4 KB down; 16-byte chunks XOR-swizzled), and multiplies
//     on the tensor cores with the operands swapped: weights are the 16-row A operand of
//     mma.sync m16n8k16 (ldmatrix.trans) and the 8 token rows its N.  The warps' partial sums
//     meet in shared memory.  h is bf16.  C <= 16.  The GEMM could skip empty experts the
//     same way (the flags first, then only occupied tiles), but a build that did read 102-106
//     us at 12 of 64 experts against the stream's 95-96, 410-414 us dense against 393-394,
//     and the flag pass in front cost its prefill call ~55 us (PERF.md).
//   * float32, any C: two passes of fp32 FMA on CUDA cores (moe_up_fma_kernel,
//     moe_down_fma_kernel; TF32 would not hold 8e-5), a grid over (column tiles of 64,
//     c-tiles of 8 rows, E); each block stages its (8 x K) slice of x or h transposed in
//     shared memory, 16 threads span a 64-column strip of a weight row, 16 row groups split
//     the reduction axis.  h is an fp32 workspace.
// In the bf16 designs every kernel after a call's first is a programmatic dependent launch
// (launch_after): its blocks take an SM as the previous kernel's blocks leave.  The GEMM's
// mbarriers, TMA loads and wgmma come from kernels/csrc/hopper.cuh, shared with K2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

using bf16 = __nv_bfloat16;

// silu(g) * u.  The sigmoid is 1 / (1 + e^-g): an IEEE division of 0 (g = 0 in every empty
// row) leaves the division's fast path for its slow subroutine, which cost the prefill call
// a third of its time on the model's own inputs.
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = 1.f / (1.f + expf(-g));
  return g * sig * u;
}

// Programmatic dependent launch (launch_after below): the second and third kernels of a call
// may be scheduled while the one before drains; each waits here, before it reads what that
// one wrote, until it has completed and its writes are visible.  A kernel launched the
// ordinary way passes the wait at once.
__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch kernel<<<grid, threads, smem, stream>>>(args...) as a programmatic dependent of the
// kernel before it on the stream.  Every kernel so launched here fits one wave, so its blocks
// take an SM only as the blocks before them leave.
template <typename... Params, typename... Args>
int launch_after(void (*kernel)(Params...), int grid, int threads, int smem, cudaStream_t stream,
                 Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------------------
// float32: fp32 FMA on CUDA cores
// ---------------------------------------------------------------------------------------

constexpr int NT = 256;             // threads per block
constexpr int NWARP = NT / 32;
constexpr int CT = 8;               // token rows per block (one c-tile)
constexpr int VEC = 4;              // output columns per thread
constexpr int COLS = 64;            // output columns per block
constexpr int TPR = COLS / VEC;     // threads across one weight row (16, half a warp)
constexpr int RG = NT / TPR;        // row groups splitting the reduction axis (16)
constexpr int KCH = 2048;           // reduction rows staged in shared memory at a time

static_assert(TPR == 16, "the shuffle below pairs the two half-warps of a warp");

template <int NMAT>
constexpr size_t fma_smem_bytes(int k) {
  const int stage = (k < KCH ? k : KCH) * CT;
  const int red = NWARP * NMAT * CT * COLS;
  return (size_t)(stage > red ? stage : red) * sizeof(float);
}

// For the block's expert e, token rows [c0, c0 + CT) and columns [n0, n0 + COLS):
//   s_m[c][n] = sum_k a[e, c, k] * w_m[e, k, n]   (k over [0, K), fp32)
// with a (E, C, K) and w_m (E, K, N).  NMAT = 2 (up: a = x, w = wg, wu) writes
// h = silu(s_0) * s_1 to out (E, C, N); NMAT = 1 (down: a = h, w = wo) writes s_0.
template <int NMAT>
__device__ __forceinline__ void fma_pass(const float* __restrict__ a, const float* __restrict__ w0,
                                         const float* __restrict__ w1, float* __restrict__ out,
                                         int C, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * COLS, c0 = blockIdx.y * CT, e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = tid % TPR, rg = tid / TPR;
  const int col = n0 + tq * VEC;
  // N is a multiple of 8, so a thread's 4 columns lie all inside N or all outside it
  const bool col_ok = col < N;

  float acc[NMAT][CT][VEC];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[m][c][j] = 0.f;

  const long long wexp = (long long)e * K * N;
  const float* wp[NMAT];
  wp[0] = w0 + wexp + col;
  if constexpr (NMAT == 2) wp[1] = w1 + wexp + col;
  const float* ae = a + ((long long)e * C + c0) * K;
  const float4* s4 = reinterpret_cast<const float4*>(smem);

  for (int k0 = 0; k0 < K; k0 += KCH) {
    const int kn = min(KCH, K - k0);
    __syncthreads();  // readers of the previous chunk are done
    // stage a[c0 : c0 + CT, k0 : k0 + kn] as smem[k][c]; rows at or past C are zero
    for (int i = tid; i < CT * kn; i += NT) {
      const int c = i / kn, k = i - c * kn;
      smem[k * CT + c] = (c0 + c < C) ? ae[(long long)c * K + k0 + k] : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 4
      for (int k = rg; k < kn; k += RG) {
        const float4 xa = s4[k * 2], xb = s4[k * 2 + 1];
        const float xv[CT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const long long row = (long long)(k0 + k) * N;
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          const float4 w = *reinterpret_cast<const float4*>(wp[m] + row);
          const float wv[VEC] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[m][c][j] = fmaf(xv[c], wv[j], acc[m][c][j]);
        }
      }
    }
  }

  // sum the 16 row groups: the two of a warp by a shuffle, then the 8 warps in shared memory
  __syncthreads();  // the staged chunk is no longer read
  float* red = smem;  // [NWARP][NMAT][CT][COLS]
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = acc[m][c][j] + __shfl_xor_sync(0xffffffffu, acc[m][c][j], 16);
      if (lane < TPR)
        *reinterpret_cast<float4*>(&red[((warp * NMAT + m) * CT + c) * COLS + tq * VEC]) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
  __syncthreads();
  for (int i = tid; i < CT * COLS; i += NT) {
    const int c = i / COLS, n = i - c * COLS;
    if (c0 + c >= C || n0 + n >= N) continue;
    float s[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) t += red[((w * NMAT + m) * CT + c) * COLS + n];
      s[m] = t;
    }
    const long long o = ((long long)e * C + c0 + c) * N + n0 + n;
    if constexpr (NMAT == 2) out[o] = silu_mul(s[0], s[1]);
    else out[o] = s[0];
  }
}

__global__ void __launch_bounds__(NT, 2)
moe_up_fma_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                  const float* __restrict__ wu, float* __restrict__ h, int C, int d, int f) {
  fma_pass<2>(x, wg, wu, h, C, d, f);
}

__global__ void __launch_bounds__(NT, 2)
moe_down_fma_kernel(const float* __restrict__ h, const float* __restrict__ wo,
                    float* __restrict__ out, int C, int d, int f) {
  fma_pass<1>(h, wo, nullptr, out, C, f, d);
}

int launch_fma(const void* x, const void* wg, const void* wu, const void* wo, void* h, void* out,
               int e, int c, int d, int f, cudaStream_t stream) {
  const size_t up_smem = fma_smem_bytes<2>(d), down_smem = fma_smem_bytes<1>(f);
  cudaError_t rc = cudaFuncSetAttribute(moe_up_fma_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)up_smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(moe_down_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)down_smem);
  if (rc != cudaSuccess) return (int)rc;
  if (c > 65535 * CT) return (int)cudaErrorInvalidValue;
  const int c_tiles = (c + CT - 1) / CT;
  moe_up_fma_kernel<<<dim3((f + COLS - 1) / COLS, c_tiles, e), NT, up_smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<float*>(h), c, d, f);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  moe_down_fma_kernel<<<dim3((d + COLS - 1) / COLS, c_tiles, e), NT, down_smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(wo), static_cast<float*>(out), c,
      d, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// bfloat16, small C: a weight stream on mma.sync that skips empty experts
// ---------------------------------------------------------------------------------------

constexpr int ST_XLD = 48;          // bytes per staged token row of a 16-deep slice (32 + pad)

template <int NMAT, int NB, int NTT, int STAGES>
struct StreamCfg {
  static constexpr int CP = 8 * NTT;                    // token rows, padded to the mma's N
  static constexpr int W_BYTES = 16 * NB * 2;           // one matrix's 16 x NB slice
  static constexpr int STAGE = NMAT * W_BYTES + CP * ST_XLD;
  static constexpr int RING = NWARP * STAGES * STAGE;   // one ring of STAGES slots per warp
  static constexpr int RED_LD = NB + 4;                 // floats per partial-sum row (padded)
  static constexpr int RED = NWARP * NMAT * CP * RED_LD * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
  static_assert(NB % 64 == 0, "the swizzle XORs the low 3 bits of a 16-byte chunk index");
  static_assert(W_BYTES % 16 == 0 && STAGE % 16 == 0, "cp.async needs 16-byte slots");
  static_assert(NMAT * 16 * NB / 8 % 32 == 0, "a warp loads a weight slice in whole rounds");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
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

// occ[e] = 1 if x[e] (C x d) holds a value other than 0 (of either sign); else occ[e] = 0
// and the expert's output is written as zeros here: silu(0) * 0 = 0 and 0 wo = 0.
__global__ void __launch_bounds__(NT)
moe_occupancy_kernel(const bf16* __restrict__ x, int* __restrict__ occ, bf16* __restrict__ out,
                     int CK) {
  allow_next_grid();
  const long long base = (long long)blockIdx.x * CK;
  const uint4* x4 = reinterpret_cast<const uint4*>(x + base);
  int nonzero = 0;
  for (int q = threadIdx.x; q < CK / 8; q += NT) {
    const uint4 v = x4[q];
    nonzero |= ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0u;
  }
  nonzero = __syncthreads_or(nonzero);
  if (!nonzero) {
    uint4* o4 = reinterpret_cast<uint4*>(out + base);
    for (int q = threadIdx.x; q < CK / 8; q += NT) o4[q] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) occ[blockIdx.x] = nonzero;
}

// The number of occupied experts, and the slot-th of them (slot < that number); every warp
// finds them alone, 32 flags a ballot.
__device__ __forceinline__ int count_occupied(const int* __restrict__ occ, int E) {
  int n = 0;
  for (int base = 0; base < E; base += 32)
    n += __popc(__ballot_sync(0xffffffffu, base + (threadIdx.x & 31) < E &&
                                               occ[base + (threadIdx.x & 31)] != 0));
  return n;
}
__device__ __forceinline__ int occupied_expert(const int* __restrict__ occ, int E, int slot) {
  for (int base = 0, seen = 0; base < E; base += 32) {
    const int i = base + (threadIdx.x & 31);
    const unsigned m = __ballot_sync(0xffffffffu, i < E && occ[i] != 0);
    const int n = __popc(m);
    if (slot < seen + n) {
      unsigned rest = m;
      for (int skip = slot - seen; skip > 0; --skip) rest &= rest - 1;   // drop lower set bits
      return base + __ffs(rest) - 1;
    }
    seen += n;
  }
  return 0;   // unreachable for slot < count_occupied
}

// One (expert e, columns [n0, n0 + NB)) item of stream_pass.
template <int NMAT, int NB, int NTT, int STAGES>
__device__ __forceinline__ void stream_tile(const bf16* __restrict__ a, const bf16* __restrict__ w0,
                                            const bf16* __restrict__ w1, bf16* __restrict__ out,
                                            int e, int n0, int C, int K, int N) {
  using Cfg = StreamCfg<NMAT, NB, NTT, STAGES>;
  constexpr int CP = Cfg::CP, MT = NB / 16, CH = NB / 8;
  extern __shared__ __align__(128) unsigned char st_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* ae = a + (long long)e * C * K;

  const long long wexp = (long long)e * K * N;
  const uint32_t ring = smem_u32(st_smem) + warp * STAGES * Cfg::STAGE;
  const int ks_total = (K + 15) / 16;
  const int s_begin = warp * ks_total / NWARP, s_end = (warp + 1) * ks_total / NWARP;

  auto load = [&](int slot, int s) {
    const uint32_t st = ring + slot * Cfg::STAGE;
    const int k0 = 16 * s;
#pragma unroll
    for (int it = 0; it < NMAT * 16 * CH / 32; ++it) {
      const int q = lane + 32 * it;
      const int m = q / (16 * CH), r = (q / CH) % 16, j = q % CH;
      const int k = k0 + r, n = n0 + 8 * j;
      const bool ok = k < K && n < N;
      const bf16* src = (m == 0 ? w0 : w1) + wexp + (ok ? (long long)k * N + n : 0);
      cp_async16(st + m * Cfg::W_BYTES + r * NB * 2 + ((j ^ (r & 7)) << 4), src, ok);
    }
#pragma unroll
    for (int q = lane; q < CP * 2; q += 32) {
      const int c = q >> 1, k = k0 + 8 * (q & 1);
      const bool ok = c < C && k < K;
      cp_async16(st + NMAT * Cfg::W_BYTES + c * ST_XLD + ((q & 1) << 4),
                 ae + (ok ? (long long)c * K + k : 0), ok);
    }
  };

  float acc[NMAT][MT][NTT][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int tt = 0; tt < NTT; ++tt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][i][tt][j] = 0.f;

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (s_begin + p < s_end) load(p, s_begin + p);
    cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row: matrix lane / 8 of the four (n 0-7 | 8-15) x (k 0-7 | 8-15)
  const int lm_row = (lane & 7) + 8 * (lane >> 4), lm_chunk = (lane >> 3) & 1;
  for (int s = s_begin; s < s_end; ++s) {
    const int i_s = s - s_begin;
    if (s + STAGES - 1 < s_end) load((i_s + STAGES - 1) % STAGES, s + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const uint32_t st = ring + (i_s % STAGES) * Cfg::STAGE;
    uint32_t b[NTT][2];
#pragma unroll
    for (int tt = 0; tt < NTT; ++tt) {
      const uint32_t xa = st + NMAT * Cfg::W_BYTES + (8 * tt + g) * ST_XLD + 4 * t;
      b[tt][0] = lds32(xa);
      b[tt][1] = lds32(xa + 16);
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t fa[4];
        const int ch = 2 * i + lm_chunk;
        ldsm_x4_trans(fa, st + m * Cfg::W_BYTES + lm_row * NB * 2 + ((ch ^ (lm_row & 7)) << 4));
#pragma unroll
        for (int tt = 0; tt < NTT; ++tt) mma_bf16(acc[m][i][tt], fa, b[tt][0], b[tt][1]);
      }
    __syncwarp();  // every lane is done with this slot before it is refilled
  }
  cp_async_wait<0>();

  // the 8 warps' partial sums meet in shared memory: red[w][m][c][n]
  __syncthreads();
  float* red = reinterpret_cast<float*>(st_smem);
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int tt = 0; tt < NTT; ++tt) {
        float* r0 = red + ((warp * NMAT + m) * CP + 8 * tt + 2 * t) * Cfg::RED_LD + 16 * i + g;
        r0[0] = acc[m][i][tt][0];
        r0[Cfg::RED_LD] = acc[m][i][tt][1];
        r0[8] = acc[m][i][tt][2];
        r0[Cfg::RED_LD + 8] = acc[m][i][tt][3];
      }
  __syncthreads();
  for (int i = tid; i < C * NB; i += NT) {
    const int c = i / NB, n = i % NB;
    if (n0 + n >= N) continue;
    float sm[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) v += red[((w * NMAT + m) * CP + c) * Cfg::RED_LD + n];
      sm[m] = v;
    }
    const float o = NMAT == 2 ? silu_mul(sm[0], sm[NMAT - 1]) : sm[0];
    out[((long long)e * C + c) * N + n0 + n] = __float2bfloat16(o);
  }
}

// Over the occupied experts e (occ, from moe_occupancy_kernel) and column tiles
// [n0, n0 + NB), with a (E, C, K) and w_m (E, K, N):
//   s_m[c][n] = sum_k a[e, c, k] * w_m[e, k, n]   (fp32 sums of bf16 products)
// NMAT = 2 (up: a = x, w = wg, wu) writes silu(s_0) * s_1; NMAT = 1 (down: a = h, w = wo)
// writes s_0; both as bf16 to out (E, C, N).  C <= 8 NTT.  An empty expert is neither read
// nor written here.
//
// Persistent: the grid is one wave, and block b takes the (expert, column tile) items b,
// b + gridDim.x, ... of the occupied experts, column tiles fastest; no block is launched for
// an empty expert.  Warp w takes 16-deep k-slices [KS w / 8, KS (w + 1) / 8) of the
// KS = ceil(K / 16).  A slice of w_m (16 rows x NB columns) lands in the warp's ring as 16
// rows of NB * 2 bytes, 16-byte chunk j of row r at chunk j ^ (r & 7), so the 8 row addresses
// of an ldmatrix fall in distinct banks; the slice of a (C rows x 16) beside it, ST_XLD bytes
// a row.  Rows past K or C and columns past N are zero-filled by cp.async.  Fragments are
// those of mma.m16n8k16 with A = w_m^T (rows n, ldmatrix.trans of the k-major slice) and
// B = a^T (columns = token rows): a thread (g = lane / 4, t = lane % 4) holds sums for
// columns n0 + 16 i + g (+ 8) and token rows 8 tt + 2 t (+ 1).  The warps' partial sums meet
// in shared memory.
template <int NMAT, int NB, int NTT, int STAGES>
__device__ __forceinline__ void stream_pass(const bf16* __restrict__ a, const bf16* __restrict__ w0,
                                            const bf16* __restrict__ w1, bf16* __restrict__ out,
                                            const int* __restrict__ occ, int E, int C, int K,
                                            int N) {
  const int col_tiles = (N + NB - 1) / NB;
  const int items = count_occupied(occ, E) * col_tiles;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = (item % col_tiles) * NB;
    const int e = occupied_expert(occ, E, item / col_tiles);
    stream_tile<NMAT, NB, NTT, STAGES>(a, w0, w1, out, e, n0, C, K, N);
    __syncthreads();   // the next item's ring overwrites this one's partial sums
  }
}

// output columns per item and ring depth: the up pass streams two matrices, 8 KB a slice
constexpr int ST_UP_NB = 128, ST_UP_STAGES = 2, ST_DOWN_NB = 128, ST_DOWN_STAGES = 3;
constexpr int ST_MAX_C = 16;        // the largest C the stream takes (2 token tiles)

template <int NTT>
__global__ void __launch_bounds__(NT, 1)
moe_up_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                     const bf16* __restrict__ wu, bf16* __restrict__ h,
                     const int* __restrict__ occ, int E, int C, int d, int f) {
  wait_previous_grid();
  allow_next_grid();
  stream_pass<2, ST_UP_NB, NTT, ST_UP_STAGES>(x, wg, wu, h, occ, E, C, d, f);
}

template <int NTT>
__global__ void __launch_bounds__(NT, 2)
moe_down_stream_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wo,
                       bf16* __restrict__ out, const int* __restrict__ occ, int E, int C, int d,
                       int f) {
  wait_previous_grid();
  stream_pass<1, ST_DOWN_NB, NTT, ST_DOWN_STAGES>(h, wo, nullptr, out, occ, E, C, f, d);
}

// One wave of `kernel` (as many blocks as fit on the card at once), at most `items` blocks.
template <typename Kernel>
int one_wave(Kernel kernel, int smem, int items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  *grid = max(1, min(items, sms * per_sm));
  return (int)rc;
}

template <int NTT>
int launch_stream_t(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wo, bf16* h,
                    bf16* out, int* occ, int e, int c, int d, int f, cudaStream_t stream) {
  constexpr int up_smem = StreamCfg<2, ST_UP_NB, NTT, ST_UP_STAGES>::SMEM;
  constexpr int down_smem = StreamCfg<1, ST_DOWN_NB, NTT, ST_DOWN_STAGES>::SMEM;
  int rc = (int)cudaFuncSetAttribute(moe_up_stream_kernel<NTT>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, up_smem);
  if (!rc) rc = (int)cudaFuncSetAttribute(moe_down_stream_kernel<NTT>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, down_smem);
  int up_grid = 1, down_grid = 1;
  if (!rc) rc = one_wave(moe_up_stream_kernel<NTT>, up_smem,
                         e * ((f + ST_UP_NB - 1) / ST_UP_NB), &up_grid);
  if (!rc) rc = one_wave(moe_down_stream_kernel<NTT>, down_smem,
                         e * ((d + ST_DOWN_NB - 1) / ST_DOWN_NB), &down_grid);
  if (rc) return rc;
  moe_occupancy_kernel<<<e, NT, 0, stream>>>(x, occ, out, c * d);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = launch_after(moe_up_stream_kernel<NTT>, up_grid, NT, up_smem, stream, x, wg, wu, h,
                    static_cast<const int*>(occ), e, c, d, f);
  if (rc) return rc;
  return launch_after(moe_down_stream_kernel<NTT>, down_grid, NT, down_smem, stream,
                      static_cast<const bf16*>(h), wo, out, static_cast<const int*>(occ), e, c,
                      d, f);
}

int launch_stream(const void* x, const void* wg, const void* wu, const void* wo, void* h,
                  void* out, int* occ, int e, int c, int d, int f, cudaStream_t stream) {
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(wg);
  const auto* ub = static_cast<const bf16*>(wu);
  const auto* ob = static_cast<const bf16*>(wo);
  auto* hb = static_cast<bf16*>(h);
  auto* outb = static_cast<bf16*>(out);
  if (c <= 8) return launch_stream_t<1>(xb, gb, ub, ob, hb, outb, occ, e, c, d, f, stream);
  if (c <= ST_MAX_C) return launch_stream_t<2>(xb, gb, ub, ob, hb, outb, occ, e, c, d, f, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------------------
// bfloat16, large C: a TMA + wgmma grouped GEMM
// ---------------------------------------------------------------------------------------

constexpr int TC_BM = 128;          // token rows per block: 2 consumer warpgroups x 64
constexpr int TC_BK = 64;           // reduction depth of a stage: one 128-byte swizzle row
constexpr int TC_STAGES = 4;
constexpr int TC_NT = 384;          // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TC_UP_BN = 128, TC_DOWN_BN = 256;   // output columns per block

template <int NMAT, int BN>
struct TcCfg {
  static constexpr int A_BYTES = TC_BM * TC_BK * 2;       // 16 KB
  static constexpr int BOX_BYTES = TC_BK * 64 * 2;        // one 64 x 64 weight box, 8 KB
  static constexpr int B_BYTES = (BN / 64) * BOX_BYTES;   // one matrix's 64 x BN tile
  static constexpr int STAGE = A_BYTES + NMAT * B_BYTES;  // 48 KB
  // the ring, its 2 x TC_STAGES mbarriers, and room to align the ring to 1024 bytes
  static constexpr int SMEM = TC_STAGES * STAGE + 2 * TC_STAGES * 8 + 1024;
};

// For the block's expert e, token rows [m0, m0 + 128) and columns [n0, n0 + BN), with the
// maps ta over a (E, C, K) and tb_m over w_m (E, K, N):
//   s_m[c][n] = sum_k a[e, c, k] * w_m[e, k, n]   (fp32 accumulators of bf16 products)
// NMAT = 2 (up) writes silu(s_0) * s_1, NMAT = 1 (down) s_0, as bf16 to out (E, C, N).
//
// Shared memory: TC_STAGES stages of [a: 128 rows x 128 B][w_0: BN / 64 boxes of 64 rows x
// 128 B][w_1 ...], each box as TMA writes it with the 128-byte swizzle (16-byte chunk j of
// row r at j ^ (r & 7)), the ring aligned to 1024 bytes, then full[] and empty[] barriers.
// The a tile is K-major: a wgmma's 64 x 16 slice starts 64 * 128 B per warpgroup and 32 B per
// k-step in, 8-row groups 1024 B apart (SBO).  A weight tile is MN-major (transpose bit): a
// k-step starts 16 * 128 B in, 8-row groups 1024 B apart (SBO), 64-column boxes 8 KB apart
// (LBO).  The accumulator layout is wgmma's: thread (warp w of its warpgroup, g = lane / 4,
// t = lane % 4) holds rows 16 w + g (+ 8) of its 64 and columns 8 j + 2 t (+ 1), j < BN / 8.
template <int NMAT, int BN>
__device__ __forceinline__ void tc_pass(const CUtensorMap* ta, const CUtensorMap* tb0,
                                        const CUtensorMap* tb1, bf16* __restrict__ out, int E,
                                        int C, int K, int N) {
  using Cfg = TcCfg<NMAT, BN>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t ring = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t bars = ring + TC_STAGES * Cfg::STAGE;   // full[s] at 8 s, empty[s] after
  const int m_tiles = (C + TC_BM - 1) / TC_BM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles * E;
  const int kt_n = (K + TC_BK - 1) / TC_BK;
  const int wgrp = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                        // the producer's expect_tx
      mbar_init(bars + 8 * (TC_STAGES + s), 2);          // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, + gridDim.x, ...: the token-row tile fastest, then the
  // column tile, then the expert.  `it` counts k-stages over all of the block's tiles, so the
  // ring runs on across tiles and the producer fills the next tile's stages during the
  // consumers' epilogue.
  if (wgrp == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * TC_BM, n0 = (tile / m_tiles % n_tiles) * BN;
        const int e = tile / (m_tiles * n_tiles);
        for (int kt = 0; kt < kt_n; ++kt, ++it) {
          const int s = it % TC_STAGES;
          if (it >= TC_STAGES) mbar_wait(bars + 8 * (TC_STAGES + s), ((it / TC_STAGES) - 1) & 1);
          const uint32_t full = bars + 8 * s, st = ring + s * Cfg::STAGE;
          mbar_expect_tx(full, Cfg::STAGE);
          tma_load_3d(st, ta, kt * TC_BK, m0, e, full);
#pragma unroll
          for (int m = 0; m < NMAT; ++m)
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(st + Cfg::A_BYTES + m * Cfg::B_BYTES + j * Cfg::BOX_BYTES,
                          m == 0 ? tb0 : tb1, n0 + 64 * j, kt * TC_BK, e, full);
        }
      }
    }
  } else {
    // consumers: warpgroup wgrp multiplies rows [64 wgrp, 64 wgrp + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) & 3;
    const bool releaser = threadIdx.x % 128 == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * TC_BM, n0 = (tile / m_tiles % n_tiles) * BN;
      const int e = tile / (m_tiles * n_tiles);
      float acc[NMAT][BN / 2];
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
      for (int kt = 0; kt < kt_n; ++kt, ++it) {
        const int s = it % TC_STAGES;
        mbar_wait(bars + 8 * s, (it / TC_STAGES) & 1);
        const uint32_t st = ring + s * Cfg::STAGE;
#pragma unroll
        for (int m = 0; m < NMAT; ++m) fence_acc(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < TC_BK / 16; ++ks) {
          const uint64_t da = gmma_desc(st + wgrp * 64 * 128 + ks * 32, 16, 1024);
#pragma unroll
          for (int m = 0; m < NMAT; ++m)
            wgmma_ss<BN, 1>(acc[m], da,
                            gmma_desc(st + Cfg::A_BYTES + m * Cfg::B_BYTES + ks * 16 * 128,
                                      Cfg::BOX_BYTES, 1024),
                            1);
        }
        wgmma_commit();
#pragma unroll
        for (int m = 0; m < NMAT; ++m) fence_acc(acc[m]);
        wgmma_wait<1>();   // the previous stage's products are done: release it
        if (kt > 0 && releaser) mbar_arrive(bars + 8 * (TC_STAGES + (it - 1) % TC_STAGES));
      }
      wgmma_wait<0>();
      if (releaser) mbar_arrive(bars + 8 * (TC_STAGES + (it - 1) % TC_STAGES));
#pragma unroll
      for (int m = 0; m < NMAT; ++m) fence_acc(acc[m]);

      const int row = m0 + 64 * wgrp + 16 * w + (lane >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= N) continue;   // N is a multiple of 8: col + 1 < N too
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row + 8 * half;
          if (r >= C) continue;
          const int i = 4 * j + 2 * half;
          float v0 = acc[0][i], v1 = acc[0][i + 1];
          if constexpr (NMAT == 2) {
            v0 = silu_mul(v0, acc[NMAT - 1][i]);
            v1 = silu_mul(v1, acc[NMAT - 1][i + 1]);
          }
          *reinterpret_cast<uint32_t*>(out + ((long long)e * C + r) * N + col) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(TC_NT, 1)
moe_up_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tu, bf16* __restrict__ h, int E, int C,
                    int d, int f) {
  allow_next_grid();
  tc_pass<2, TC_UP_BN>(&tx, &tg, &tu, h, E, C, d, f);
}

__global__ void __launch_bounds__(TC_NT, 1)
moe_down_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                      const __grid_constant__ CUtensorMap to, bf16* __restrict__ out, int E,
                      int C, int d, int f) {
  wait_previous_grid();
  tc_pass<1, TC_DOWN_BN>(&th, &to, &to, out, E, C, f, d);
}

// A 3-D map over a contiguous bf16 tensor (E, rows, cols): boxes of 64 columns (128 bytes,
// the swizzle's width) x box_rows rows of one expert, zero fill past every edge.
int encode_3d(CUtensorMap* map, const void* p, int e, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)e};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
                         strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_wgmma(const void* x, const void* wg, const void* wu, const void* wo, void* h,
                 void* out, int e, int c, int d, int f, cudaStream_t stream) {
  using Up = TcCfg<2, TC_UP_BN>;
  using Down = TcCfg<1, TC_DOWN_BN>;
  CUtensorMap tx, tg, tu, th, to;
  int rc = encode_3d(&tx, x, e, c, d, TC_BM);
  if (!rc) rc = encode_3d(&tg, wg, e, d, f, TC_BK);
  if (!rc) rc = encode_3d(&tu, wu, e, d, f, TC_BK);
  if (!rc) rc = encode_3d(&th, h, e, c, f, TC_BM);
  if (!rc) rc = encode_3d(&to, wo, e, f, d, TC_BK);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(moe_up_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Up::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(moe_down_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Down::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // persistent: at most one block per SM, each walking its tiles
  const int m_tiles = (c + TC_BM - 1) / TC_BM;
  const int up_tiles = m_tiles * ((f + TC_UP_BN - 1) / TC_UP_BN) * e;
  const int down_tiles = m_tiles * ((d + TC_DOWN_BN - 1) / TC_DOWN_BN) * e;
  moe_up_wgmma_kernel<<<min(up_tiles, sms), TC_NT, Up::SMEM, stream>>>(
      tx, tg, tu, static_cast<bf16*>(h), e, c, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_after(moe_down_wgmma_kernel, min(down_tiles, sms), TC_NT, Down::SMEM, stream, th,
                      to, static_cast<bf16*>(out), e, c, d, f);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; route: 0 = fp32 FMA (float32), 1 = weight stream
// (bfloat16, C <= 16), 2 = TMA + wgmma (bfloat16).  h is a workspace of E * C * f elements of
// x's type, occ one of E ints (the stream's).  Returns 0, or the first CUDA error of the
// launches.
extern "C" int moe_expert_ffn_launch(const void* x, const void* wg, const void* wu,
                                     const void* wo, void* h, void* out, void* occ, int dtype,
                                     int route, int e, int c, int d, int f, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || c < 1 || d < 8 || f < 8 || d % 8 || f % 8 || e > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && route == 0) return launch_fma(x, wg, wu, wo, h, out, e, c, d, f, st);
  if (dtype == 1 && route == 1)
    return launch_stream(x, wg, wu, wo, h, out, static_cast<int*>(occ), e, c, d, f, st);
  if (dtype == 1 && route == 2) return launch_wgmma(x, wg, wu, wo, h, out, e, c, d, f, st);
  return (int)cudaErrorInvalidValue;
}
