// Grouped expert SwiGLU FFN for Hopper (sm_90a): out[e] = (silu(x[e] wg[e]) * (x[e] wu[e])) wo[e].
//
// Replaces the TPU kernel repro/kernels/moe_gemm/kernel.py::moe_expert_ffn_fwd (_moe_kernel).
// Computes exactly repro_torch/kernels/moe_gemm/ref.py::moe_expert_ffn_ref: x (E, C, d) the
// experts' capacity buffers, wg and wu (E, d, f), wo (E, f, d), all contiguous and of one type
// (float or bfloat16); h = silu(x wg) * (x wu) in fp32, out = h wo summed in fp32 and cast once
// to x's type.  Any C >= 1; d and f multiples of 8.
//
// Bound: memory.  A call must read the expert weights, 3 * E * d * f elements, and x, and write
// out: (3 E d f + 2 E C d) * sizeof(T) bytes.  It does 6 E C d f flops, i.e. 2 C flops per
// weight, C per weight byte in bf16 (8 at the decode capacity C = 8), far below the ~295
// flop/byte at which the H100 stops being memory-bound.  The least time is those bytes over 3.35 TB/s
// (331.8 us for deepseek-moe-16b's decode call, E = 64, C = 8, d = 2048, f = 1408, bf16).
//
// Design, for that bound: read every weight byte once per c-tile (once per call at C <= 8),
// with enough loads in flight to fill the card, and keep the products on CUDA cores in fp32.
//   * Why not the TPU grid.  The TPU grid is (E, C / block_c, f / block_f) with the f axis
//     sequential and a (block_c, d) fp32 accumulator in VMEM.  At decode that is 64 blocks on
//     132 SMs, each walking 11 f-tiles in turn: too few blocks for the card.
//   * Two passes instead, each a grid over (column tiles, c-tiles, E) with 64 output columns
//     and 8 token rows per block: pass 1 (moe_up_kernel) computes h = silu(x wg) * (x wu)
//     into an fp32 workspace (E, C, f) (2.9 MB at decode); pass 2 (moe_down_kernel) computes
//     h wo.  At decode that is 64 * 22 = 1408 and 64 * 32 = 2048 blocks.
//   * A block stages its (8 x K) slice of the left operand (x or h) in shared memory in fp32,
//     transposed so a thread reads the 8 token values of one row k with two 16-byte loads, in
//     chunks of up to 2048 rows (64 KB).
//   * 16 threads span a 64-column strip of a weight row, 4 columns each (one 8-byte load in
//     bf16, 16 bytes in fp32), so a half-warp reads 128 contiguous bytes; the block's 16 such
//     row groups split the reduction axis, and each thread keeps 8 x 4 fp32 sums per weight
//     matrix in registers.  The row groups are summed by a shuffle and through shared memory.
//   * fp32 FMA on CUDA cores: 8 flops per bf16 weight byte at the memory rate need
//     26.8 TFLOP/s, 40% of the 67 TFLOP/s fp32 peak.  Tensor cores, TMA and a fused single pass
//     are left for later work.
// The wrapper (ops.py) checks shapes, types, contiguity and alignment before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int NWARP = NT / 32;
constexpr int CT = 8;               // token rows per block (one c-tile)
constexpr int VEC = 4;              // output columns per thread
constexpr int COLS = 64;            // output columns per block
constexpr int TPR = COLS / VEC;     // threads across one weight row (16, half a warp)
constexpr int RG = NT / TPR;        // row groups splitting the reduction axis (16)
constexpr int KCH = 2048;           // reduction rows staged in shared memory at a time

static_assert(TPR == 16, "the shuffle below pairs the two half-warps of a warp");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive weights as fp32: one 16-byte load (float) or one 8-byte load (bfloat16)
__device__ __forceinline__ void load4(const float* p, float (&w)[VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&w)[VEC]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

template <int NMAT>
constexpr size_t smem_bytes(int k) {
  const int stage = (k < KCH ? k : KCH) * CT;
  const int red = NWARP * NMAT * CT * COLS;
  return (size_t)(stage > red ? stage : red) * sizeof(float);
}

// For the block's expert e, token rows [c0, c0 + CT) and columns [n0, n0 + COLS):
//   s_m[c][n] = sum_k a[e, c, k] * w_m[e, k, n]   (k over [0, K), fp32)
// with a (E, C, K) of type A and w_m (E, K, N) of type T.  NMAT = 2 (pass 1: a = x,
// w = wg, wu) writes h = silu(s_0) * s_1 to hout (E, C, N) fp32; NMAT = 1 (pass 2: a = h,
// w = wo) writes s_0 cast to T to out (E, C, N).
template <typename T, typename A, int NMAT>
__device__ __forceinline__ void expert_pass(const A* __restrict__ a, const T* __restrict__ w0,
                                            const T* __restrict__ w1, float* __restrict__ hout,
                                            T* __restrict__ out, int C, int K, int N) {
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
  const T* wp[NMAT];
  wp[0] = w0 + wexp + col;
  if constexpr (NMAT == 2) wp[1] = w1 + wexp + col;
  const A* ae = a + ((long long)e * C + c0) * K;
  const float4* s4 = reinterpret_cast<const float4*>(smem);

  for (int k0 = 0; k0 < K; k0 += KCH) {
    const int kn = min(KCH, K - k0);
    __syncthreads();  // readers of the previous chunk are done
    // stage a[c0 : c0 + CT, k0 : k0 + kn] as smem[k][c]; rows at or past C are zero
    for (int i = tid; i < CT * kn; i += NT) {
      const int c = i / kn, k = i - c * kn;
      smem[k * CT + c] = (c0 + c < C) ? to_f(ae[(long long)c * K + k0 + k]) : 0.f;
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
          float w[VEC];
          load4(wp[m] + row, w);
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[m][c][j] = fmaf(xv[c], w[j], acc[m][c][j]);
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
    if constexpr (NMAT == 2) {
      const float g = s[0];
      hout[o] = g / (1.f + expf(-g)) * s[1];  // silu(gate) * up
    } else {
      out[o] = from_f<T>(s[0]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
moe_up_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
              float* __restrict__ h, int C, int d, int f) {
  expert_pass<T, T, 2>(x, wg, wu, h, nullptr, C, d, f);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
moe_down_kernel(const float* __restrict__ h, const T* __restrict__ wo, T* __restrict__ out,
                int C, int d, int f) {
  expert_pass<T, float, 1>(h, wo, nullptr, nullptr, out, C, f, d);
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wo, void* h, void* out,
           int e, int c, int d, int f, cudaStream_t stream) {
  const size_t up_smem = smem_bytes<2>(d), down_smem = smem_bytes<1>(f);
  cudaError_t rc = cudaFuncSetAttribute(moe_up_kernel<T>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)up_smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(moe_down_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)down_smem);
  if (rc != cudaSuccess) return (int)rc;
  const int c_tiles = (c + CT - 1) / CT;
  moe_up_kernel<T><<<dim3((f + COLS - 1) / COLS, c_tiles, e), NT, up_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<float*>(h), c, d, f);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  moe_down_kernel<T><<<dim3((d + COLS - 1) / COLS, c_tiles, e), NT, down_smem, stream>>>(
      static_cast<const float*>(h), static_cast<const T*>(wo), static_cast<T*>(out), c, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  h is an fp32 workspace of E * C * f elements.
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int moe_expert_ffn_launch(const void* x, const void* wg, const void* wu,
                                     const void* wo, void* h, void* out, int dtype, int e,
                                     int c, int d, int f, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || c < 1 || d < 8 || f < 8 || d % 8 || f % 8 || c > 65535 * CT || e > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, wg, wu, wo, h, out, e, c, d, f, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wg, wu, wo, h, out, e, c, d, f, st);
  return (int)cudaErrorInvalidValue;
}
