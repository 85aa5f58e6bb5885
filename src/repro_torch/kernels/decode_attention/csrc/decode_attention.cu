// Single-token GQA decode attention for Hopper (sm_90a), split over the kv axis.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::decode_attention_fwd
// (_dec_kernel).  Computes exactly repro_torch/kernels/decode_attention/ref.py::
// decode_attention_ref, in the model's own layout: q (B, 1, H, D) contiguous, k and v the
// KV cache (B, T, K, D) read through its strides (no transposed copy of the cache), pos (B,)
// int32 on the device, out (B, 1, H, D) in q's type.  H = K * G; keys at index > pos[b]
// are masked, and never read.
//
// Bound: memory.  A call must read sum_b (pos_b + 1) * K * D * 2 * sizeof(T) bytes of cache
// (plus q and out), and does about 4 * G flops per cache element it reads (G = 2 for
// gemma3-4b), far below the ~295 flop/byte at which the H100 stops being memory-bound.  The
// least time is those bytes over 3.35 TB/s.
//
// Design, for that bound:
//   * Flash-decoding split.  The TPU kernel walks one (batch, kv head) row's kv blocks in
//     sequence; at decode shapes that is B * K = 8 rows, too few for 132 SMs.  Here grid
//     (n_split, K, B) gives each block a contiguous run of keys_per_split keys of one row;
//     each block keeps (m, l, acc[G][D]) of an online softmax in fp32 registers and writes
//     them as a partial.  A second small kernel merges the partials of a row, one thread
//     per output element, the weights of the splits computed once per block.
//   * Work follows pos, like @pl.when(k_start <= pos): a block whose keys all lie past
//     pos[b] writes an empty partial (m = -1e30, l = 0) without touching the cache, and rows
//     past pos inside a tile are neither loaded nor counted.
//   * K/V tiles are staged in shared memory with 16-byte loads (one row of D elements is
//     D * sizeof(T) bytes, a whole number of 16-byte chunks), K and V tiles together <= 32 KB.
//   * q . k on CUDA cores in fp32: one warp per key row, lanes split D, shuffle reduction
//     per query head; then tanh softcap, online softmax, and p . v with each thread owning
//     D / 128 output dims.  At G = 2 the tensor cores would idle on a 64-row wgmma tile.
//   * Divides by max(l, 1e-30) (kernel.py:66) and scales scores by 1/sqrt(D).
// Supports D in {16, 32, 64, 128, 256}, G <= 8, T = float or bfloat16.  The wrapper
// (ops.py) checks shapes, types, strides and alignment before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXG = 8;          // query heads per kv head
constexpr int MAX_SPLIT = 256;   // splits of one row's keys
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
struct Tile {
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  // keys per shared-memory tile (16 or 32, so it divides keys_per_split, a multiple of 32)
  static constexpr int KEYS = (16384 / ROW_BYTES) < 32 ? (16384 / ROW_BYTES) : 32;
  static constexpr int CHUNKS = ROW_BYTES / 16;   // 16-byte loads per row
  static constexpr int DPL = (D + 31) / 32;       // dims per lane in q . k
  static constexpr int DPT = (D + NT - 1) / NT;   // dims per thread in p . v
  static_assert(ROW_BYTES % 16 == 0, "a row must be a whole number of 16-byte chunks");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int t_len, int h, int kv_heads, int g_n,
                    long long k_sb, long long k_st, long long k_sh, long long v_sb,
                    long long v_st, long long v_sh, int keys_per_split, float scale,
                    float softcap) {
  using TL = Tile<T, D>;
  constexpr int KEYS = TL::KEYS;
  __shared__ __align__(16) T ks[KEYS * D];
  __shared__ __align__(16) T vs[KEYS * D];
  __shared__ float s_sm[MAXG * KEYS];   // scores of the tile
  __shared__ float p_sm[MAXG * KEYS];   // exp(score - running max), 0 where masked

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this block's keys: [t_begin, t_end), never past pos[b]
  const int last = min(pos[b], t_len - 1);
  const int t_begin = split * keys_per_split;
  const int t_end = min(t_begin + keys_per_split, last + 1);

  // the G query rows of this kv head in fp32 registers; lane holds dims lane + 32 j
  float qr[MAXG][TL::DPL];
  const T* qb = q + ((long long)b * h + (long long)kh * g_n) * D;
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < TL::DPL; ++j) {
      const int d = lane + 32 * j;
      qr[g][j] = (g < g_n && d < D) ? to_f(qb[g * D + d]) : 0.f;
    }

  float m[MAXG], l[MAXG], acc[MAXG][TL::DPT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < TL::DPT; ++j) acc[g][j] = 0.f;
  }

  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  for (int t0 = t_begin; t0 < t_end; t0 += KEYS) {
    __syncthreads();  // readers of the previous tile are done
    // stage rows [t0, t0 + KEYS); rows at or past t_end are zero, never loaded
    for (int c = tid; c < KEYS * TL::CHUNKS; c += NT) {
      const int r = c / TL::CHUNKS, cc = c % TL::CHUNKS;
      const int t = t0 + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (t < t_end) {
        kx = reinterpret_cast<const uint4*>(kb + t * k_st)[cc];
        vx = reinterpret_cast<const uint4*>(vb + t * v_st)[cc];
      }
      reinterpret_cast<uint4*>(ks)[c] = kx;
      reinterpret_cast<uint4*>(vs)[c] = vx;
    }
    __syncthreads();

    // scores: one warp per key row, lanes split D, shuffle reduction per query head
    for (int r = warp; r < KEYS; r += NWARP) {
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
#pragma unroll
      for (int j = 0; j < TL::DPL; ++j) {
        const int d = lane + 32 * j;
        const float kf = d < D ? to_f(ks[r * D + d]) : 0.f;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) part[g] += qr[g][j] * kf;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < g_n) {
          float s = part[g];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) {
            s *= scale;
            if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
            s_sm[g * KEYS + r] = (t0 + r < t_end) ? s : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: every thread derives the same running max and rescale
    float alpha[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float mx = m[g];
      if (g < g_n)
        for (int r = 0; r < KEYS; ++r) mx = fmaxf(mx, s_sm[g * KEYS + r]);
      alpha[g] = expf(m[g] - mx);
      m[g] = mx;
      if (g < g_n && tid < KEYS)
        p_sm[g * KEYS + tid] = (t0 + tid < t_end) ? expf(s_sm[g * KEYS + tid] - mx) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < g_n) {
        float ps = 0.f;
        for (int r = 0; r < KEYS; ++r) ps += p_sm[g * KEYS + r];
        l[g] = alpha[g] * l[g] + ps;
#pragma unroll
        for (int j = 0; j < TL::DPT; ++j) {
          const int d = tid + NT * j;
          if (d < D) {
            float a = acc[g][j] * alpha[g];
            for (int r = 0; r < KEYS; ++r) a += p_sm[g * KEYS + r] * to_f(vs[r * D + d]);
            acc[g][j] = a;
          }
        }
      }
    }
  }

  // partial of this split: (m, l) per head and the unnormalised acc
  const long long slot = ((long long)(b * kv_heads + kh) * n_split + split) * g_n;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < g_n) {
      if (tid == 0) {
        part_ml[(slot + g) * 2] = m[g];
        part_ml[(slot + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int j = 0; j < TL::DPT; ++j) {
        const int d = tid + NT * j;
        if (d < D) part_acc[(slot + g) * D + d] = acc[g][j];
      }
    }
  }
}

// Merge the n_split partials of one (batch, kv head) row into the output.  Grid
// (ceil(G * D / NT), K, B): each block first weighs the splits of every head
// (one warp per head: max over splits, exp(m_s - M), the normaliser L) into shared
// memory, then each thread sums one output element over the splits, with the loads of
// all splits independent of one another.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      T* __restrict__ out, int h, int kv_heads, int g_n, int n_split) {
  __shared__ float w_sm[MAX_SPLIT * MAXG];   // exp(m_s - M) per (split, head)
  __shared__ float l_sm[MAXG];               // sum_s exp(m_s - M) * l_s per head
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)(b * kv_heads + kh) * n_split;
  for (int g = warp; g < g_n; g += NWARP) {
    float mx = NEG_INF;
    for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, part_ml[((base + s) * g_n + g) * 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float lsum = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const long long i = ((base + s) * g_n + g) * 2;
      const float w = expf(part_ml[i] - mx);
      w_sm[s * MAXG + g] = w;
      lsum += w * part_ml[i + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (lane == 0) l_sm[g] = lsum;
  }
  __syncthreads();
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < g_n * D) {
    const int g = e / D, d = e % D;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      a += w_sm[s * MAXG + g] * part_acc[((base + s) * g_n + g) * D + d];
    out[((long long)b * h + (long long)kh * g_n + g) * D + d] = from_f<T>(a / fmaxf(l_sm[g], 1e-30f));
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* pos, void* out,
            void* part_acc, void* part_ml, int b, int t_len, int h, int kv_heads,
            long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
            long long v_sh, int n_split, int keys_per_split, float scale, float softcap,
            cudaStream_t stream) {
  const int g_n = h / kv_heads;
  decode_split_kernel<T, D><<<dim3(n_split, kv_heads, b), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), t_len, h, kv_heads, g_n, k_sb, k_st, k_sh, v_sb, v_st,
      v_sh, keys_per_split, scale, softcap);
  decode_combine_kernel<T, D><<<dim3((g_n * D + NT - 1) / NT, kv_heads, b), NT, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<T*>(out), h, kv_heads, g_n, n_split);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, const void* pos,
               void* out, void* part_acc, void* part_ml, int b, int t_len, int h,
               int kv_heads, long long k_sb, long long k_st, long long k_sh, long long v_sb,
               long long v_st, long long v_sh, int n_split, int keys_per_split, float scale,
               float softcap, cudaStream_t stream) {
#define DECODE_ATTENTION_CASE(DD)                                                          \
  case DD:                                                                                 \
    launch<T, DD>(q, k, v, pos, out, part_acc, part_ml, b, t_len, h, kv_heads, k_sb, k_st, \
                  k_sh, v_sb, v_st, v_sh, n_split, keys_per_split, scale, softcap, stream); \
    return 0;
  switch (d) {
    DECODE_ATTENTION_CASE(16)
    DECODE_ATTENTION_CASE(32)
    DECODE_ATTENTION_CASE(64)
    DECODE_ATTENTION_CASE(128)
    DECODE_ATTENTION_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_ATTENTION_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means none.  Strides are in elements.
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* part_acc,
                                       void* part_ml, int dtype, int b, int t_len, int h,
                                       int kv_heads, int d, long long k_sb, long long k_st,
                                       long long k_sh, long long v_sb, long long v_st,
                                       long long v_sh, int n_split, int keys_per_split,
                                       float scale, float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > MAX_SPLIT || h % kv_heads || h / kv_heads > MAXG ||
      keys_per_split % 32)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0)
    rc = dispatch_d<float>(d, q, k, v, pos, out, part_acc, part_ml, b, t_len, h, kv_heads,
                           k_sb, k_st, k_sh, v_sb, v_st, v_sh, n_split, keys_per_split, scale,
                           softcap, st);
  else if (dtype == 1)
    rc = dispatch_d<__nv_bfloat16>(d, q, k, v, pos, out, part_acc, part_ml, b, t_len, h,
                                   kv_heads, k_sb, k_st, k_sh, v_sb, v_st, v_sh, n_split,
                                   keys_per_split, scale, softcap, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
