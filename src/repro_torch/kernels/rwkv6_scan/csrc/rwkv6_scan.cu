// RWKV6 wkv recurrence for Hopper (sm_90a), in chunks of 16 tokens, the state kept on chip.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan_fwd (_rwkv_kernel).
// Computes repro_torch/kernels/rwkv6_scan/ref.py::rwkv6_scan_ref: r, k, v (B, T, H, D) in float
// or bfloat16 and logw (B, T, H, D) in float, each read in place through its strides (unit
// stride over D); u (H, D) float; an optional input state s0 (B, H, D, D) float.  Per head,
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t,    y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t),
// written as y (B, T, H, D) and the final S (B, H, D, D), both float.  Any T >= 1: the tail of
// the last chunk reads as logw = 0 and k = v = 0, so it adds nothing to S and decays nothing
// (the Pallas wrapper pads logw with -1e-4 and starts from a zero state; this kernel does
// neither).  D is 16, 32, 64 or 128.
//
// Bound: memory.  A call reads r, k, v and logw once and writes y once: at rwkv6-3b's prefill
// (B 2, T 4096, H 40, D 64; r/k/v bf16) that is 14 B x 20,971,520 elements = 293.6 MB; with
// u, the final S written (1.3 MB) and the input state read (1.3 MB, the prefill passes the
// cache's), 296.2 MB, 88.4 us at 3.35 TB/s (294.9 MB, 88.0 us, with no s0).  It does
// 4 C^2 D + 4 C D^2 = 327,680 flops per (chunk, head) at D 64: 6.71 GFLOP, 6.8 us on the bf16
// tensor cores but 100 us at the 67 TFLOP/s of fp32 FMA, which is this design's floor.
//
// Design, for that bound:
//   * Why not the TPU grid.  Its grid (B*H, T / 16) walks the chunks in order on one core with
//     S in VMEM scratch.  Here blocks run in parallel in no order, so a block walks its chunks
//     in a loop; and B*H = 80 rows would leave 52 of 132 SMs idle.  The recurrence's value
//     columns are independent (column j of S and y depends only on v[:, j]), so the grid is
//     (B*H, D / 16): a block owns 16 value columns, 320 blocks at the prefill shape, all
//     resident at once (28.5 KB of shared memory and 256 threads each).
//   * A block keeps its D x 16 slice of S in registers (one float4 a thread at D 64) and a copy
//     in shared memory for the cross term.  Per chunk it stages r, k, logw (16 x D) and its v
//     columns (16 x 16) in shared memory as fp32, forms the within-chunk cumulative log decay
//     (one thread per key channel), the midpoint-centred qq = r exp(la_prev - mid) and
//     kk = k exp(mid - la), the 16 x 16 strict-lower scores, the u bonus and the cross term
//     (r exp(la_prev)) S, writes its y columns, and updates S with k exp(la_last - la).  The
//     scores do not depend on v, so the D / 16 blocks of a head each recompute them (25% of the
//     flops at D 64).
//   * Exponents stay within +-72 because logw is clipped to [-8, -1e-4] by the model and the
//     tail's logw is 0; __expf's error at those arguments is ~4e-6 relative.
//   * The next chunk's loads are issued into registers before the current chunk's arithmetic,
//     so their latency overlaps it.  fp32 FMA on CUDA cores, float4 shared-memory reads.
//     Tensor cores (mma.sync) and a cp.async ring are left for later work.
// The wrapper (ops.py) checks shapes, types, strides and alignment before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 16;            // tokens per chunk
constexpr int BV = 16;           // value columns per block
constexpr int NT = C * C;        // threads: one score (t, s) each in the score phase
constexpr int SCP = C + 1;       // padded row of the score tile
static_assert(NT == 256 && C * BV == NT, "the phase mappings below assume 256 threads");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements as a float4: one 16-byte load (float) or one 8-byte load (bfloat16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

struct Strides {
  long long b, t, h;   // in elements; unit stride over D
};

template <int D>
struct Smem {
  static constexpr int DP = D + 4;   // padded row: float4-aligned, rows 4 banks apart
  static constexpr int TILE = C * DP;
  // offsets, in floats, of: r (then r exp(la_prev)), k (then k exp(la_last - la)), logw (then
  // the inclusive cumulative la), qq, kk, S's copy, v's columns, scores, bonus, exp(la_last), u
  static constexpr int R = 0, K = TILE, LA = 2 * TILE, QQ = 3 * TILE, KK = 4 * TILE;
  static constexpr int S = 5 * TILE, V = S + D * BV, SC = V + C * BV, BON = SC + C * SCP;
  static constexpr int WL = BON + C, U = WL + D, TOTAL = U + D;
  static_assert(SC % 4 == 0, "float4 alignment of the tiles");
};

// Grid (B*H, D / BV), NT threads.  Block (bh, jb) computes columns [16 jb, 16 jb + 16) of y and
// of S for head bh % H of batch row bh / H.
template <typename T, int D>
__global__ void __launch_bounds__(NT) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ logw, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_out, int t_len, int h_len, Strides rs,
    Strides ks, Strides vs, Strides ws) {
  using L = Smem<D>;
  constexpr int DP = L::DP;
  constexpr int NV4 = C * D / 4;                   // float4s of one (16 x D) chunk tile
  constexpr int LPT = (NV4 + NT - 1) / NT;         // of them per thread
  constexpr int SPT = (D * BV / 4 + NT - 1) / NT;  // float4s of S per thread
  extern __shared__ __align__(16) float sm[];
  float* s_r = sm + L::R;
  float* s_k = sm + L::K;
  float* s_la = sm + L::LA;
  float* s_qq = sm + L::QQ;
  float* s_kk = sm + L::KK;
  float* s_S = sm + L::S;
  float* s_v = sm + L::V;
  float* s_sc = sm + L::SC;
  float* s_bon = sm + L::BON;
  float* s_wl = sm + L::WL;
  float* s_u = sm + L::U;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / h_len, hi = bh % h_len;
  const int j0 = blockIdx.y * BV;
  const T* rp = r + bi * rs.b + hi * rs.h;
  const T* kp = k + bi * ks.b + hi * ks.h;
  const T* vp = v + bi * vs.b + hi * vs.h + j0;
  const float* wp = logw + bi * ws.b + hi * ws.h;
  const int n_chunks = (t_len + C - 1) / C;

  for (int i = tid; i < D; i += NT) s_u[i] = u[hi * D + i];

  // this thread's S elements: row d = e / 4, columns 4 (e % 4) .. + 3, for e = tid + NT i
  float4 S[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int e = tid + NT * i;
    S[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < D * BV / 4 && s0 != nullptr)
      S[i] = *reinterpret_cast<const float4*>(s0 + ((size_t)bh * D + e / 4) * D + j0 + 4 * (e % 4));
  }

  // the chunk's loads, into registers: float4 f = tid + NT i of r, k, logw is token f / (D/4),
  // channels 4 (f % (D/4)) .. + 3; thread tid's v element is token tid / 16, column tid % 16.
  // Tokens past T read as zero (logw 0: no decay).
  float4 nr[LPT], nk[LPT], nw[LPT];
  float nv;
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int f = tid + NT * i;
      const int tok = c * C + f / (D / 4);
      const int d = 4 * (f % (D / 4));
      nr[i] = nk[i] = nw[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f < NV4 && tok < t_len) {
        nr[i] = load4(rp + tok * rs.t + d);
        nk[i] = load4(kp + tok * ks.t + d);
        nw[i] = load4(wp + tok * ws.t + d);
      }
    }
    const int tok = c * C + tid / BV;
    nv = tok < t_len ? to_f(vp[tok * vs.t + tid % BV]) : 0.f;
  };
  load_chunk(0);

  for (int c = 0; c < n_chunks; ++c) {
    // stage the chunk and S's copy
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int f = tid + NT * i;
      if (f < NV4) {
        const int off = (f / (D / 4)) * DP + 4 * (f % (D / 4));
        *reinterpret_cast<float4*>(s_r + off) = nr[i];
        *reinterpret_cast<float4*>(s_k + off) = nk[i];
        *reinterpret_cast<float4*>(s_la + off) = nw[i];
      }
    }
    s_v[tid] = nv;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int e = tid + NT * i;
      if (e < D * BV / 4) *reinterpret_cast<float4*>(s_S + 4 * e) = S[i];
    }
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);

    // cumulative log decay within the chunk, one thread per key channel
    if (tid < D) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        acc += s_la[t * DP + tid];
        s_la[t * DP + tid] = acc;
      }
      s_wl[tid] = __expf(acc);
    }
    __syncthreads();

    // centred qq and kk; r -> r exp(la_prev), k -> k exp(la_last - la); the bonus r . (u * k)
    {
      const int t = tid / 16, dg = tid % 16;
      float bon = 0.f;
#pragma unroll
      for (int d = dg; d < D; d += 16) {
        const int o = t * DP + d;
        const float la = s_la[o], lp = t ? s_la[o - DP] : 0.f;
        const float mid = s_la[(C / 2) * DP + d], last = s_la[(C - 1) * DP + d];
        const float rv = s_r[o], kv = s_k[o];
        bon = fmaf(rv * s_u[d], kv, bon);
        s_qq[o] = rv * __expf(lp - mid);
        s_kk[o] = kv * __expf(mid - la);
        s_r[o] = rv * __expf(lp);
        s_k[o] = kv * __expf(last - la);
      }
#pragma unroll
      for (int m = 8; m >= 1; m >>= 1) bon += __shfl_xor_sync(0xffffffffu, bon, m);
      if (dg == 0) s_bon[t] = bon;
    }
    __syncthreads();

    // strict-lower scores qq[t] . kk[s], s < t
    {
      const int t = tid / C, s = tid % C;
      float acc = 0.f;
      if (s < t) {
        float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 q = *reinterpret_cast<const float4*>(s_qq + t * DP + d);
          const float4 kk = *reinterpret_cast<const float4*>(s_kk + s * DP + d);
          a4.x = fmaf(q.x, kk.x, a4.x);
          a4.y = fmaf(q.y, kk.y, a4.y);
          a4.z = fmaf(q.z, kk.z, a4.z);
          a4.w = fmaf(q.w, kk.w, a4.w);
        }
        acc = (a4.x + a4.y) + (a4.z + a4.w);
      }
      s_sc[t * SCP + s] = acc;
    }
    __syncthreads();

    // y[t, 4 jq .. + 3]: cross (r exp(la_prev)) S + intra scores v + bonus v, the reductions
    // split over the four dq lanes and summed by shuffles
    {
      const int t = tid / 16, dq = (tid / 4) % 4, jq = tid % 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int d = dq; d < D; d += 4)
        fma4(acc, s_r[t * DP + d], *reinterpret_cast<const float4*>(s_S + d * BV + 4 * jq));
#pragma unroll
      for (int s = dq; s < C; s += 4)
        if (s < t)
          fma4(acc, s_sc[t * SCP + s], *reinterpret_cast<const float4*>(s_v + s * BV + 4 * jq));
      if (dq == 0)
        fma4(acc, s_bon[t], *reinterpret_cast<const float4*>(s_v + t * BV + 4 * jq));
#pragma unroll
      for (int m = 4; m <= 8; m <<= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
      }
      const int tok = c * C + t;
      if (dq == 0 && tok < t_len)
        *reinterpret_cast<float4*>(y + (((size_t)bi * t_len + tok) * h_len + hi) * D + j0 +
                                   4 * jq) = acc;
    }

    // S = diag(exp(la_last)) S + (k exp(la_last - la))^T v, in registers (the copy in shared
    // memory is refreshed when the next chunk is staged)
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int e = tid + NT * i;
      if (e < D * BV / 4) {
        const int d = e / 4, jq = e % 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < C; ++t)
          fma4(acc, s_k[t * DP + d], *reinterpret_cast<const float4*>(s_v + t * BV + 4 * jq));
        const float w = s_wl[d];
        S[i].x = fmaf(w, S[i].x, acc.x);
        S[i].y = fmaf(w, S[i].y, acc.y);
        S[i].z = fmaf(w, S[i].z, acc.z);
        S[i].w = fmaf(w, S[i].w, acc.w);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int e = tid + NT * i;
    if (e < D * BV / 4)
      *reinterpret_cast<float4*>(s_out + ((size_t)bh * D + e / 4) * D + j0 + 4 * (e % 4)) = S[i];
  }
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u,
           const float* s0, float* y, float* s_out, int b, int t_len, int h, Strides rs,
           Strides ks, Strides vs, Strides ws, cudaStream_t st) {
  const size_t smem = (size_t)Smem<D>::TOTAL * sizeof(float);
  auto kern = rwkv6_scan_kernel<T, D>;
  if (smem > 48 * 1024) {   // D 128: opt in to more than the default 48 KB, once
    static const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid(b * h, D / BV);
  kern<<<grid, NT, smem, st>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                               static_cast<const T*>(v), logw, u, s0, y, s_out, t_len, h, rs,
                               ks, vs, ws);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* r, const void* k, const void* v, const float* logw,
               const float* u, const float* s0, float* y, float* s_out, int b, int t_len, int h,
               Strides rs, Strides ks, Strides vs, Strides ws, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(r, k, v, logw, u, s0, y, s_out, b, t_len, h, rs, ks, vs, ws, st);
    case 32: return launch<T, 32>(r, k, v, logw, u, s0, y, s_out, b, t_len, h, rs, ks, vs, ws, st);
    case 64: return launch<T, 64>(r, k, v, logw, u, s0, y, s_out, b, t_len, h, rs, ks, vs, ws, st);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, s0, y, s_out, b, t_len, h, rs, ks, vs, ws, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 = float32, 1 = bfloat16.  s0 may be null (zero initial state).  Strides
// are in elements, (batch, token, head) for each of r, k, v, logw.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                                 const void* u, const void* s0, void* y, void* s_out, int dtype,
                                 int b, int t_len, int h, int d, long long r_sb, long long r_st,
                                 long long r_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, long long w_sb,
                                 long long w_st, long long w_sh, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || t_len < 1 || h < 1 || (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides rs{r_sb, r_st, r_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      ws{w_sb, w_st, w_sh};
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_out);
  if (dtype == 0)
    return dispatch_d<float>(d, r, k, v, lw, uu, s0f, yf, sf, b, t_len, h, rs, ks, vs, ws, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, r, k, v, lw, uu, s0f, yf, sf, b, t_len, h, rs, ks, vs,
                                     ws, st);
  return (int)cudaErrorInvalidValue;
}
