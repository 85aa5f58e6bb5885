// RWKV6 wkv recurrence for Hopper (sm_90a), in chunks of 16 tokens, the time axis cut into
// segments whose states are passed along by a short scan.
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
// cache's), 296.2 MB, 88.4 us at 3.35 TB/s.  It does 4 C^2 D + 4 C D^2 = 327,680 flops per
// (chunk, head) at D 64: 6.71 GFLOP, 100 us at the 67 TFLOP/s of fp32 FMA.
//
// Design, for that bound.  The TPU kernel walks a head's T / 16 chunks in order (the grid's
// sequential axis, S in VMEM scratch): at T 4096 a chain of 256 links.  Here the time axis is
// cut into segments of L tokens (a multiple of 16, chosen by the wrapper), in three launches:
//   1. rwkv6_seg_local_kernel, grid (B*H, D / BV, n_seg - 1): each segment but the last runs
//      the chunk recurrence of S from a zero state (S = diag(w_c) S + (k exp(la_last - la))^T v
//      per chunk) and writes its end state S_loc(j), and its decay exp(sum logw) per key
//      channel (0 where it underflows, the right limit).
//   2. rwkv6_seg_pass_kernel, elementwise over (B, H, D, D): S_in(0) = s0, S_in(j + 1) =
//      diag(W_j) S_in(j) + S_loc(j), n_seg - 1 steps of a D x D update, S_in(j + 1) written
//      over S_loc(j).
//   3. rwkv6_seg_out_kernel, grid (B*H, D / BV, n_seg): each segment starts from S_in(j) and
//      runs the chunk arithmetic of the TPU kernel for its L / 16 chunks: cross term, strict
//      lower scores (once per head and column slice, BV = min(D, 64): once per head up to D
//      64), u bonus, y; the last segment writes the final S.
// Within passes 1 and 3 a block owns BV value columns of all D key rows of S, 16 elements a
// thread (4 x 4) in registers.  The chunk's r, k, logw and v are staged with cp.async one chunk
// ahead (each thread's copies worked out once, before the loop).  The chunk products are
// register-tiled fp32 FMA: y = [r exp(la_prev) | scores] . [S ; v] as one product over D + 16
// (4 tokens x 4 columns a thread, the depth split over the warps and summed in shared memory),
// and S's update 4 x 4 a thread over the 16 tokens; every shared-memory read of a product is a
// broadcast or conflict-free float4.  The 120 strict-lower scores take two threads each; the u
// bonus is summed by warp shuffles in the decay pass.
// Exponents stay within +-72 because logw is clipped to [-8, -1e-4] by the model and the tail's
// logw is 0; __expf's error at those arguments is ~4e-6 relative.
// The wrapper (ops.py) checks shapes, types, strides and alignment and allocates the segment
// states before the launch.

#include "hopper.cuh"

namespace {

constexpr int C = 16;            // tokens per chunk
constexpr int ATP = 20;          // padded row of the transposed [r exp(la_prev) | scores]
// threads of the score phase: two a strict-lower score, rounded up to whole warps
constexpr int SCORE_THREADS = (C * (C - 1) + 31) / 32 * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Strides {
  long long b, t, h;   // in elements; unit stride over D
};

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ float comp(const float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

template <typename T, int D>
struct Cfg {
  static constexpr int BV = D < 64 ? D : 64;           // value columns a block owns
  static constexpr int NOWN = D * BV / 16;              // threads owning 4 x 4 of S
  static constexpr int NT = NOWN < 32 ? 32 : NOWN;

  static constexpr int KQ = NT / BV;                    // depth splits of the y product
  static constexpr int K = D + C;                       // its depth: S's rows, then v's
  static constexpr int KQLEN = K / KQ;
  static constexpr int DP = D + 4;                      // padded row of qq and kk
  static constexpr int ES = (int)sizeof(T);
  // a staging buffer, in bytes: r, k (C x D of T), logw (C x D float), v (C x BV of T)
  static constexpr int RB = C * D * ES, LB = C * D * 4, VB = C * BV * ES;
  static constexpr int STAGE = 2 * RB + LB + VB;
  static constexpr int NBUF = 2;                        // staging buffers: NBUF - 1 chunks ahead
  // Both passes keep two sets of a chunk's k exp(la_last - la) (KD), v as float (VF) and
  // exp(la_last) (W), chunk c's in set c % 2, so that the decay of chunk c and the state update
  // of chunk c - 1 share a phase.
  static constexpr int SET_KD = 0, SET_VF = C * D, SET_W = SET_VF + C * BV;
  static constexpr int SET = SET_W + D;
  // pass 3's shared memory, in floats after the staging buffers: qq, kk, [r exp(la_prev) |
  // scores] transposed, S's columns, the two sets, the depth slices' partial y, u, the bonus
  static constexpr int QQ = 0, KK = QQ + C * DP, AT = KK + C * DP, BM = AT + K * ATP;
  static constexpr int SETS = BM + D * BV, RED = SETS + 2 * SET;
  static constexpr int NBP = D < 32 ? 1 : D / 32;      // partial sums of the u bonus
  static constexpr int U = RED + (KQ - 1) * C * BV, BON = U + D, OUT_FLOATS = BON + NBP * C;
  static constexpr int OUT_SMEM = NBUF * STAGE + 4 * OUT_FLOATS;
  // pass 1's: the staging buffers, then the two sets
  static constexpr int LOCAL_SMEM = NBUF * STAGE + 4 * 2 * SET;
  static_assert(NT % BV == 0 && KQ >= 2 && K % KQ == 0 && RB % 16 == 0 && VB % 16 == 0,
                "the mappings below assume these");
};

// The cp.async copies of a chunk's tokens (those >= t_len zero-filled) into a staging buffer:
// r (with R), k, logw and v's columns, 16 bytes a piece.  Each thread's pieces (token within
// the chunk, source row, its place in the buffer) are worked out once; a chunk then costs a
// multiply-add and a copy a piece.
template <typename T, int D, bool R>
struct Stager {
  using G = Cfg<T, D>;
  static constexpr int PR = D * G::ES / 16, PW = D * 4 / 16, PV = G::BV * G::ES / 16;
  static constexpr int PIECES = C * ((R ? 2 : 1) * PR + PW + PV);
  static constexpr int PPT = (PIECES + G::NT - 1) / G::NT;
  const char* src[PPT];
  int step[PPT];          // bytes from one token to the next (the wrapper keeps it in int)
  uint32_t dst[PPT];      // offset in the buffer
  int tok[PPT];           // token within the chunk; -1: no piece

  __device__ __forceinline__ Stager(const T* rp, const T* kp, const float* wp, const T* vp,
                                    Strides rs, Strides ks, Strides ws, Strides vs, int tid) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int q = tid + G::NT * i;
      tok[i] = -1;
      src[i] = reinterpret_cast<const char*>(kp);
      step[i] = 0;
      dst[i] = 0;
      if (q >= PIECES) continue;
      if (R && q < C * PR) {
        tok[i] = q / PR;
        src[i] = reinterpret_cast<const char*>(rp) + 16 * (q % PR);
        step[i] = (int)(rs.t * G::ES);
        dst[i] = 16 * q;
        continue;
      }
      if (R) q -= C * PR;
      if (q < C * PR) {
        tok[i] = q / PR;
        src[i] = reinterpret_cast<const char*>(kp) + 16 * (q % PR);
        step[i] = (int)(ks.t * G::ES);
        dst[i] = G::RB + 16 * q;
      } else if ((q -= C * PR) < C * PW) {
        tok[i] = q / PW;
        src[i] = reinterpret_cast<const char*>(wp) + 16 * (q % PW);
        step[i] = (int)(ws.t * 4);
        dst[i] = 2 * G::RB + 16 * q;
      } else {
        q -= C * PW;
        tok[i] = q / PV;
        src[i] = reinterpret_cast<const char*>(vp) + 16 * (q % PV);
        step[i] = (int)(vs.t * G::ES);
        dst[i] = 2 * G::RB + G::LB + 16 * q;
      }
    }
  }

  // tokens tok0 .. tok0 + 15 into the buffer at shared address buf
  __device__ __forceinline__ void fetch(uint32_t buf, int tok0, int t_len) const {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (tok[i] < 0) continue;
      const int t = tok0 + tok[i];
      const bool in = t < t_len;
      hopper::cp_async16(buf + dst[i], in ? src[i] + (long long)t * step[i] : src[i],
                         in ? 16 : 0);
    }
  }
};

// The chunk's within-chunk log decay, one (key channel d, quarter tq of the tokens) a thread:
// the inclusive cumulative la over the 16 tokens, its midpoint mid = la[8] and last la[15].
// Writes kd = k exp(last - la) [t][d], exp(last) [d]; with the y terms (pass 3) also qq = r
// exp(la_prev - mid) and kk = k exp(mid - la) [t][DP] and r exp(la_prev) transposed [d][ATP].
// Thread d < D (the one with tq 0 of channel d) also gets last in last_d.  With the y terms,
// the u bonus r . (u * k) of each token, summed over 32 channels (a warp's lanes) into
// bon[d / 32][t].
template <typename T, int D, bool Y>
__device__ __forceinline__ void chunk_decay(const unsigned char* buf, float* kd, float* wl,
                                            float* qq, float* kk, float* at, const float* uu,
                                            float* bon, float& last_d, int tid) {
  using G = Cfg<T, D>;
  const T* r = reinterpret_cast<const T*>(buf);
  const T* k = reinterpret_cast<const T*>(buf + G::RB);
  const float* lw = reinterpret_cast<const float*>(buf + 2 * G::RB);
  for (int idx = tid; idx < 4 * D; idx += G::NT) {
    const int d = idx % D, tq = idx / D;
    // the cumulative sum in token order: la[8] (mid), la[15] (last) and la[4 tq - 1] (pre),
    // then this thread's four tokens continuing from pre (the same sums, in the same order)
    float acc = 0.f, mid = 0.f, pre = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      acc += lw[t * D + d];
      if (t == C / 2) mid = acc;
      if (t == 4 * tq - 1) pre = acc;
    }
    const float last = acc;
    if (tq == 0) {
      wl[d] = __expf(last);
      last_d = last;
    }
    float l5[5];   // la at tokens 4 tq - 1 .. 4 tq + 3 (la[-1] = 0)
    l5[0] = pre;
#pragma unroll
    for (int i = 0; i < 4; ++i) l5[i + 1] = l5[i] + lw[(4 * tq + i) * D + d];
    float rr[4], ruk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * tq + i;
      const float kv = to_f(k[t * D + d]);
      kd[t * D + d] = kv * __expf(last - l5[i + 1]);
      if constexpr (Y) {
        const float rv = to_f(r[t * D + d]);
        qq[t * G::DP + d] = rv * __expf(l5[i] - mid);
        kk[t * G::DP + d] = kv * __expf(mid - l5[i + 1]);
        rr[i] = rv * __expf(l5[i]);
        ruk[i] = rv * uu[d] * kv;
      }
    }
    if constexpr (Y) {
      st4(at + d * ATP + 4 * tq, make_float4(rr[0], rr[1], rr[2], rr[3]));
      // the lanes of one tq hold min(32, D) consecutive channels (4 D is a multiple of NT)
      constexpr int W = D < 32 ? D : 32;
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) ruk[i] += __shfl_xor_sync(0xffffffffu, ruk[i], off);
      if (d % W == 0) st4(bon + (d / 32) * C + 4 * tq, make_float4(ruk[0], ruk[1], ruk[2], ruk[3]));
    }
  }
}

// v's columns of the chunk as float, [t][BV], into dst
template <typename T, int D>
__device__ __forceinline__ void chunk_v(const unsigned char* buf, float* dst, int tid) {
  using G = Cfg<T, D>;
  const T* v = reinterpret_cast<const T*>(buf + 2 * G::RB + G::LB);
  for (int i = tid; i < C * G::BV; i += G::NT) dst[i] = to_f(v[i]);
}

// S (this thread's 4 x 4: rows 4 dg .., columns 4 jg ..) = diag(w) S + kd^T v over the chunk
template <int D, int BV>
__device__ __forceinline__ void state_update(float4 (&S)[4], const float* kd, const float* vf,
                                             const float* wl, int dg, int jg) {
  float4 acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const float4 a = ld4(kd + t * D + 4 * dg), b = ld4(vf + t * BV + 4 * jg);
#pragma unroll
    for (int i = 0; i < 4; ++i) fma4(acc[i], comp(a, i), b);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float w = wl[4 * dg + i];
    S[i].x = fmaf(w, S[i].x, acc[i].x);
    S[i].y = fmaf(w, S[i].y, acc[i].y);
    S[i].z = fmaf(w, S[i].z, acc[i].z);
    S[i].w = fmaf(w, S[i].w, acc[i].w);
  }
}

// Pass 1.  Block (bh, slice, seg): the end state of segment seg from a zero state, columns
// [BV slice, BV slice + BV), into seg_state[seg]; slice 0 also writes the segment's decay.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::NT) rwkv6_seg_local_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
    float* __restrict__ seg_state, float* __restrict__ seg_decay, int t_len, int h_len,
    int b_len, int seg_len, Strides ks, Strides vs, Strides ws) {
  using G = Cfg<T, D>;
  constexpr int BV = G::BV;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sets = reinterpret_cast<float*>(smem + G::NBUF * G::STAGE);
  const int tid = threadIdx.x, bh = blockIdx.x, seg = blockIdx.z;
  const int bi = bh / h_len, hi = bh % h_len, j0 = blockIdx.y * BV;
  const T* kp = k + bi * ks.b + hi * ks.h;
  const T* vp = v + bi * vs.b + hi * vs.h + j0;
  const float* wp = logw + bi * ws.b + hi * ws.h;
  const int tok0 = seg * seg_len, n_chunks = seg_len / C;   // never the last, partial segment
  const int dg = tid / (BV / 4), jg = tid % (BV / 4);
  const bool owner = tid < G::NOWN;

  float4 S[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) S[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float decay = 0.f;   // sum of la_last over the chunks, thread d < D of tq 0

  const Stager<T, D, false> stager(kp, kp, wp, vp, ks, ks, ws, vs, tid);
  const uint32_t sbase = hopper::smem_u32(smem);
  for (int c = 0; c < G::NBUF - 1; ++c) {   // the first NBUF - 1 chunks
    if (c < n_chunks) stager.fetch(sbase + c * G::STAGE, tok0 + c * C, t_len);
    hopper::cp_async_commit();
  }
  // one barrier a chunk: the decay of chunk c (every thread, into set c % 2) beside the state
  // update of chunk c - 1 (the owners, from set (c - 1) % 2)
  for (int c = 0; c <= n_chunks; ++c) {
    hopper::cp_async_wait<G::NBUF - 2>();   // chunk c has landed
    __syncthreads();
    const int ahead = c + G::NBUF - 1;      // into the buffer chunk c - 1 was read from
    if (ahead < n_chunks)
      stager.fetch(sbase + (ahead % G::NBUF) * G::STAGE, tok0 + ahead * C, t_len);
    hopper::cp_async_commit();
    if (c < n_chunks) {
      const unsigned char* buf = smem + (c % G::NBUF) * G::STAGE;
      float* set = sets + (c & 1) * G::SET;
      float last = 0.f;
      chunk_decay<T, D, false>(buf, set + G::SET_KD, set + G::SET_W, nullptr, nullptr, nullptr,
                               nullptr, nullptr, last, tid);
      chunk_v<T, D>(buf, set + G::SET_VF, tid);
      decay += last;
    }
    if (c > 0 && owner) {
      const float* set = sets + ((c - 1) & 1) * G::SET;
      state_update<D, BV>(S, set + G::SET_KD, set + G::SET_VF, set + G::SET_W, dg, jg);
    }
  }
  if (owner) {
    float* out = seg_state + (((long long)seg * b_len * h_len + bh) * D + 4 * dg) * D + j0 + 4 * jg;
#pragma unroll
    for (int i = 0; i < 4; ++i) st4(out + i * D, S[i]);
  }
  if (blockIdx.y == 0 && tid < D)
    seg_decay[((long long)seg * b_len * h_len + bh) * D + tid] = __expf(decay);
}

// Pass 2.  One thread per 4 elements of (B, H, D, D): S = s0 (or 0), then for each segment but
// the last, S = diag(W_j) S + S_loc(j), written over S_loc(j) (S_in(j + 1)).
template <int D>
__global__ void __launch_bounds__(256) rwkv6_seg_pass_kernel(
    const float* __restrict__ s0, float* __restrict__ seg_state,
    const float* __restrict__ seg_decay, long long n4, int n_seg) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long bh = i / (D * D / 4);
  const int dk = (int)((i % (D * D / 4)) / (D / 4));
  float4 S = s0 != nullptr ? ld4(s0 + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j + 1 < n_seg; ++j) {
    const float w = seg_decay[(j * (n4 * 4 / (D * D)) + bh) * D + dk];
    float* p = seg_state + (long long)j * n4 * 4 + 4 * i;
    const float4 l = ld4(p);
    S = make_float4(fmaf(w, S.x, l.x), fmaf(w, S.y, l.y), fmaf(w, S.z, l.z), fmaf(w, S.w, l.w));
    st4(p, S);
  }
}

// Pass 3.  Block (bh, slice, seg): y of segment seg's tokens, columns [BV slice, BV slice +
// BV), from S_in(seg); the last segment writes those columns of the final S.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::NT) rwkv6_seg_out_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ logw, const float* __restrict__ u, const float* __restrict__ s0,
    const float* __restrict__ seg_state, float* __restrict__ y, float* __restrict__ s_out,
    int t_len, int h_len, int b_len, int seg_len, Strides rs, Strides ks, Strides vs,
    Strides ws) {
  using G = Cfg<T, D>;
  constexpr int BV = G::BV, DP = G::DP, KQ = G::KQ, KQLEN = G::KQLEN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem + G::NBUF * G::STAGE);
  float* qq = f + G::QQ;
  float* kk = f + G::KK;
  float* at = f + G::AT;     // [K][ATP]: rows d < D: r exp(la_prev) [d][t]; D + s: score [.][t]
  float* bm = f + G::BM;     // [D][BV]: S's columns
  float* sets = f + G::SETS; // [2][SET]: KD, VF, W of chunk c in set c % 2
  float* red = f + G::RED;   // [KQ - 1][C][BV]
  float* uu = f + G::U;
  float* bon = f + G::BON;   // [NBP][C]
  const int tid = threadIdx.x, bh = blockIdx.x, seg = blockIdx.z, n_seg = gridDim.z;
  const int bi = bh / h_len, hi = bh % h_len, j0 = blockIdx.y * BV;
  const T* rp = r + bi * rs.b + hi * rs.h;
  const T* kp = k + bi * ks.b + hi * ks.h;
  const T* vp = v + bi * vs.b + hi * vs.h + j0;
  const float* wp = logw + bi * ws.b + hi * ws.h;
  const int tok0 = seg * seg_len;
  const int n_chunks = (min(seg_len, t_len - tok0) + C - 1) / C;
  const int dg = tid / (BV / 4), jg = tid % (BV / 4);
  const bool owner = tid < G::NOWN;
  // the y product: tile (4 tokens from 4 tg, 4 columns from 4 cg) over depth slice kq
  const int tile = tid % BV, kq = tid / BV, tg = tile / (BV / 4), cg = tile % (BV / 4);

  const Stager<T, D, true> stager(rp, kp, wp, vp, rs, ks, ws, vs, tid);
  const uint32_t sbase = hopper::smem_u32(smem);
  for (int c = 0; c < G::NBUF - 1; ++c) {   // the first NBUF - 1 chunks
    if (c < n_chunks) stager.fetch(sbase + c * G::STAGE, tok0 + c * C, t_len);
    hopper::cp_async_commit();
  }
  for (int i = tid; i < D; i += G::NT) uu[i] = u[hi * D + i];
  for (int e = tid; e < C * C; e += G::NT)   // the scores above the diagonal stay 0
    if (e % C > e / C) at[(D + e % C) * ATP + e / C] = 0.f;
  float4 S[4];
  {
    const float* src = seg > 0 ? seg_state + (long long)(seg - 1) * b_len * h_len * D * D : s0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      S[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (owner && src != nullptr) S[i] = ld4(src + ((long long)bh * D + 4 * dg + i) * D + j0 + 4 * jg);
      if (owner) st4(bm + (4 * dg + i) * BV + 4 * jg, S[i]);
    }
  }

  // Three barriers a chunk.  Phase 1: chunk c - 1's y (its depth slices summed) and state
  // update, beside chunk c's decay; phase 2: chunk c's scores; phase 3: chunk c's y product,
  // each depth slice's partial kept (kq 0, in registers) or in red (the others).
  float4 acc[4];
  for (int c = 0; c <= n_chunks; ++c) {
    hopper::cp_async_wait<G::NBUF - 2>();   // chunk c has landed
    __syncthreads();
    const int ahead = c + G::NBUF - 1;      // into the buffer chunk c - 1 was read from
    if (ahead < n_chunks)
      stager.fetch(sbase + (ahead % G::NBUF) * G::STAGE, tok0 + ahead * C, t_len);
    hopper::cp_async_commit();
    if (c > 0) {
      if (kq == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          for (int q = 0; q < KQ - 1; ++q) {
            const float4 p = ld4(red + (q * C + 4 * tg + i) * BV + 4 * cg);
            acc[i].x += p.x;
            acc[i].y += p.y;
            acc[i].z += p.z;
            acc[i].w += p.w;
          }
          const int tok = tok0 + (c - 1) * C + 4 * tg + i;
          if (tok < t_len)
            st4(y + (((long long)bi * t_len + tok) * h_len + hi) * D + j0 + 4 * cg, acc[i]);
        }
      }
      if (owner) {
        const float* set = sets + ((c - 1) & 1) * G::SET;
        state_update<D, BV>(S, set + G::SET_KD, set + G::SET_VF, set + G::SET_W, dg, jg);
#pragma unroll
        for (int i = 0; i < 4; ++i) st4(bm + (4 * dg + i) * BV + 4 * jg, S[i]);
      }
    }
    if (c == n_chunks) break;
    const unsigned char* buf = smem + (c % G::NBUF) * G::STAGE;
    float* set = sets + (c & 1) * G::SET;
    float last = 0.f;
    chunk_decay<T, D, true>(buf, set + G::SET_KD, set + G::SET_W, qq, kk, at, uu, bon, last,
                            tid);
    chunk_v<T, D>(buf, set + G::SET_VF, tid);
    __syncthreads();

    // the 120 strict-lower scores qq[t] . kk[s], s < t, into at[D + s][t]: two threads a
    // score, each half of the channels (alternate float4s, so the two read other banks);
    // the diagonal is the u bonus
    for (int e = tid; e < SCORE_THREADS; e += G::NT) {
      const int pr = e >> 1, half = e & 1;
      const int t = (int)((1.f + sqrtf(1.f + 8.f * pr)) * 0.5f);   // pr = t (t - 1) / 2 + s
      const int s = pr - t * (t - 1) / 2;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pr < C * (C - 1) / 2) {
#pragma unroll
        for (int d = 4 * half; d < D; d += 8) {
          const float4 p = ld4(qq + t * DP + d), q = ld4(kk + s * DP + d);
          a.x = fmaf(p.x, q.x, a.x);
          a.y = fmaf(p.y, q.y, a.y);
          a.z = fmaf(p.z, q.z, a.z);
          a.w = fmaf(p.w, q.w, a.w);
        }
      }
      float x = (a.x + a.y) + (a.z + a.w);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      if (pr < C * (C - 1) / 2 && half == 0) at[(D + s) * ATP + t] = x;
    }
    for (int t = tid; t < C; t += G::NT) {
      float x = 0.f;
#pragma unroll
      for (int p = 0; p < G::NBP; ++p) x += bon[p * C + t];
      at[(D + t) * ATP + t] = x;
    }
    __syncthreads();

    // y = [r exp(la_prev) | scores] . [S ; v], this thread's depth slice
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    {
      const float* vf = set + G::SET_VF;
      const float* ap = at + kq * KQLEN * ATP + 4 * tg;
#pragma unroll
      for (int x = 0; x < KQLEN; ++x) {
        const int kx = kq * KQLEN + x;
        const float* brow = kx < D ? bm + kx * BV : vf + (kx - D) * BV;
        const float4 a = ld4(ap + x * ATP), b = ld4(brow + 4 * cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) fma4(acc[i], comp(a, i), b);
      }
    }
    if (kq > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(red + ((kq - 1) * C + 4 * tg + i) * BV + 4 * cg, acc[i]);
    }
  }
  if (owner && seg == n_seg - 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(s_out + ((long long)bh * D + 4 * dg + i) * D + j0 + 4 * jg, S[i]);
  }
}

// let the kernel take `bytes` of dynamic shared memory
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u,
           const float* s0, float* y, float* s_out, float* seg_state, float* seg_decay, int b,
           int t_len, int h, int seg_len, Strides rs, Strides ks, Strides vs, Strides ws,
           cudaStream_t st) {
  using G = Cfg<T, D>;
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const int n_seg = (t_len + seg_len - 1) / seg_len;
  const int slices = D / G::BV;
  static const cudaError_t attr = [] {
    cudaError_t rc = allow_smem(rwkv6_seg_out_kernel<T, D>, G::OUT_SMEM);
    return rc == cudaSuccess ? allow_smem(rwkv6_seg_local_kernel<T, D>, G::LOCAL_SMEM) : rc;
  }();
  if (attr != cudaSuccess) return (int)attr;
  if (n_seg > 1) {
    rwkv6_seg_local_kernel<T, D><<<dim3(b * h, slices, n_seg - 1), G::NT, G::LOCAL_SMEM, st>>>(
        kk, vv, logw, seg_state, seg_decay, t_len, h, b, seg_len, ks, vs, ws);
    const long long n4 = (long long)b * h * D * D / 4;
    rwkv6_seg_pass_kernel<D><<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
        s0, seg_state, seg_decay, n4, n_seg);
  }
  rwkv6_seg_out_kernel<T, D><<<dim3(b * h, slices, n_seg), G::NT, G::OUT_SMEM, st>>>(
      rr, kk, vv, logw, u, s0, seg_state, y, s_out, t_len, h, b, seg_len, rs, ks, vs, ws);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* r, const void* k, const void* v, const float* logw,
               const float* u, const float* s0, float* y, float* s_out, float* seg_state,
               float* seg_decay, int b, int t_len, int h, int seg_len, Strides rs, Strides ks,
               Strides vs, Strides ws, cudaStream_t st) {
#define RWKV6_CASE(DD)                                                                      \
  case DD:                                                                                  \
    return launch<T, DD>(r, k, v, logw, u, s0, y, s_out, seg_state, seg_decay, b, t_len, h, \
                         seg_len, rs, ks, vs, ws, st);
  switch (d) {
    RWKV6_CASE(16)
    RWKV6_CASE(32)
    RWKV6_CASE(64)
    RWKV6_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RWKV6_CASE
}

}  // namespace

// dtype of r, k, v: 0 = float32, 1 = bfloat16.  s0 may be null (zero initial state).  seg_len
// is the segment length L (a multiple of 16); with n_seg = ceil(T / L) > 1, seg_state holds
// (n_seg - 1) x B x H x D x D floats and seg_decay (n_seg - 1) x B x H x D (scratch, written
// and read here).  Strides are in elements, (batch, token, head) for each of r, k, v, logw.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                                 const void* u, const void* s0, void* y, void* s_out,
                                 void* seg_state, void* seg_decay, int dtype, int b, int t_len,
                                 int h, int d, int seg_len, long long r_sb, long long r_st,
                                 long long r_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, long long w_sb,
                                 long long w_st, long long w_sh, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || t_len < 1 || h < 1 || (long long)b * h > 0x7fffffffLL || seg_len < C ||
      seg_len % C || (t_len + seg_len - 1) / seg_len > 65535 ||
      (t_len > seg_len && (seg_state == nullptr || seg_decay == nullptr)))
    return (int)cudaErrorInvalidValue;
  // the copies step from token to token in int bytes
  const long long es = dtype == 0 ? 4 : 2;
  if (r_st * es > 0x7fffffffLL || k_st * es > 0x7fffffffLL || v_st * es > 0x7fffffffLL ||
      w_st * 4 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides rs{r_sb, r_st, r_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      ws{w_sb, w_st, w_sh};
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_out);
  float* ss = static_cast<float*>(seg_state);
  float* sd = static_cast<float*>(seg_decay);
  if (dtype == 0)
    return dispatch_d<float>(d, r, k, v, lw, uu, s0f, yf, sf, ss, sd, b, t_len, h, seg_len, rs,
                             ks, vs, ws, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, r, k, v, lw, uu, s0f, yf, sf, ss, sd, b, t_len, h,
                                     seg_len, rs, ks, vs, ws, st);
  return (int)cudaErrorInvalidValue;
}