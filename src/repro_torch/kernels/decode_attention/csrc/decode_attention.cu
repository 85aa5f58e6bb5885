// Single-token GQA decode attention for Hopper (sm_90a): one launch, split over the live keys,
// the splits of a row merged inside a thread-block cluster.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::decode_attention_fwd
// (_dec_kernel).  Computes repro_torch/kernels/decode_attention/ref.py::decode_attention_ref,
// in the model's own layout: q (B, 1, H, D) contiguous, k and v the KV cache (B, T, K, D) read
// through its strides (no transposed copy of the cache), pos (B,) int32 on the device, out
// (B, 1, H, D) in q's type.  H = K * G; keys at index > pos[b] are masked, and never read.
//
// Bound: memory.  A call must read sum_b (pos_b + 1) * K * D * 2 * sizeof(T) bytes of cache
// (plus q and out), and does 4 * G flops per cache element it reads (G = 2 for gemma3-4b), far
// below the ~295 flop/byte at which the H100 stops being memory-bound.  The least time is those
// bytes over 3.35 TB/s: 5.0 us for gemma3-4b's full 2048-key cache, ~0.1 us at position 45.
//
// Design, for that bound:
//   * Split over the live keys, on the device.  The grid (n_split, K, B) is fixed by the host
//     from the shapes alone (so the call can be captured in a CUDA graph); each block reads
//     pos[b] itself and takes its share of the row's pos[b] + 1 keys, in runs of UNIT = 16
//     keys: at position 45 three blocks take 16, 16 and 14 keys, at the full cache each of 16
//     blocks takes 128.  A block whose share is empty exits at once and reads no cache.
//   * One launch.  The n_split blocks of a (batch, kv head) row form one thread-block cluster
//     (up to 16 blocks, non-portable above 8).  Each live block reduces its keys to (m, l,
//     acc[G][D]) of an online softmax and stores them with st.async straight into block 0's
//     shared memory, counted in bytes on block 0's mbarrier; block 0 merges the live splits
//     only, divides by max(l, 1e-30) (kernel.py:66) and writes the output.  No global scratch,
//     no counters, no second kernel.
//   * Bytes in flight.  The block's K and V rows (D * sizeof(T) bytes each, read through the
//     cache's strides) go through a ring of STAGES shared-memory stages of TK keys (~16 KB of
//     K and V a stage), each with a full and an empty mbarrier: every thread copies its
//     16-byte pieces of a stage with cp.async and arrives on the full barrier when they land
//     (cp.async.mbarrier.arrive), and a stage is refilled once all four warps have arrived on
//     its empty barrier, so ~48 KB per block are in flight while the warps work on the stages
//     that have landed.
//   * Scores on CUDA cores in fp32 (at G 1-2 a 64-row wgmma tile would idle): a group of LPK
//     lanes holds one key row, E contiguous elements a lane (one 16-byte shared load), with q
//     pre-scaled by 1/sqrt(D) in registers; a shuffle reduction within the group gives the
//     score, then the tanh softcap (a branch taken once, outside the loop).  Each lane group
//     keeps its own (m, l, acc) and folds in NJ keys of a stage at once, with no branch
//     between them, so their loads, products and shuffle reductions interleave (a branch per
//     key would run them one after another): one max, one rescale, then p . v from the same
//     register layout.  The only block-wide wait in the loop is a stage's empty barrier before
//     it is refilled.  The groups, then the four warps,
//     are merged at the end, in registers and in shared memory.
// Supports D in {16, 32, 64, 128, 256}, G <= 8 (instantiated at G = 1, 2, 4, 8), T = float or
// bfloat16, n_split <= 16.  The wrapper (ops.py) checks shapes, types, strides and alignment,
// and picks n_split with decode_attention_smem_bytes, before the launch.

#include "hopper.cuh"

namespace {

constexpr int NCW = 4;                  // warps
constexpr int NT = NCW * 32;
constexpr int MAX_SPLIT = 16;           // blocks of a cluster
constexpr int UNIT = 16;                // keys of a split come in runs of UNIT
constexpr int STAGES = 3;               // of ~16 KB of K and V each
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may have
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
struct Cfg {
  static constexpr int ROW = D * (int)sizeof(T);        // bytes of one key row
  static constexpr int CH = 16 / (int)sizeof(T);        // elements of a 16-byte chunk
  static constexpr int E = (D / 32 > CH) ? D / 32 : CH; // elements a lane holds of a row
  static constexpr int LPK = D / E;                     // lanes per key row
  static constexpr int KPW = 32 / LPK;                  // key rows a warp takes at once
  static constexpr int TK_RAW = 8192 / ROW;
  static constexpr int TK0 = TK_RAW < 16 ? 16 : (TK_RAW > 64 ? 64 : TK_RAW);
  static constexpr int TK = TK0 < NCW * KPW ? NCW * KPW : TK0;   // keys a stage
  static constexpr int STAGE_BYTES = 2 * TK * ROW;      // K then V
  static constexpr int NJ = TK / (NCW * KPW);           // keys of a stage per lane group
  static_assert(ROW % 16 == 0 && E % CH == 0 && NJ >= 1 && TK % (NCW * KPW) == 0,
                "a row must be whole 16-byte chunks, spread evenly over the lanes");
};

// shared memory of a block: the ring, the warps' partials, the slots block 0 receives the
// other splits' partials in (a row of D + 4 floats a head: acc, then (m, l), padded to keep
// the rows 16-byte aligned), and 2 * STAGES + 1 mbarriers
template <typename T, int D>
constexpr int smem_bytes(int g_n, int n_split) {
  return STAGES * Cfg<T, D>::STAGE_BYTES + NCW * g_n * (D + 4) * 4 +
         (n_split - 1) * g_n * (D + 4) * 4 + (2 * STAGES + 1) * 8;
}

// E contiguous elements at p (16-byte aligned) as floats
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* p, float (&f)[E]) {
  constexpr int CH = 16 / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < E / CH; ++c) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[c];
    if constexpr (sizeof(T) == 4) {
      f[4 * c] = __uint_as_float(u.x);
      f[4 * c + 1] = __uint_as_float(u.y);
      f[4 * c + 2] = __uint_as_float(u.z);
      f[4 * c + 3] = __uint_as_float(u.w);
    } else {
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        f[8 * c + 2 * i] = x.x;
        f[8 * c + 2 * i + 1] = x.y;
      }
    }
  }
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// four floats to four elements of T at p
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const uint2 u = make_uint2(hopper::pack_bf16(x.x, x.y), hopper::pack_bf16(x.z, x.w));
  *reinterpret_cast<uint2*>(p) = u;
}

// Grid (n_split, K, B), cluster (n_split, 1, 1), NT threads.  Block `split` of the cluster for
// (kv head kh, batch row b) takes keys [t_begin, t_end) of that row.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(NT) decode_attn_cluster_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, T* __restrict__ out, int t_len, int h, int g_n, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh, float scale,
    float softcap) {
  using C = Cfg<T, D>;
  constexpr int E = C::E, LPK = C::LPK, KPW = C::KPW, TK = C::TK, NJ = C::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_split = gridDim.x;
  const int split = (int)hopper::cluster_ctarank();
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  unsigned char* ring = smem;
  // the warps' partials, [NCW][g_n][D + 4]: acc[D], m, l, 2 floats of padding
  float* red = reinterpret_cast<float*>(smem + STAGES * C::STAGE_BYTES);
  // the other splits' partials, [n_split - 1][g_n * (D + 4)]: acc[g_n][D], then (m, l)[g_n];
  // a sender stores g_n * (D + 2) floats
  float* slots = red + NCW * g_n * (D + 4);
  const int slot_floats = g_n * (D + 4), sent_bytes = g_n * (D + 2) * 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + (n_split - 1) * slot_floats);
  const uint32_t full0 = hopper::smem_u32(bars), empty0 = full0 + 8 * STAGES;
  const uint32_t merge = full0 + 16 * STAGES;

  // this block's keys: the row's live keys in runs of UNIT, ups runs a split
  int live = min(pos[b] + 1, t_len);
  live = max(live, 0);
  const int units = (live + UNIT - 1) / UNIT;
  const int ups = (units + n_split - 1) / n_split;
  const int n_live = ups ? (units + ups - 1) / ups : 0;
  const int t_begin = split * ups * UNIT;
  const int t_end = min(t_begin + ups * UNIT, live);
  const bool has_keys = split < n_live;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, NT);     // every thread's copies of the stage
      hopper::mbar_init(empty0 + 8 * s, NCW);   // every warp done with it
    }
    if (split == 0) hopper::mbar_init(merge, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (split == 0 && tid == 0 && n_live > 1)
    hopper::mbar_expect_tx(merge, (n_live - 1) * sent_bytes);
  // block 0's merge barrier is initialised before any block's arrive; a sender waits on this
  // barrier before its first store into block 0
  hopper::cluster_arrive();
  if (!has_keys && split != 0) return;   // an empty split: no cache read, nothing to send

  // the ring: every thread copies its 16-byte pieces of a stage's K and V rows with cp.async
  // and arrives on the stage's full barrier when they land; a stage is refilled once every
  // warp has arrived on its empty barrier
  const int n_tiles = has_keys ? (t_end - t_begin + TK - 1) / TK : 0;
  // thread tid copies 16-byte piece tid % CHUNKS of rows tid / CHUNKS, + RSTEP, ...
  constexpr int CHUNKS = C::ROW / 16, RSTEP = NT / CHUNKS;
  static_assert(NT % CHUNKS == 0, "a row's pieces must divide the block");
  const int r0 = tid / CHUNKS, cc = tid % CHUNKS;
  const T* kb = k + b * k_sb + kh * k_sh + cc * C::CH;
  const T* vb = v + b * v_sb + kh * v_sh + cc * C::CH;
  auto fetch = [&](int i) {
    const int s = i % STAGES, t0 = t_begin + i * TK;
    const int rows = min(TK, t_end - t0);
    uint32_t kdst = hopper::smem_u32(ring + s * C::STAGE_BYTES) + r0 * C::ROW + 16 * cc;
    const T* kp = kb + (long long)(t0 + r0) * k_st;
    const T* vp = vb + (long long)(t0 + r0) * v_st;
#pragma unroll 4
    for (int r = r0; r < rows; r += RSTEP) {
      hopper::cp_async16(kdst, kp, 16);
      hopper::cp_async16(kdst + TK * C::ROW, vp, 16);
      kdst += RSTEP * C::ROW;
      kp += RSTEP * k_st;
      vp += RSTEP * v_st;
    }
    hopper::cp_async_arrive(full0 + 8 * s);
  };
  for (int i = 0; i < min(STAGES, n_tiles); ++i) fetch(i);

  // lane group grp of warp `warp` takes row j * NCW * KPW + warp * KPW + grp of each stage,
  // elements [lig * E, lig * E + E) of it
  const int grp = lane / LPK, lig = lane % LPK;
  float qr[GT][E];
  {
    const T* qb = q + ((long long)b * h + (long long)kh * g_n) * D + lig * E;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < g_n) {
        load_row<T, E>(qb + g * D, qr[g]);
#pragma unroll
        for (int e = 0; e < E; ++e) qr[g][e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
      }
    }
  }
  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // one pass over the tiles, with or without the tanh softcap (a branch taken once, outside)
  auto run = [&](auto cap) {
    constexpr bool CAP = decltype(cap)::value;
    const float inv_cap = CAP ? 1.f / softcap : 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      hopper::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const int rows = min(TK, t_end - (t_begin + i * TK));
      const T* ks = reinterpret_cast<const T*>(ring + s * C::STAGE_BYTES);
      const T* vs = ks + TK * D;
      // the NJ keys are independent: no branch between them.  A row past the tile's last
      // reads that last row (real data, never uninitialised shared memory) and is masked to
      // p = 0.
      float sc[NJ][GT];
      int row[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = j * NCW * KPW + warp * KPW + grp;
        row[j] = min(r, rows - 1);
        float kf[E];
        load_row<T, E>(ks + row[j] * D + lig * E, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float x0 = 0.f, x1 = 0.f;
#pragma unroll
          for (int e = 0; e < E; e += 2) {
            x0 = fmaf(qr[g][e], kf[e], x0);
            x1 = fmaf(qr[g][e + 1], kf[e + 1], x1);
          }
          sc[j][g] = x0 + x1;
        }
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int g = 0; g < GT; ++g) sc[j][g] += __shfl_xor_sync(0xffffffffu, sc[j][g], off);
      // fold the NJ keys in: one max and one rescale per head
      float p[NJ][GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if constexpr (CAP) sc[j][g] = tanhf(sc[j][g] * inv_cap) * softcap;
          if (j * NCW * KPW + warp * KPW + grp >= rows) sc[j][g] = NEG_INF;
        }
        float mx = m[g];
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, sc[j][g]);
        const float alpha = __expf(m[g] - mx);
        m[g] = mx;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          p[j][g] = sc[j][g] > 0.5f * NEG_INF ? __expf(sc[j][g] - mx) : 0.f;
          ps += p[j][g];
        }
        l[g] = fmaf(l[g], alpha, ps);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float vf[E];
        load_row<T, E>(vs + row[j] * D + lig * E, vf);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p[j][g], vf[e], acc[g][e]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
      if (i + STAGES < n_tiles) {
        hopper::mbar_wait(empty0 + 8 * s, (i / STAGES) & 1);
        fetch(i + STAGES);
      }
    }
  };
  if (softcap > 0.f) run(Flag<true>{});
  else run(Flag<false>{});

  // merge the lane groups of the warp (lanes lig, lig + LPK, ...)
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mg = m[g];
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    const float f = __expf(m[g] - mg);
    float lg = l[g] * f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] *= f;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      lg += __shfl_xor_sync(0xffffffffu, lg, off);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
    m[g] = mg;
    l[g] = lg;
  }
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < g_n) {
        float* w = red + (warp * g_n + g) * (D + 4);
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(w + lig * E + e) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
        if (lane == 0) {
          w[D] = m[g];
          w[D + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps; then a sender stores its split's partial into block 0's slot split - 1,
  // and block 0 merges the live splits into the output
  uint32_t leader_slot = 0, leader_merge = 0;
  if (split != 0) {
    leader_slot = hopper::map_to_rank(hopper::smem_u32(slots + (split - 1) * slot_floats), 0);
    leader_merge = hopper::map_to_rank(merge, 0);
    hopper::cluster_wait();
  } else if (n_live > 1) {
    hopper::mbar_wait_cluster(merge, 0);
  }
  for (int x = tid; x < g_n * D / 4; x += NT) {
    const int g = (4 * x) / D, d = (4 * x) % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NCW; ++w) mx = fmaxf(mx, red[(w * g_n + g) * (D + 4) + D]);
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      const float* r = red + (w * g_n + g) * (D + 4);
      const float f = __expf(r[D] - mx);
      lsum = fmaf(r[D + 1], f, lsum);
      const float4 y = *reinterpret_cast<const float4*>(r + d);
      a.x = fmaf(y.x, f, a.x);
      a.y = fmaf(y.y, f, a.y);
      a.z = fmaf(y.z, f, a.z);
      a.w = fmaf(y.w, f, a.w);
    }
    if (split != 0) {
      hopper::st_async(leader_slot + 4 * (g * D + d), a, leader_merge);
      if (d == 0) hopper::st_async(leader_slot + 4 * (g_n * D + 2 * g), make_float2(mx, lsum),
                                   leader_merge);
      continue;
    }
    float mt = mx;
    for (int s = 1; s < n_live; ++s) mt = fmaxf(mt, slots[(s - 1) * slot_floats + g_n * D + 2 * g]);
    const float f0 = __expf(mx - mt);
    float lt = lsum * f0;
    a.x *= f0;
    a.y *= f0;
    a.z *= f0;
    a.w *= f0;
    for (int s = 1; s < n_live; ++s) {
      const float* r = slots + (s - 1) * slot_floats;
      const float f = __expf(r[g_n * D + 2 * g] - mt);
      lt = fmaf(r[g_n * D + 2 * g + 1], f, lt);
      const float4 y = *reinterpret_cast<const float4*>(r + g * D + d);
      a.x = fmaf(y.x, f, a.x);
      a.y = fmaf(y.y, f, a.y);
      a.z = fmaf(y.z, f, a.z);
      a.w = fmaf(y.w, f, a.w);
    }
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    store4(out + ((long long)b * h + (long long)kh * g_n + g) * D + d,
           make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

template <typename T, int D, int GT>
int launch(const void* q, const void* k, const void* v, const void* pos, void* out, int b,
           int t_len, int h, int kv_heads, long long k_sb, long long k_st, long long k_sh,
           long long v_sb, long long v_st, long long v_sh, int n_split, float scale,
           float softcap, cudaStream_t st) {
  const int g_n = h / kv_heads;
  const int smem = smem_bytes<T, D>(g_n, n_split);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = decode_attn_cluster_kernel<T, D, GT>;
  static const cudaError_t attr = [&] {
    cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          SMEM_LIMIT);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return rc;
  }();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, kv_heads, b);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<const int*>(pos),
                                 static_cast<T*>(out), t_len, h, g_n, k_sb, k_st, k_sh, v_sb,
                                 v_st, v_sh, scale, softcap);
}

template <typename T, int D>
int dispatch_g(int g_n, const void* q, const void* k, const void* v, const void* pos, void* out,
               int b, int t_len, int h, int kv_heads, long long k_sb, long long k_st,
               long long k_sh, long long v_sb, long long v_st, long long v_sh, int n_split,
               float scale, float softcap, cudaStream_t st) {
#define DECODE_ATTENTION_G(GG)                                                                \
  return launch<T, D, GG>(q, k, v, pos, out, b, t_len, h, kv_heads, k_sb, k_st, k_sh, v_sb, \
                          v_st, v_sh, n_split, scale, softcap, st);
  if (g_n <= 1) DECODE_ATTENTION_G(1)
  if (g_n <= 2) DECODE_ATTENTION_G(2)
  if (g_n <= 4) DECODE_ATTENTION_G(4)
  DECODE_ATTENTION_G(8)
#undef DECODE_ATTENTION_G
}

template <typename T>
int dispatch_d(int d, int g_n, const void* q, const void* k, const void* v, const void* pos,
               void* out, int b, int t_len, int h, int kv_heads, long long k_sb, long long k_st,
               long long k_sh, long long v_sb, long long v_st, long long v_sh, int n_split,
               float scale, float softcap, cudaStream_t st) {
#define DECODE_ATTENTION_CASE(DD)                                                          \
  case DD:                                                                                 \
    return dispatch_g<T, DD>(g_n, q, k, v, pos, out, b, t_len, h, kv_heads, k_sb, k_st,   \
                             k_sh, v_sb, v_st, v_sh, n_split, scale, softcap, st);
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

template <typename T>
int smem_d(int d, int g_n, int n_split) {
  switch (d) {
    case 16: return smem_bytes<T, 16>(g_n, n_split);
    case 32: return smem_bytes<T, 32>(g_n, n_split);
    case 64: return smem_bytes<T, 64>(g_n, n_split);
    case 128: return smem_bytes<T, 128>(g_n, n_split);
    case 256: return smem_bytes<T, 256>(g_n, n_split);
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory a block takes at this type (0 = float32, 1 = bfloat16), head dim, G
// and n_split; -1 for a head dim the kernel does not take.  The wrapper picks n_split so that
// it stays within SMEM_LIMIT.
extern "C" int decode_attention_smem_bytes(int dtype, int d, int g_n, int n_split) {
  return dtype == 0 ? smem_d<float>(d, g_n, n_split) : smem_d<__nv_bfloat16>(d, g_n, n_split);
}

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means none.  Strides are in elements.
// Returns the launch's error (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int dtype, int b, int t_len,
                                       int h, int kv_heads, int d, long long k_sb,
                                       long long k_st, long long k_sh, long long v_sb,
                                       long long v_st, long long v_sh, int n_split, float scale,
                                       float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > MAX_SPLIT || kv_heads < 1 || h % kv_heads ||
      h / kv_heads > 8 || b < 1 || t_len < 1)
    return (int)cudaErrorInvalidValue;
  const int g_n = h / kv_heads;
  if (dtype == 0)
    return dispatch_d<float>(d, g_n, q, k, v, pos, out, b, t_len, h, kv_heads, k_sb, k_st,
                             k_sh, v_sb, v_st, v_sh, n_split, scale, softcap, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, g_n, q, k, v, pos, out, b, t_len, h, kv_heads, k_sb,
                                     k_st, k_sh, v_sb, v_st, v_sh, n_split, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}