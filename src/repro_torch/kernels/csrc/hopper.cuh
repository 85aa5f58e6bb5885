// Hopper (sm_90a) building blocks shared by the port's kernels (K1 decode_attention, K2
// flash_attention, K3 moe_gemm, K4 rwkv6_scan): mbarriers, cp.async copies and TMA tile
// loads, thread-block cluster barriers and stores into another block's shared memory, wgmma
// shared-memory descriptors and the wgmma instructions themselves, and libcuda's
// cuTensorMapEncodeTiled looked up through the runtime.  Every tile the TMA + wgmma kernels
// (K2, K3) load is a TMA box of 64 bf16 columns (128 bytes) written with the 128-byte swizzle
// (16-byte chunk j of row r at j ^ (r & 7)), at a 1024-byte aligned address; the descriptors
// below describe exactly that layout.
//
// Included by the kernel sources with `#include "hopper.cuh"`; repro_torch.kernels.build
// passes this directory to nvcc with -I and hashes it with the sources.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarriers ----------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// make the initialised barriers visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed; a wait that never ends (a ring out
// of step) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++spins == (1u << 26)) __trap();
  } while (!done);
}
// The same wait for a warpgroup that raised its registers with setmaxnreg.inc: a trap on its
// path makes ptxas compile the whole kernel within the registers it has at entry (168 of 384
// threads), which spilled K2's D 256 consumers and serialized their wgmma.  This one gives up
// instead and returns false; the caller poisons its output (NaN), so a ring out of step
// still fails its checks and never hangs the card.
__device__ __forceinline__ bool mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++spins == (1u << 26)) return false;
  } while (!done);
  return true;
}

// The wait for a phase completed by writes from other blocks of the cluster (st_async below):
// acquire at cluster scope, so their data is visible once it returns.  Traps like mbar_wait.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++spins == (1u << 26)) __trap();
  } while (!done);
}

// ---- cp.async: 16 bytes a thread from global to shared memory, the first src_bytes of them
// read and the rest zero-filled (src_bytes 0: sixteen zero bytes, nothing read) -------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// an arrival on the mbarrier bar once all this thread's earlier cp.async copies have landed;
// the barrier's count includes it (noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// ---- thread-block clusters ----------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster arrives; wait returns once all have arrived, with
// what each did before its arrive (an mbarrier's initialisation) visible
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory location in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// stores into another block's shared memory (addresses from map_to_rank), their bytes counted
// on that block's mbarrier (also mapped), which completes its phase when all have landed
__device__ __forceinline__ void st_async(uint32_t addr, float4 x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float2 x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
      :: "r"(addr), "f"(x.x), "f"(x.y), "r"(bar) : "memory");
}

// ---- TMA tile loads: the box at coordinates (c0 innermost, ...) into shared memory at dst,
// its bytes counted on the mbarrier bar ------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in bytes.  A K-major tile
// (rows of 64 K-values, 128 bytes each): a k-step of 16 starts 32 bytes further in, 8-row
// groups are 1024 bytes apart (sbo), lbo is unused.  An MN-major tile (rows of 64 N-values,
// one row per K-value): a k-step starts 16 rows (2048 bytes) further in, 8-row groups 1024
// bytes apart (sbo), and lbo is the distance between its 64-column boxes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator (or A-operand) reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HOPPER_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_D64 \
  HOPPER_D32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_D128 \
  HOPPER_D64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_F8(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
  "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_F32(d, i) HOPPER_F8(d, i), HOPPER_F8(d, i + 8), HOPPER_F8(d, i + 16), HOPPER_F8(d, i + 24)
#define HOPPER_F64(d) HOPPER_F32(d, 0), HOPPER_F32(d, 32)
#define HOPPER_F128(d) HOPPER_F32(d, 0), HOPPER_F32(d, 32), HOPPER_F32(d, 64), HOPPER_F32(d, 96)

// d (64 x N, fp32) = (scale_d ? d : 0) + a (64 x 16) . b (16 x N), bf16 in; a and b in shared
// memory through their descriptors, a K-major, b K-major (TB 0) or MN-major (TB 1, the
// transpose bit).  The accumulator layout is wgmma's: thread (warp w of its warpgroup,
// g = lane / 4, t = lane % 4) holds d[4 j + e] at row 16 w + g + 8 (e / 2), column
// 8 j + 2 t + e % 2.
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_ss: N of 64, 128 or 256");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_D32 "}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : HOPPER_F32(d, 0)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_D64 "}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : HOPPER_F64(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HOPPER_D128 "}, "
        "%128, %129, p, 1, 1, 0, %131;\n}\n"
        : HOPPER_F128(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
}

// The same with a from registers: each thread holds 4 bf16 pairs of its warp's 16 rows in the
// layout of mma.m16n8k16's A fragment (a[0]: row g, columns 2 t, 2 t + 1; a[1]: row g + 8;
// a[2], a[3]: columns + 8).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs: N of 64, 128 or 256");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_D32 "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_D64 "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_F64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HOPPER_D128 "}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : HOPPER_F128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
}

#undef HOPPER_F128
#undef HOPPER_F64
#undef HOPPER_F32
#undef HOPPER_F8
#undef HOPPER_D128
#undef HOPPER_D64
#undef HOPPER_D32

// ---- tensor maps (host) -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime (no -lcuda at link
// time); null where libcuda has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                   cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

}  // namespace hopper
