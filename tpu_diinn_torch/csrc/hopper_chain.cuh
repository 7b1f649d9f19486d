// Hopper building blocks of the fused DIINN mode-3 decoder (sm_90a), and
// the decoder chain's forward on them. Included by decoder_fused.cuh (the
// forward kernels) and decoder_bwd.cuh (the backward, which recomputes the
// forward with the same routine, so both compute bit-identical q).
//
// The chain over a tile of kTileM HR queries (z is the stacked LR feature
// map (B, H_in, W_in, L*hidden) with the kq biases folded in; each query
// reads the z row of its nearest-exact LR pixel):
//
//   k_0 = relu(z_0);               a_0 = syn @ W0 + b0
//   k_i = relu(q_{i-1} @ Wkq_i + z_i);  a_i = q_{i-1} @ Wq_i + bq_i
//   q_i = k_i * sin(a_i)                              i = 0..L-1
//
// The products run on the tensor cores in one of two precision policies
// (below): Tf32, wgmma TF32 in the 3xTF32 scheme, which keeps fp32-level
// error, with A (the q tile) fp32 in shared memory and split in registers;
// or Bf16, the JAX package's bf16 mode, with z, the weights and the q tile
// in bf16 (q rounded to nearest once per layer) and one wgmma BF16 product
// per k16 step summing in fp32. Either way B ([Wkq | Wq], laid out once per
// call by the wrapper in wgmma's shared-memory layout:
// kernels/decoder_fused.py, mma_b_slabs) streams from global memory by TMA
// bulk copies into an mbarrier-guarded ring, and everything elementwise
// (z widened, relu, sine, k * sin) runs in fp32.
//
// The polynomial sine and cosine are core/fastmath.py's (_poly_sin,
// _poly_sincos): the same coefficients and Cody-Waite constants, copied
// here.

#pragma once

#include <cstdint>
#include <type_traits>

namespace hopper_chain {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kTileM = 64;         // HR queries per CTA
constexpr int kStages = 4;         // weight slabs in flight a warpgroup

__device__ __forceinline__ float poly_sin(float x) {
  const float n = rintf(x * 0.15915494309189535f);  // round half to even
  const float r = x - n * 6.2831855f - n * -1.7484555e-07f;
  const float r2 = r * r;
  float acc = -2.0362212148e-08f;
  acc = acc * r2 + 2.6997138288e-06f;
  acc = acc * r2 + -1.9808632624e-04f;
  acc = acc * r2 + 8.3324029612e-03f;
  acc = acc * r2 + -1.6666552631e-01f;
  acc = acc * r2 + 9.9999959990e-01f;
  return r * acc;
}

__device__ __forceinline__ void poly_sincos(float x, float& s, float& c) {
  const float n = rintf(x * 0.15915494309189535f);  // round half to even
  const float r = x - n * 6.2831855f - n * -1.7484555e-07f;
  const float r2 = r * r;
  float as = -2.0362212148e-08f;
  as = as * r2 + 2.6997138288e-06f;
  as = as * r2 + -1.9808632624e-04f;
  as = as * r2 + 8.3324029612e-03f;
  as = as * r2 + -1.6666552631e-01f;
  as = as * r2 + 9.9999959990e-01f;
  s = r * as;
  float ac = 1.7066625985e-09f;
  ac = ac * r2 + -2.7023758023e-07f;
  ac = ac * r2 + 2.4763353977e-05f;
  ac = ac * r2 + -1.3887438022e-03f;
  ac = ac * r2 + 4.1666391842e-02f;
  ac = ac * r2 + -4.9999978455e-01f;
  ac = ac * r2 + 9.9999995963e-01f;
  c = ac;
}

// 16-byte global -> shared copy; asynchronous on sm_80 and later.
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#else
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
  dst[3] = src[3];
#endif
}

__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most `kPending` committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void async_wait() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
#endif
}

// ---------------------------------------------------------------------------
// 3xTF32. Each fp32 operand x is split into x_hi (x rounded to TF32) and
// x_lo = x - x_hi, and a*b is summed as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// (small terms first). A tensor-core product rounds its sum with the
// accumulator toward zero, so a long chain of products into one
// accumulator drifts by up to an ulp of the accumulator per product; the
// kernels sum a few products in a fresh accumulator and add that to the
// running sum with fp32 adds (round to nearest). wgmma's register A
// fragment for one warp's 16 rows (PTX ISA, .tf32, k8), lane = 4 gid +
// tig: a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8,
// tig + 4); its fp32 accumulator, n8 block i: d[4i] (gid, 8i + 2 tig),
// d[4i + 1] (gid, 8i + 2 tig + 1), d[4i + 2] and d[4i + 3] the same at row
// gid + 8.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t f2u(float x) {
  union {
    float f;
    uint32_t u;
  } v;
  v.f = x;
  return v.u;
}

__device__ __forceinline__ float u2f(uint32_t x) {
  union {
    float f;
    uint32_t u;
  } v;
  v.u = x;
  return v.f;
}

// x rounded to TF32 (10 mantissa bits; nearest, ties away from zero) and
// the remainder x - hi, exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
#if defined(__CUDA_ARCH__)
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
#else
  hi = (f2u(x) + 0x1000u) & 0xffffe000u;
#endif
  lo = f2u(x - u2f(hi));
}

// ---------------------------------------------------------------------------
// bf16: a value is kept as its 16 raw bits (uint16_t), the upper half of
// its fp32 pattern. A pair packs into 32 bits with the lower k (or column)
// in the low half, as wgmma's A fragment holds it: for one warp's 16 rows
// (PTX ISA, .bf16, k16), a0 (gid, 2 tig .. 2 tig + 1), a1 (gid + 8, the
// same k), a2 (gid, 2 tig + 8 ..), a3 (gid + 8, 2 tig + 8 ..).
// ---------------------------------------------------------------------------

// x rounded to bf16, to nearest even (as a cast to bf16 rounds).
__device__ __forceinline__ uint16_t bf16_bits(float x) {
#if defined(__CUDA_ARCH__)
  uint16_t h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return h;
#else
  const uint32_t u = f2u(x);
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
#endif
}

__device__ __forceinline__ float bf16_float(uint32_t h) {
  return u2f(h << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return bf16_float(bf16_bits(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

// The A fragment at (r0, k0) of a row-major fp32 tile in shared memory
// (stride kLd), split.
template <int kLd>
__device__ __forceinline__ void load_a_rows(const float* a, int r0, int k0,
                                            int gid, int tig, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const float* p = a + (r0 + gid) * kLd + k0 + tig;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * kLd], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * kLd + 4], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous units for the chain kernels: TMA bulk copies into
// an mbarrier-guarded ring, and wgmma with A from registers and B from
// shared memory. Off the card a host test harness provides them.
// ---------------------------------------------------------------------------

#if !defined(__CUDACC__)
void host_wgmma_tf32(float* d, int n, const uint32_t (&a)[4], const float* b,
                     bool accumulate);
void host_wgmma_bf16(float* d, int n, const uint32_t (&a)[4],
                     const uint16_t* b, bool accumulate);
void host_mbar_init(uint64_t* bar, int count);
void host_mbar_wait(uint64_t* bar, uint32_t parity);
void host_mbar_arrive(uint64_t* bar);
void host_bulk_load(void* dst, const void* src, uint32_t bytes,
                    uint64_t* bar);
#endif

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// wgmma's B descriptor for a K-major tile without swizzle: core matrices
// of 8 rows x 16 B (128 contiguous bytes: 4 TF32 or 8 bf16 values of k),
// the two k halves of a k step (k8 in TF32, k16 in bf16) 128 B apart
// (leading byte offset), n8 groups 256 B apart (stride byte offset).
// mma_b_slabs in the wrapper writes the weights so.
__device__ __forceinline__ uint64_t b_desc(const void* b) {
#if defined(__CUDA_ARCH__)
  const uint32_t a = smem_u32(b);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
#else
  (void)b;
  return 0;
#endif
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#elif !defined(__CUDACC__)
  host_mbar_init(bar, count);
#endif
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#if defined(__CUDA_ARCH__)
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
#elif !defined(__CUDACC__)
  host_mbar_wait(bar, parity);
#endif
}

// The primitives below keep branches out of the code around wgmma: a
// branch there (as a C++ spin loop or `if (lane == 0)`) makes ptxas
// serialize the wgmmas (its warning C7520). The conditions are predicates
// inside the asm, the waits' loops inside their asm.

// One arrival on `bar` where `pred` holds (its phase completes with the
// count it was initialised with).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
#elif !defined(__CUDACC__)
  if (pred) host_mbar_arrive(bar);
#endif
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait_loop(uint64_t* bar,
                                               uint32_t parity) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
#elif !defined(__CUDACC__)
  host_mbar_wait(bar, parity);
#endif
}

// Give this warpgroup's registers back (kDec) or take more (kInc), as
// setmaxnreg: the producer warpgroup needs few, the consumers many.
template <int kRegs>
__device__ __forceinline__ void set_max_regs_dec() {
#if defined(__CUDA_ARCH__)
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
#endif
}

template <int kRegs>
__device__ __forceinline__ void set_max_regs_inc() {
#if defined(__CUDA_ARCH__)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
#endif
}

// The thread's warpgroup, known to the compiler to be the same across the
// warp (a shuffle from lane 0), so that a branch on it does not diverge.
__device__ __forceinline__ int warpgroup_uniform() {
#if defined(__CUDA_ARCH__)
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
#else
  return static_cast<int>(threadIdx.x) / 128;
#endif
}

// `bytes` (a multiple of 16) from global src to shared dst by the TMA
// unit; bar's current phase completes when they have landed. One thread
// issues it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
#elif !defined(__CUDACC__)
  host_bulk_load(dst, src, bytes, bar);
#endif
}

// Generic-proxy writes to shared memory, then async-proxy (TMA) writes to
// the same bytes: order them.
__device__ __forceinline__ void fence_proxy_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

// Wait until at most kPending committed groups of wgmma are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
#endif
}

// Keep the compiler from touching d across an asynchronous wgmma: its
// value stays in its registers (a wgmma writes d, or reads d as A, until
// the wait).
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
#endif
}

template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[kN]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
#endif
}

// One warpgroup's D (64 x N) = A (64 x 8) * B (8 x N) [+ D] in TF32, A from
// registers (the m16n8k8 A fragment of each warp's 16 rows), B from shared
// memory through b_desc. The _zero forms start from D = 0.
__device__ __forceinline__ void wgmma_m64n16k8_zero(float (&d)[8],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 16, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n16k8_acc(float (&d)[8],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 16, a, b, true);
#endif
}

__device__ __forceinline__ void wgmma_m64n32k8_zero(float (&d)[16],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 32, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n32k8_acc(float (&d)[16],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 32, a, b, true);
#endif
}

__device__ __forceinline__ void wgmma_m64n64k8_zero(float (&d)[32],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 64, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n64k8_acc(float (&d)[32],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 64, a, b, true);
#endif
}

__device__ __forceinline__ void wgmma_m64n128k8_zero(float (&d)[64],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 128, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n128k8_acc(float (&d)[64],
    const uint32_t (&a)[4], const float* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_tf32(d, 128, a, b, true);
#endif
}

template <int kN, bool kZero>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kN / 2],
                                           const uint32_t (&a)[4],
                                           const float* b) {
  if constexpr (kN == 16) {
    if constexpr (kZero) wgmma_m64n16k8_zero(d, a, b);
    else wgmma_m64n16k8_acc(d, a, b);
  } else if constexpr (kN == 32) {
    if constexpr (kZero) wgmma_m64n32k8_zero(d, a, b);
    else wgmma_m64n32k8_acc(d, a, b);
  } else if constexpr (kN == 64) {
    if constexpr (kZero) wgmma_m64n64k8_zero(d, a, b);
    else wgmma_m64n64k8_acc(d, a, b);
  } else {
    static_assert(kN == 128, "wgmma N");
    if constexpr (kZero) wgmma_m64n128k8_zero(d, a, b);
    else wgmma_m64n128k8_acc(d, a, b);
  }
}

// One warpgroup's D (64 x N) = A (64 x 16) * B (16 x N) [+ D] in bf16 with
// fp32 sums, A from registers (the bf16 fragment above), B from shared
// memory through b_desc, K-major (imm-trans-b 0).
__device__ __forceinline__ void wgmma_m64n16k16_bf16_zero(float (&d)[8],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 16, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n16k16_bf16_acc(float (&d)[8],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 16, a, b, true);
#endif
}

__device__ __forceinline__ void wgmma_m64n32k16_bf16_zero(float (&d)[16],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 32, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n32k16_bf16_acc(float (&d)[16],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 32, a, b, true);
#endif
}

__device__ __forceinline__ void wgmma_m64n64k16_bf16_zero(float (&d)[32],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 64, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n64k16_bf16_acc(float (&d)[32],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 64, a, b, true);
#endif
}

__device__ __forceinline__ void wgmma_m64n128k16_bf16_zero(float (&d)[64],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(0));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 128, a, b, false);
#endif
}

__device__ __forceinline__ void wgmma_m64n128k16_bf16_acc(float (&d)[64],
    const uint32_t (&a)[4], const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
        "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_bf16(d, 128, a, b, true);
#endif
}

template <int kN, bool kZero>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kN / 2],
                                           const uint32_t (&a)[4],
                                           const uint16_t* b) {
  if constexpr (kN == 16) {
    if constexpr (kZero) wgmma_m64n16k16_bf16_zero(d, a, b);
    else wgmma_m64n16k16_bf16_acc(d, a, b);
  } else if constexpr (kN == 32) {
    if constexpr (kZero) wgmma_m64n32k16_bf16_zero(d, a, b);
    else wgmma_m64n32k16_bf16_acc(d, a, b);
  } else if constexpr (kN == 64) {
    if constexpr (kZero) wgmma_m64n64k16_bf16_zero(d, a, b);
    else wgmma_m64n64k16_bf16_acc(d, a, b);
  } else {
    static_assert(kN == 128, "wgmma N");
    if constexpr (kZero) wgmma_m64n128k16_bf16_zero(d, a, b);
    else wgmma_m64n128k16_bf16_acc(d, a, b);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// ---------------------------------------------------------------------------
// Precision policies of the chain kernels: the types of z (and dz), of the
// weights (w0, wl and the B slabs) and of the A tiles in shared memory, the
// k of one wgmma step, and the product of one k step.
//
// Tf32: everything fp32; a product is three wgmma TF32 (3xTF32, above),
// and each pair of k8 steps sums in a fresh accumulator (kFresh).
// kBf16 names the precision for the code that branches on it (the
// backward's weight-gradient products and its thin sums' rounding).
// Bf16: the JAX package's bf16 mode (compute dtype bf16, parameters and
// sums fp32): z, the weights and the A tiles bf16, an A value rounded to
// nearest on its way into the tile; one wgmma BF16 per k16 step, summed
// straight into the running accumulator.
// ---------------------------------------------------------------------------
struct Tf32 {
  using Z = float;
  using W = float;
  using A = float;
  static constexpr int kK = 8;
  static constexpr int kPad = 4;       // A tile row padding, elements
  static constexpr bool kBf16 = false;
  static constexpr bool kFresh = true;
  struct Frag {
    uint32_t hi[4], lo[4];
  };
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float from_float(float x) { return x; }
  __device__ __forceinline__ static float2 load_z2(const float* p) {
    return load2(p);
  }
  __device__ __forceinline__ static void store_a2(float* p, float x,
                                                  float y) {
    store2(p, x, y);
  }
  template <int kLd>
  __device__ __forceinline__ static void load_frag(const float* a, int r0,
                                                   int k0, int gid, int tig,
                                                   Frag& f) {
    load_a_rows<kLd>(a, r0, k0, gid, tig, f.hi, f.lo);
  }
  // d (+)= a*b of one k8 step: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, b the
  // slab (hi, then lo kN * 8 floats on)
  template <int kN, bool kZero>
  __device__ __forceinline__ static void mma(float (&d)[kN / 2],
                                             const Frag& f, const float* b) {
    wgmma_tf32<kN, kZero>(d, f.lo, b);
    wgmma_tf32<kN, false>(d, f.hi, b + kN * 8);
    wgmma_tf32<kN, false>(d, f.hi, b);
  }
  __device__ __forceinline__ static void fence_frag(Frag& f) {
    fence_regs(f.hi);
    fence_regs(f.lo);
  }
};

struct Bf16 {
  using Z = uint16_t;
  using W = uint16_t;
  using A = uint16_t;
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  static constexpr bool kBf16 = true;
  static constexpr bool kFresh = false;
  struct Frag {
    uint32_t a[4];
  };
  __device__ __forceinline__ static float round(float x) {
    return round_bf16(x);
  }
  __device__ __forceinline__ static float to_float(uint16_t h) {
    return bf16_float(h);
  }
  __device__ __forceinline__ static uint16_t from_float(float x) {
    return bf16_bits(x);
  }
  __device__ __forceinline__ static float2 load_z2(const uint16_t* p) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(bf16_float(v & 0xffffu), bf16_float(v >> 16));
  }
  __device__ __forceinline__ static void store_a2(uint16_t* p, float x,
                                                  float y) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
  }
  template <int kLd>
  __device__ __forceinline__ static void load_frag(const uint16_t* a, int r0,
                                                   int k0, int gid, int tig,
                                                   Frag& f) {
    const uint16_t* p = a + (r0 + gid) * kLd + k0 + 2 * tig;
    f.a[0] = *reinterpret_cast<const uint32_t*>(p);
    f.a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
    f.a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    f.a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8);
  }
  template <int kN, bool kZero>
  __device__ __forceinline__ static void mma(float (&d)[kN / 2],
                                             const Frag& f,
                                             const uint16_t* b) {
    wgmma_bf16<kN, kZero>(d, f.a, b);
  }
  __device__ __forceinline__ static void fence_frag(Frag& f) {
    fence_regs(f.a);
  }
};

// How a chain CTA (the forward kernels, and the backward's chain kernel)
// splits its work: two warpgroups, warpgroup wg owns
// hidden columns [wg H/2, (wg + 1) H/2), warp w of it rows 16w..16w+15 of
// the 64-query tile. The forward product runs in kPasses passes of kJB
// columns, each one wgmma of N = kNF (the k and a columns of those j);
// the dq product is one pass of N = kND. A thread owns the accumulator
// elements of wgmma's layout: n8 block i, rows 16w + gid (+ 8), columns
// 8i + 2 tig (+ 1). Strides are in elements of the policy's types, the
// offsets (kBars .. kSmem) in bytes.
template <int kHidden, class P>
struct ChainTiling {
  static constexpr int kPasses = kHidden >= 256 ? kHidden / 128 : 1;
  static constexpr int kJB = kHidden / 2 / kPasses;
  static constexpr int kNF = 2 * kJB;
  static constexpr int kND = kHidden / 2;
  static constexpr int kLdQ = kHidden + P::kPad;       // q tile stride
  static constexpr int kLdD = 2 * kHidden + P::kPad;   // d tile stride
  static constexpr int kBars = kTileM * 8 + 2 * kTileM * 3 * 4;
  static constexpr int kHead = kBars + 2 * kStages * 8;
  // one slab: a k step's B, kN * 16 elements (Tf32: hi | lo of k8; Bf16:
  // k16)
  static constexpr int kSlabF = kNF * 16;
  static constexpr int kSlabD = kND * 16;
  static constexpr int kA = static_cast<int>(sizeof(typename P::A));
  static constexpr int kW = static_cast<int>(sizeof(typename P::W));
  // forward: [head | q tile | next q tile | rings]; the backward's
  // second half: [head | d tile | rings]. The head holds the query table
  // (z offsets, syn), the backward's g and the rings' barriers.
  static constexpr int kRingF = kHead + 2 * kTileM * kLdQ * kA;
  static constexpr int kRingD = kHead + kTileM * kLdD * kA;
  static constexpr int kEndF = kRingF + 2 * kStages * kSlabF * kW;
  static constexpr int kEndD = kRingD + 2 * kStages * kSlabD * kW;
  static constexpr int kSmem = kEndF > kEndD ? kEndF : kEndD;
  static_assert(kJB % 8 == 0 && kND % 8 == 0 && kNF <= 128, "tiling");
  static_assert(kSmem <= 232448, "shared memory");
};

// acc (the warpgroup's 64 x kN, kN/2 a thread) += A[:, 0:kK] @ B in the
// policy's products. A is in shared memory (stride kLd), loaded (and for
// Tf32 split) into registers. B's slabs (kN * 16 elements each,
// mma_b_slabs' layout) stream from global memory, slab s at slabs + s *
// slab_stride, into the warpgroup's kStages-deep ring by the TMA unit, one
// mbarrier per slot (`phase` holds each slot's parity). The k steps run in
// pairs: Tf32 sums a pair's six products in a fresh accumulator (see
// 3xTF32 above), Bf16 its two straight into acc; either waits for them
// before their slots are refilled. With kPrefetch, the warpgroup waits for
// the next pair's slabs and loads its A fragments while the current
// products run (into the other of two register sets: wgmma reads a pair's
// A until it is done; only where kK / P::kK is a multiple of 4, else the
// pairs run one after another). kK / P::kK is even.
template <class P, int kN, int kK, int kLd, bool kPrefetchAsked>
__device__ __forceinline__ void wg_product(
    float (&acc)[kN / 2], const typename P::A* a, int wrow0,
    const typename P::W* __restrict__ slabs, long long slab_stride,
    typename P::W* ring, uint64_t* bars, uint32_t& phase, bool producer,
    int lane) {
  constexpr int kSteps = kK / P::kK;
  constexpr int kSlab = kN * 16;
  constexpr uint32_t kBytes = kSlab * sizeof(typename P::W);
  static_assert(kSteps % 2 == 0 && kStages % 2 == 0, "k steps in pairs");
  constexpr bool kPrefetch = kPrefetchAsked && kSteps % 4 == 0;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  if (producer) {
    for (int s = 0; s < kStages && s < kSteps; ++s)
      bulk_load(ring + s * kSlab, slabs + s * slab_stride, kBytes, bars + s);
  }
  __syncwarp();
  typename P::Frag fr[2][2];  // [register set][k step of the pair]
  // pair s's A fragments into set b, once its slabs have landed
  auto load_pair = [&](int s, auto set) {
    constexpr int b = decltype(set)::value;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int slot = (s + u) % kStages;
      mbar_wait(bars + slot, (phase >> slot) & 1u);
      phase ^= 1u << slot;
      P::template load_frag<kLd>(a, wrow0, (s + u) * P::kK, gid, tig,
                                 fr[b][u]);
    }
  };
  // pair s's products from set b; the next pair's A into the other set
  auto product = [&](int s, auto set) {
    constexpr int b = decltype(set)::value;
    if constexpr (P::kFresh) {
      float t[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const typename P::W* bs = ring + ((s + u) % kStages) * kSlab;
        if (u == 0)
          P::template mma<kN, true>(t, fr[b][u], bs);
        else
          P::template mma<kN, false>(t, fr[b][u], bs);
      }
      wgmma_commit();
      if (kPrefetch && s + 2 < kSteps)
        load_pair(s + 2, std::integral_constant<int, 1 - b>());
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] += t[i];
    } else {
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u)
        P::template mma<kN, false>(acc, fr[b][u],
                                   ring + ((s + u) % kStages) * kSlab);
      wgmma_commit();
      if (kPrefetch && s + 2 < kSteps)
        load_pair(s + 2, std::integral_constant<int, 1 - b>());
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int u = 0; u < 2; ++u) P::fence_frag(fr[b][u]);
    }
    if (producer) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (s + u + kStages < kSteps)
          bulk_load(ring + ((s + u) % kStages) * kSlab,
                    slabs + (s + u + kStages) * slab_stride, kBytes,
                    bars + (s + u) % kStages);
    }
    __syncwarp();
  };
  using Set0 = std::integral_constant<int, 0>;
  using Set1 = std::integral_constant<int, 1>;
  if constexpr (kPrefetch) {
    load_pair(0, Set0());
    for (int s = 0; s < kSteps; s += 4) {
      product(s, Set0());
      product(s + 2, Set1());
    }
  } else {
    for (int s = 0; s < kSteps; s += 2) {
      load_pair(s, Set0());
      product(s, Set0());
    }
  }
}

// a_0 = syn @ W0 + b0 at hidden column j (syn as load_queries keeps it).
template <class P>
__device__ __forceinline__ float pre0(const float* sv,
                                      const typename P::W* w0,
                                      const float* b0, int j, int hidden) {
  return sv[0] * P::to_float(w0[j]) + sv[1] * P::to_float(w0[hidden + j]) +
         sv[2] * P::to_float(w0[2 * hidden + j]) + b0[j];
}

// Fill the tile's query table (threads 0..kTileM-1, one query each): the z
// offset of each query's nearest-exact LR pixel, read through the integer
// ratio (y / s_h, x / s_w) or the index vectors (rows[y], cols[x]), -1 past
// the ragged edge; and its syn row (zero past the edge), rounded to the
// policy's type as the product's operand. Returns the query's index, or -1
// for a thread without one or past the edge.
template <bool kWindow, class P>
__device__ __forceinline__ long long load_queries(
    long long* zoff, float* synv, const float* __restrict__ syn,
    const int* __restrict__ rows, const int* __restrict__ cols, int batch,
    int h_in, int w_in, int h_out, int w_out, int s_h, int s_w,
    long long c_all) {
  const int tid = threadIdx.x;
  if (tid >= kTileM) return -1;
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  long long qi = static_cast<long long>(blockIdx.x) * kTileM + tid;
  long long off = -1;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (qi < n_query) {
    const int x = static_cast<int>(qi % w_out);
    const long long t = qi / w_out;
    const int y = static_cast<int>(t % h_out);
    const long long b = t / h_out;
    const int ry = kWindow ? rows[y] : y / s_h;
    const int cx = kWindow ? cols[x] : x / s_w;
    off = ((b * h_in + ry) * w_in + cx) * c_all;
    const float* sp = syn + (static_cast<long long>(y) * w_out + x) * 3;
    s0 = P::round(sp[0]);
    s1 = P::round(sp[1]);
    s2 = P::round(sp[2]);
  } else {
    qi = -1;
  }
  zoff[tid] = off;
  synv[tid * 3 + 0] = s0;
  synv[tid * 3 + 1] = s1;
  synv[tid * 3 + 2] = s2;
  return qi;
}

// chain_forward's default tile hook: nothing.
struct NoTileHook {
  template <class A>
  __device__ __forceinline__ void operator()(int, const A*) const {}
};

// The chain forward over one tile, on all kThreads threads: layer 0
// elementwise, then layers 1..L-1 as [k | a] = q @ [Wkq | Wq] (wg_product,
// pass by pass as ChainTiling splits them), each pass followed by its
// epilogue k = relu(acc_k + z_i), a = acc_a + bq_i, q = k * sin(a) into the
// next q tile. wslab holds each layer's split B slabs (mma_b_slabs of
// chain_b_operands' forward operand). On entry zoff and synv hold the
// tile's queries (load_queries) and the ring's 2 * kStages barriers are
// initialised, behind a barrier. For each element pair (j, j + 1) of a
// live query m that the thread owns, layer by layer, the routine calls
// sink(layer, hh, m, j, q0, q1, k0, k1, a0, a1), where m = 16 (warp % 4) +
// gid + 8 hh, q as the tile holds it (Bf16: rounded to bf16): the backward
// stores there, the forward's sink does nothing and compiles to nothing.
// kPrefetch is wg_product's (the arithmetic is the same either way). Layer
// i's q goes to q_cur for even i, q_next for odd i (as the pointers are
// passed); dead rows are zero. Once layer i's q tile is whole (behind a
// barrier) every thread calls tile_hook(i, tile): the bf16 backward copies
// the tile out there. Returns behind a barrier.
template <class P, int kHidden, bool kPrefetch, class Sink,
          class TileHook = NoTileHook>
__device__ __forceinline__ void chain_forward(
    const long long* zoff, const float* synv,
    const typename P::Z* __restrict__ z,
    const typename P::W* __restrict__ w0, const float* __restrict__ b0,
    const typename P::W* __restrict__ wslab, const float* __restrict__ bcat,
    int n_layers, typename P::A* q_cur, typename P::A* q_next,
    typename P::W* ring, uint64_t* bars, uint32_t& phase, Sink&& sink,
    TileHook&& tile_hook = TileHook()) {
  using T = ChainTiling<kHidden, P>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wg = warp >> 2;
  const int wrow0 = (warp & 3) * 16;
  const int jw = wg * (kHidden / 2);  // the warpgroup's first column
  const bool producer = (tid & 127) == 0;

  // The epilogues load a pass's z pairs (and biases) first and
  // unconditionally (a dead row reads the call's first z row and stores
  // zero), so that the loads overlap one another rather than each waiting
  // behind a branch.
  long long zrow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long off = zoff[wrow0 + gid + 8 * hh];
    zrow[hh] = off >= 0 ? off : 0;
  }

  // layer 0 at the thread's elements of the warpgroup's kHidden/2 columns
  // (wgmma's accumulator layout for N = kHidden/2)
  {
    constexpr int kNB = T::kND / 8;
    float2 zz[kNB][2];
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        zz[i][hh] = P::load_z2(z + zrow[hh] + jw + 8 * i + 2 * tig);
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wrow0 + gid + 8 * hh;
        const int j = jw + 8 * i + 2 * tig;
        const float k0 = fmaxf(zz[i][hh].x, 0.f);
        const float k1 = fmaxf(zz[i][hh].y, 0.f);
        const float a0 = pre0<P>(synv + m * 3, w0, b0, j, kHidden);
        const float a1 = pre0<P>(synv + m * 3, w0, b0, j + 1, kHidden);
        float q0 = P::round(k0 * poly_sin(a0));
        float q1 = P::round(k1 * poly_sin(a1));
        if (zoff[m] >= 0) {
          sink(0, hh, m, j, q0, q1, k0, k1, a0, a1);
        } else {
          q0 = 0.f;
          q1 = 0.f;
        }
        P::store_a2(q_cur + m * T::kLdQ + j, q0, q1);
      }
  }
  __syncthreads();
  tile_hook(0, static_cast<const typename P::A*>(q_cur));

  for (int layer = 1; layer < n_layers; ++layer) {
    const float* bq = bcat + static_cast<long long>(layer - 1) * 2 * kHidden +
                      kHidden;
#pragma unroll 1
    for (int pass = 0; pass < T::kPasses; ++pass) {
      float acc[T::kNF / 2];
#pragma unroll
      for (int c = 0; c < T::kNF / 2; ++c) acc[c] = 0.f;
      wg_product<P, T::kNF, kHidden, T::kLdQ, kPrefetch>(
          acc, q_cur, wrow0,
          wslab + ((static_cast<long long>(layer - 1) * T::kPasses + pass) *
                       (kHidden / P::kK) * 2 + wg) * T::kSlabF,
          2LL * T::kSlabF, ring, bars, phase, producer, lane);
      // acc blocks [0, kJB/8): k columns; [kJB/8, kNF/8): a columns
      constexpr int kNB = T::kJB / 8;
      const int j0 = jw + pass * T::kJB + 2 * tig;
      float2 zz[kNB][2], bb[kNB];
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        bb[i] = load2(bq + j0 + 8 * i);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          zz[i][hh] = P::load_z2(z + zrow[hh] + layer * kHidden + j0 +
                                 8 * i);
      }
#pragma unroll
      for (int i = 0; i < kNB; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wrow0 + gid + 8 * hh;
          const int j = j0 + 8 * i;
          const int ck = 4 * i + 2 * hh;
          const int ca = 4 * (i + kNB) + 2 * hh;
          const float k0 = fmaxf(acc[ck] + zz[i][hh].x, 0.f);
          const float k1 = fmaxf(acc[ck + 1] + zz[i][hh].y, 0.f);
          const float a0 = acc[ca] + bb[i].x;
          const float a1 = acc[ca + 1] + bb[i].y;
          float q0 = P::round(k0 * poly_sin(a0));
          float q1 = P::round(k1 * poly_sin(a1));
          if (zoff[m] >= 0) {
            sink(layer, hh, m, j, q0, q1, k0, k1, a0, a1);
          } else {
            q0 = 0.f;
            q1 = 0.f;
          }
          P::store_a2(q_next + m * T::kLdQ + j, q0, q1);
        }
    }
    __syncthreads();  // the next q tile is whole; the old one is free
    tile_hook(layer, static_cast<const typename P::A*>(q_next));
    typename P::A* t = q_cur;
    q_cur = q_next;
    q_next = t;
  }
}

#if defined(__CUDACC__)
// run_fwd's and run_bwd's launcher on the card: each launch on `stream`,
// with the dynamic shared memory allowed first where it passes 48 KB.
// Returns the launch's error (0 = launched).
struct CudaLaunch {
  cudaStream_t stream;

  template <class... KArgs, class... Args>
  int operator()(void (*kernel)(KArgs...), dim3 grid, dim3 block, int smem,
                 Args... args) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, block, smem, stream>>>(args...);
    return cudaGetLastError();
  }
};
#endif

}  // namespace hopper_chain
