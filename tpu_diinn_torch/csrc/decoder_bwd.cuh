// Device code of the fused DIINN mode-3 decoder backward (fp32 accuracy on
// the tensor cores, sm_90a).
//
// The VJP of the chain of decoder_fused.cuh for an upstream gradient g
// (one RGB gradient per HR query):
//
//   forward (recomputed):  k_0 = relu(z_0),   a_0 = syn @ W0 + b0
//                          k_i = relu(q_{i-1} @ Wkq_i + z_i)
//                          a_i = q_{i-1} @ Wq_i + bq_i
//                          q_i = k_i * sin(a_i)            i = 0..L-1
//   backward:              dq = g @ Wl^T
//                          dkq_i = dq * sin(a_i) * (k_i > 0)
//                          dqp_i = dq * k_i * cos(a_i)
//                          dq    = [dkq_i | dqp_i] @ [Wkq_i | Wq_i]^T
//                          dpre_0 = dq * k_0 * cos(a_0)
//                          dzt_0  = dq * sin(a_0)
//
// and the reductions over queries: dz (the adjoint of the nearest-exact
// gather, masked by z_0 > 0 on band 0), dW0 = syn^T dpre_0, db0, dWcat_i =
// q_{i-1}^T [dkq_i | dqp_i], the q half of dbcat_i (the kq half is zero:
// the kq biases are folded into z, so their gradient reaches them through
// z), dWl = q_{L-1}^T g and dbl.
//
// The Pallas backward accumulates the weight gradients and dz across a
// grid that the TPU runs in order. A CUDA grid runs in parallel, so the
// work is split into passes that each own their outputs:
//
// 1. decode_bwd_chain_kernel: per tile of kTileM queries, recompute the
//    chain and backprop it. The tile keeps q (forward) or d[kq | q]
//    (backward) in shared memory as the A operand of its products; the
//    per-query activations that the backprop and the reductions need (q_i,
//    k_i and a_i for i >= 1, d[kq | q]_i, dpre_0, dzt_0) go to a scratch
//    buffer in device memory. k_0 and a_0 are recomputed from z and syn.
// 2. fold_dz_kernel: one thread per dz element sums the queries that read
//    its LR pixel. Nearest-exact indices are non-decreasing, so those
//    queries are one HR row range times one HR column range; each element
//    has one writer and no atomics are needed.
// 3. wgrad_kernel (dWcat, dbcat) and thin_kernel (dW0, db0, dWl, dbl):
//    each CTA reduces one split of kSplitRows queries into its own slice
//    of a partial buffer; reduce_kernel then sums the splits in a fixed
//    order. The weight gradients are deterministic.
//
// Products (the recomputed q @ [Wkq | Wq], dq = d @ [Wkq | Wq]^T and the
// weight gradient q^T d) run on the tensor cores as wgmma TF32 in the
// 3xTF32 scheme (below), which keeps fp32-level error. The chain's weights
// come split from the wrapper in wgmma's shared-memory B layout
// (kernels/decoder_fused.py, mma_b_slabs) and stream in by TMA bulk copies
// into an mbarrier-guarded ring; the activations are split in registers
// as wgmma's A. The weight-gradient kernel splits both of its operands
// itself.
//
// The polynomial sine and cosine are core/fastmath.py's (_poly_sincos):
// the same coefficients and Cody-Waite constants, copied here.

#pragma once

#include <cstdint>
#include <type_traits>

#include "decoder_fused.cuh"

namespace decoder_bwd {

using decoder_fused::async_commit;
using decoder_fused::async_wait;
using decoder_fused::copy16_async;
using decoder_fused::kThreads;
using decoder_fused::kTileM;

constexpr int kStages = 4;         // weight slabs in flight a warpgroup (chain)
constexpr int kSplitRows = 2048;   // queries per weight-gradient split
constexpr int kSliceM = 32;        // queries per wgrad shared-memory stage
constexpr int kWgradStages = 3;
constexpr int kThinThreads = 256;
constexpr int kThinWarps = kThinThreads / 32;
constexpr int kThinSmem = kThinWarps * 5 * 32 * 4;

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

// Where each piece of the backward lives, in floats. Per query the chain
// stores q_i (hidden each, i = 0..L-1), k_i and a_i (hidden each, i =
// 1..L-1), d[kq | q]_i (2 * hidden, i = 1..L-1), dpre_0 and dzt_0. The
// weight gradients are one flat vector [dw0 (3H) | db0 (H) | dwcat ((L-1)
// H 2H) | dbcat ((L-1) 2H) | dwl (3H) | dbl (3)], and the partial buffer
// holds one such vector per split.
struct Plan {
  long long n_query;
  int n_split;
  long long n_grad;
  long long o_w0, o_b0, o_wcat, o_bcat, o_wl, o_bl;
  long long s_q, s_k, s_a, s_db, s_p0, s_z0, s_part, s_total;

  __host__ __device__ Plan(long long m, int hidden, int n_layers) {
    const long long h = hidden;
    const long long l1 = n_layers - 1;
    n_query = m;
    n_split = static_cast<int>((m + kSplitRows - 1) / kSplitRows);
    o_w0 = 0;
    o_b0 = o_w0 + 3 * h;
    o_wcat = o_b0 + h;
    o_bcat = o_wcat + l1 * h * 2 * h;
    o_wl = o_bcat + l1 * 2 * h;
    o_bl = o_wl + 3 * h;
    n_grad = o_bl + 3;
    const long long layer = m * h;
    s_q = 0;
    s_k = s_q + n_layers * layer;
    s_a = s_k + l1 * layer;
    s_db = s_a + l1 * layer;
    s_p0 = s_db + l1 * 2 * layer;
    s_z0 = s_p0 + layer;
    s_part = s_z0 + layer;
    s_total = s_part + static_cast<long long>(n_split) * n_grad;
  }
};

// ---------------------------------------------------------------------------
// Hopper's asynchronous units for the chain kernel: TMA bulk copies into
// an mbarrier-guarded ring, and wgmma with A from registers and B from
// shared memory. Off the card a host test harness provides them.
// ---------------------------------------------------------------------------

#if !defined(__CUDACC__)
void host_wgmma_tf32(float* d, int n, const uint32_t (&a)[4], const float* b,
                     bool accumulate);
void host_mbar_init(uint64_t* bar, int count);
void host_mbar_wait(uint64_t* bar, uint32_t parity);
void host_bulk_load(void* dst, const void* src, uint32_t bytes,
                    uint64_t* bar);
#endif

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// wgmma's B descriptor for a K-major tile without swizzle: core matrices
// of 8 rows x 16 B (128 contiguous bytes), the two k halves of a k8 step
// 128 B apart (leading byte offset), n8 groups 256 B apart (stride byte
// offset). mma_b_slabs in the wrapper writes the weights so.
__device__ __forceinline__ uint64_t b_desc(const float* b) {
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

// `bytes` (a multiple of 16) from global src to shared dst by the TMA
// unit; bar's current phase completes when they have landed. One thread
// issues it.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
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

__device__ __forceinline__ void wgmma_commit_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#endif
}

// Keep the compiler from touching d across an asynchronous wgmma.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// How the chain CTA splits its work: two warpgroups, warpgroup wg owns
// hidden columns [wg H/2, (wg + 1) H/2), warp w of it rows 16w..16w+15 of
// the 64-query tile. The forward product runs in kPasses passes of kJB
// columns, each one wgmma of N = kNF (the k and a columns of those j);
// the dq product is one pass of N = kND. A thread owns the accumulator
// elements of wgmma's layout: n8 block i, rows 16w + gid (+ 8), columns
// 8i + 2 tig (+ 1).
template <int kHidden>
struct ChainTiling {
  static constexpr int kPasses = kHidden >= 256 ? kHidden / 128 : 1;
  static constexpr int kJB = kHidden / 2 / kPasses;
  static constexpr int kNF = 2 * kJB;
  static constexpr int kND = kHidden / 2;
  static constexpr int kLdQ = kHidden + 4;       // q tile stride (floats)
  static constexpr int kLdD = 2 * kHidden + 4;   // d tile stride
  static constexpr int kBars = kTileM * 8 + 2 * kTileM * 3 * 4;
  static constexpr int kHead = kBars + 2 * kStages * 8;
  static constexpr int kSlabF = kNF * 16;        // floats: hi | lo
  static constexpr int kSlabD = kND * 16;
  // forward: [head | q tile | next q tile | rings]; backward: [head | d
  // tile | rings]
  static constexpr int kRingF = kHead + 2 * kTileM * kLdQ * 4;
  static constexpr int kRingD = kHead + kTileM * kLdD * 4;
  static constexpr int kEndF = kRingF + 2 * kStages * kSlabF * 4;
  static constexpr int kEndD = kRingD + 2 * kStages * kSlabD * 4;
  static constexpr int kSmem = kEndF > kEndD ? kEndF : kEndD;
  static_assert(kJB % 8 == 0 && kND % 8 == 0 && kNF <= 128, "tiling");
  static_assert(kSmem <= 232448, "shared memory");
};

// acc (the warpgroup's 64 x kN, kN/2 a thread) += A[:, 0:kK] @ B in
// 3xTF32. A is fp32 in shared memory (stride kLd), split in registers.
// B's split slabs (hi | lo, kN * 16 floats, mma_b_slabs' layout) stream
// from global memory, slab s at slabs + s * slab_stride, into the
// warpgroup's kStages-deep ring by the TMA unit, one mbarrier per slot
// (`phase` holds each slot's parity). Each pair of k8 steps sums its six
// products in a fresh accumulator (see 3xTF32 above) and waits for them
// before their slots are refilled; the other warpgroup's products keep
// the tensor cores busy meanwhile. kK / 8 is even.
template <int kN, int kK, int kLd>
__device__ __forceinline__ void wg_product(float (&acc)[kN / 2],
                                           const float* a, int wrow0,
                                           const float* __restrict__ slabs,
                                           long long slab_stride,
                                           float* ring, uint64_t* bars,
                                           uint32_t& phase, bool producer,
                                           int lane) {
  constexpr int kSteps = kK / 8;
  constexpr int kSlab = kN * 16;
  static_assert(kSteps % 2 == 0 && kStages % 2 == 0, "k8 steps in pairs");
  const int gid = lane >> 2;
  const int tig = lane & 3;
  if (producer) {
    for (int s = 0; s < kStages && s < kSteps; ++s)
      bulk_load(ring + s * kSlab, slabs + s * slab_stride, kSlab * 4,
                bars + s);
  }
  __syncwarp();
  for (int s = 0; s < kSteps; s += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int slot = (s + u) % kStages;
      mbar_wait(bars + slot, (phase >> slot) & 1u);
      phase ^= 1u << slot;
      load_a_rows<kLd>(a, wrow0, (s + u) * 8, gid, tig, ah[u], al[u]);
    }
    float t[kN / 2];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* b = ring + ((s + u) % kStages) * kSlab;
      if (u == 0)
        wgmma_tf32<kN, true>(t, al[u], b);
      else
        wgmma_tf32<kN, false>(t, al[u], b);
      wgmma_tf32<kN, false>(t, ah[u], b + kSlab / 2);
      wgmma_tf32<kN, false>(t, ah[u], b);
    }
    wgmma_commit_wait();
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] += t[i];
    if (producer) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (s + u + kStages < kSteps)
          bulk_load(ring + ((s + u) % kStages) * kSlab,
                    slabs + (s + u + kStages) * slab_stride, kSlab * 4,
                    bars + (s + u) % kStages);
    }
    __syncwarp();
  }
}

// a0 = syn @ W0 + b0 at hidden column j, as decoder_fused's layer 0.
__device__ __forceinline__ float pre0(const float* sv, const float* w0,
                                      const float* b0, int j, int hidden) {
  return sv[0] * w0[j] + sv[1] * w0[hidden + j] + sv[2] * w0[2 * hidden + j] +
         b0[j];
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Recompute and backprop the chain for one tile of kTileM queries.
// wslab and wtslab hold each layer's [Wkq | Wq] (H x 2H) and its
// transpose (2H x H) as split wgmma B slabs (mma_b_slabs in the wrapper).
template <int kNC, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
decode_bwd_chain_kernel(const float* __restrict__ z,
                        const float* __restrict__ syn,
                        const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const float* __restrict__ w0,
                        const float* __restrict__ b0,
                        const float* __restrict__ wslab,
                        const float* __restrict__ bcat,
                        const float* __restrict__ wl,
                        const float* __restrict__ wtslab,
                        const float* __restrict__ g,
                        float* __restrict__ scratch, int batch, int h_in,
                        int w_in, int h_out, int w_out, int s_h, int s_w,
                        int n_layers) {
  constexpr int kHidden = kNC * 32;
  using T = ChainTiling<kHidden>;
  constexpr int kNB = T::kND / 8;     // n8 blocks a thread holds in dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* zoff = reinterpret_cast<long long*>(smem_raw);
  float* synv = reinterpret_cast<float*>(smem_raw + kTileM * 8);
  float* gv = synv + kTileM * 3;
  float* q_cur = reinterpret_cast<float*>(smem_raw + T::kHead);
  float* q_next = q_cur + kTileM * T::kLdQ;
  float* dtile = q_cur;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wg = warp >> 2;
  const int wrow0 = (warp & 3) * 16;
  const int jw = wg * (kHidden / 2);  // the warpgroup's first column
  const bool producer = (tid & 127) == 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + T::kBars) +
                   wg * kStages;
  float* ring_f = reinterpret_cast<float*>(smem_raw + T::kRingF) +
                  wg * kStages * T::kSlabF;
  float* ring_d = reinterpret_cast<float*>(smem_raw + T::kRingD) +
                  wg * kStages * T::kSlabD;
  uint32_t phase = 0;
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileM;
  const long long c_all = static_cast<long long>(n_layers) * kHidden;
  const long long layer_floats = n_query * kHidden;
  const Plan plan(n_query, kHidden, n_layers);
  float* sq = scratch + plan.s_q;
  float* sk = scratch + plan.s_k;
  float* sa = scratch + plan.s_a;
  float* sdb = scratch + plan.s_db;
  float* sp0 = scratch + plan.s_p0;
  float* sz0 = scratch + plan.s_z0;

  // 1) each query's LR pixel (-1 past the ragged edge), syn and g; the
  //    rings' barriers
  if (tid < kTileM) {
    const long long qi = tile0 + tid;
    long long off = -1;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (qi < n_query) {
      const int x = static_cast<int>(qi % w_out);
      const long long t = qi / w_out;
      const int y = static_cast<int>(t % h_out);
      const long long b = t / h_out;
      const int ry = kWindow ? rows[y] : y / s_h;
      const int cx = kWindow ? cols[x] : x / s_w;
      off = ((b * h_in + ry) * w_in + cx) * c_all;
      const float* sp = syn + (static_cast<long long>(y) * w_out + x) * 3;
      s0 = sp[0];
      s1 = sp[1];
      s2 = sp[2];
      g0 = g[qi * 3 + 0];
      g1 = g[qi * 3 + 1];
      g2 = g[qi * 3 + 2];
    }
    zoff[tid] = off;
    synv[tid * 3 + 0] = s0;
    synv[tid * 3 + 1] = s1;
    synv[tid * 3 + 2] = s2;
    gv[tid * 3 + 0] = g0;
    gv[tid * 3 + 1] = g1;
    gv[tid * 3 + 2] = g2;
  }
  if (tid == 0) {
    uint64_t* all = reinterpret_cast<uint64_t*>(smem_raw + T::kBars);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(all + i, 1);
  }
  __syncthreads();

  // The thread's dq elements (wgmma's layout for N = kND): n8 block i,
  // half hh, columns j, j + 1.
#define CHAIN_FOR_DQ_PAIRS                          \
  _Pragma("unroll") for (int i = 0; i < kNB; ++i)   \
  _Pragma("unroll") for (int hh = 0; hh < 2; ++hh)

  // 2) forward, layer 0 (as decode_fwd_kernel, plus the stores)
  CHAIN_FOR_DQ_PAIRS {
    const int m = wrow0 + gid + 8 * hh;
    const int j = jw + 8 * i + 2 * tig;
    const long long off = zoff[m];
    float q0 = 0.f, q1 = 0.f;
    if (off >= 0) {
      const float2 zz = load2(z + off + j);
      q0 = fmaxf(zz.x, 0.f) *
           decoder_fused::poly_sin(pre0(synv + m * 3, w0, b0, j, kHidden));
      q1 = fmaxf(zz.y, 0.f) *
           decoder_fused::poly_sin(pre0(synv + m * 3, w0, b0, j + 1, kHidden));
      store2(sq + (tile0 + m) * kHidden + j, q0, q1);
    }
    store2(q_cur + m * T::kLdQ + j, q0, q1);
  }
  __syncthreads();

  // 3) forward, layers 1..L-1: [k | a] = q @ [Wkq | Wq] (+ z_i, + bq_i),
  //    pass by pass into the next q tile
  for (int layer = 1; layer < n_layers; ++layer) {
    const float* bq = bcat + static_cast<long long>(layer - 1) * 2 * kHidden +
                      kHidden;
    const long long lq = layer * layer_floats;
    const long long lka = (layer - 1) * layer_floats;
#pragma unroll 1
    for (int pass = 0; pass < T::kPasses; ++pass) {
      float acc[T::kNF / 2];
#pragma unroll
      for (int c = 0; c < T::kNF / 2; ++c) acc[c] = 0.f;
      wg_product<T::kNF, kHidden, T::kLdQ>(
          acc, q_cur, wrow0,
          wslab + ((static_cast<long long>(layer - 1) * T::kPasses + pass) *
                       (kHidden / 8) * 2 + wg) * T::kSlabF,
          2LL * T::kSlabF, ring_f, bars, phase, producer, lane);
      // acc blocks [0, kJB/8): k columns; [kJB/8, kNF/8): a columns
#pragma unroll
      for (int i = 0; i < T::kJB / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wrow0 + gid + 8 * hh;
          const int j = jw + pass * T::kJB + 8 * i + 2 * tig;
          const long long off = zoff[m];
          float q0 = 0.f, q1 = 0.f;
          if (off >= 0) {
            const float2 zz = load2(z + off + layer * kHidden + j);
            const float2 bb = load2(bq + j);
            const int ck = 4 * i + 2 * hh;
            const int ca = 4 * (i + T::kJB / 8) + 2 * hh;
            const float k0 = fmaxf(acc[ck] + zz.x, 0.f);
            const float k1 = fmaxf(acc[ck + 1] + zz.y, 0.f);
            const float a0 = acc[ca] + bb.x;
            const float a1 = acc[ca + 1] + bb.y;
            q0 = k0 * decoder_fused::poly_sin(a0);
            q1 = k1 * decoder_fused::poly_sin(a1);
            const long long at = (tile0 + m) * kHidden + j;
            store2(sq + lq + at, q0, q1);
            store2(sk + lka + at, k0, k1);
            store2(sa + lka + at, a0, a1);
          }
          store2(q_next + m * T::kLdQ + j, q0, q1);
        }
    }
    __syncthreads();  // the next q tile is whole; the old one is free
    float* t = q_cur;
    q_cur = q_next;
    q_next = t;
  }

  // 4) dq = g @ Wl^T at the thread's elements (registers from here on)
  float dq[T::kND / 2];
  CHAIN_FOR_DQ_PAIRS {
    const int m = wrow0 + gid + 8 * hh;
    const int j = jw + 8 * i + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      dq[4 * i + 2 * hh + e] = gv[m * 3 + 0] * wl[(j + e) * 3 + 0] +
                               gv[m * 3 + 1] * wl[(j + e) * 3 + 1] +
                               gv[m * 3 + 2] * wl[(j + e) * 3 + 2];
  }
  // the d tile and the dq rings overlap the forward's q tiles, written by
  // plain stores; the rings are written by the TMA unit from here on
  fence_proxy_async();

  // 5) layers L-1..1: d[kq | q] elementwise into the d tile, then dq = d @
  //    [Wkq | Wq]^T (K = 2H). The forward's last barrier ended every use
  //    of the q tiles.
  for (int layer = n_layers - 1; layer >= 1; --layer) {
    const long long lka = (layer - 1) * layer_floats;
    float* db_layer = sdb + (layer - 1) * 2 * layer_floats;
    // k and a come from the same scratch buffer the loop stores d to, so
    // the compiler keeps each load behind the stores before it: load four
    // n8 blocks' pairs first, then compute and store.
    constexpr int kChunk = kNB < 4 ? kNB : 4;
#pragma unroll
    for (int i0 = 0; i0 < kNB; i0 += kChunk) {
      float2 kk[kChunk][2], aa[kChunk][2];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wrow0 + gid + 8 * hh;
          const long long at =
              (tile0 + m) * kHidden + jw + 8 * (i0 + i) + 2 * tig;
          const bool live = zoff[m] >= 0;
          kk[i][hh] = live ? load2(sk + lka + at) : make_float2(0.f, 0.f);
          aa[i][hh] = live ? load2(sa + lka + at) : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wrow0 + gid + 8 * hh;
          const int j = jw + 8 * (i0 + i) + 2 * tig;
          const float kv[2] = {kk[i][hh].x, kk[i][hh].y};
          const float av[2] = {aa[i][hh].x, aa[i][hh].y};
          float dk[2], dp[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s, co;
            poly_sincos(av[e], s, co);
            const float d = dq[4 * (i0 + i) + 2 * hh + e];
            dk[e] = kv[e] > 0.f ? d * s : 0.f;
            dp[e] = (d * kv[e]) * co;
          }
          if (zoff[m] >= 0) {
            float* dst = db_layer + (tile0 + m) * 2 * kHidden + j;
            store2(dst, dk[0], dk[1]);
            store2(dst + kHidden, dp[0], dp[1]);
          }
          store2(dtile + m * T::kLdD + j, dk[0], dk[1]);
          store2(dtile + m * T::kLdD + kHidden + j, dp[0], dp[1]);
        }
    }
#pragma unroll
    for (int c = 0; c < T::kND / 2; ++c) dq[c] = 0.f;
    __syncthreads();  // publish the d tile
    wg_product<T::kND, 2 * kHidden, T::kLdD>(
        dq, dtile, wrow0,
        wtslab + (static_cast<long long>(layer - 1) * (2 * kHidden / 8) * 2 +
                  wg) * T::kSlabD,
        2LL * T::kSlabD, ring_d, bars, phase, producer, lane);
    __syncthreads();  // every warpgroup has read the d tile
  }

  // 6) layer 0: dpre_0 and dzt_0 (masked by z_0 > 0 after the fold), with
  //    k_0 and a_0 recomputed
  CHAIN_FOR_DQ_PAIRS {
    const int m = wrow0 + gid + 8 * hh;
    const int j = jw + 8 * i + 2 * tig;
    const long long off = zoff[m];
    if (off < 0) continue;
    const float2 zz = load2(z + off + j);
    const float kv[2] = {fmaxf(zz.x, 0.f), fmaxf(zz.y, 0.f)};
    float p0[2], d0[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s, co;
      poly_sincos(pre0(synv + m * 3, w0, b0, j + e, kHidden), s, co);
      const float d = dq[4 * i + 2 * hh + e];
      p0[e] = (d * kv[e]) * co;
      d0[e] = d * s;
    }
    const long long at = (tile0 + m) * kHidden + j;
    store2(sp0 + at, p0[0], p0[1]);
    store2(sz0 + at, d0[0], d0[1]);
  }
#undef CHAIN_FOR_DQ_PAIRS
}

// First i in [0, n) with v[i] >= key, for non-decreasing v.
__device__ __forceinline__ int lower_bound(const int* __restrict__ v, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// dz[b, r, c, ch]: the sum of the chain's per-query dz over the queries
// that read LR pixel (b, r, c); band 0 is masked by z_0 > 0.
template <bool kWindow>
__global__ void __launch_bounds__(256)
fold_dz_kernel(const float* __restrict__ z, const int* __restrict__ rows,
               const int* __restrict__ cols,
               const float* __restrict__ scratch, float* __restrict__ dz,
               int batch, int h_in, int w_in, int h_out, int w_out, int s_h,
               int s_w, int hidden, int n_layers) {
  const long long c_all = static_cast<long long>(n_layers) * hidden;
  const long long total = static_cast<long long>(batch) * h_in * w_in * c_all;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  const Plan plan(n_query, hidden, n_layers);
  const int ch = static_cast<int>(idx % c_all);
  const long long pix = idx / c_all;
  const int c = static_cast<int>(pix % w_in);
  const long long t = pix / w_in;
  const int r = static_cast<int>(t % h_in);
  const long long b = t / h_in;
  const int band = ch / hidden;
  const int j = ch - band * hidden;
  int y0, y1, x0, x1;
  if (kWindow) {
    y0 = lower_bound(rows, h_out, r);
    y1 = lower_bound(rows, h_out, r + 1);
    x0 = lower_bound(cols, w_out, c);
    x1 = lower_bound(cols, w_out, c + 1);
  } else {
    y0 = r * s_h;
    y1 = y0 + s_h;
    x0 = c * s_w;
    x1 = x0 + s_w;
  }
  const float* src;
  long long stride;
  if (band == 0) {
    src = scratch + plan.s_z0 + j;
    stride = hidden;
  } else {
    src = scratch + plan.s_db + (band - 1) * 2 * n_query * hidden + j;
    stride = 2LL * hidden;
  }
  float acc = 0.f;
  for (int y = y0; y < y1; ++y) {
    const long long row = (b * h_out + y) * w_out;
    for (int x = x0; x < x1; ++x) acc += src[(row + x) * stride];
  }
  if (band == 0 && !(z[pix * c_all + j] > 0.f)) acc = 0.f;
  dz[idx] = acc;
}


// Partial weight gradients of one split of queries, for layer i =
// blockIdx.z / n_split + 1:
//   part[split, o_wcat + (i-1) H 2H + p 2H + n] = sum_{m in split}
//       q_{i-1}[m, p] * d_i[m, n]
// computed transposed, dWcat_i^T = d_i^T q_{i-1}, on a kTN (n) x kTP (p)
// output tile (blockIdx.y, blockIdx.x) in 3xTF32 with wgmma: warpgroup w
// takes n rows 64w..64w+63, A = d^T from registers, B = q from shared
// memory. And (p tile 0 only) the column sums of d_i, the bias gradient,
// into part[split, o_bcat + (i-1) 2H + n], written as 0 for the kq half
// (n < H). Query slices of kSliceM rows of d and q stream through a
// kWgradStages-deep cp.async ring; each slice's q is split and rewritten
// K-major (queries inner) into one of two B slab buffers while the
// previous slice's products run, and each slice's twelve products sum in
// a fresh accumulator that is then added in fp32 (see 3xTF32 above).
template <int kHidden>
struct WgradTiling {
  static constexpr int kTP = kHidden < 128 ? kHidden : 128;  // wgmma N
  static constexpr int kTN = 2 * kHidden < 128 ? 2 * kHidden : 128;
  static constexpr int kGroups = kTN / 64;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kLdD = kTN + 8;   // (k = tig, n = gid) on 32 banks
  static constexpr int kLdQ = kTP + 8;
  static constexpr int kStage = kSliceM * (kLdD + kLdQ);   // floats
  static constexpr int kSlab = kSliceM / 8 * 2 * kTP * 8;  // floats
  static constexpr int kSmem = (kWgradStages * kStage + 2 * kSlab) * 4;
  static_assert(kTN % 64 == 0 && kTP % 16 == 0, "wgrad tiling");
};

template <int kHidden>
__global__ void __launch_bounds__(WgradTiling<kHidden>::kThreads, 1)
wgrad_kernel(const float* __restrict__ q, const float* __restrict__ d,
             long long n_query, int n_split, float* __restrict__ part,
             long long part_stride, long long o_wcat, long long o_bcat) {
  using T = WgradTiling<kHidden>;
  constexpr int kN2 = 2 * kHidden;
  constexpr int kK8 = kSliceM / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  float* slabs = stages + kWgradStages * T::kStage;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = warp * 16;           // the warp's n rows in the tile
  const int layer = blockIdx.z / n_split;  // 0-based: dWcat_{layer + 1}
  const int split = blockIdx.z - layer * n_split;
  const int p0 = blockIdx.x * T::kTP;
  const int n0 = blockIdx.y * T::kTN;
  const long long m_begin = static_cast<long long>(split) * kSplitRows;
  const long long m_end =
      m_begin + kSplitRows < n_query ? m_begin + kSplitRows : n_query;
  const int n_slices = static_cast<int>((m_end - m_begin + kSliceM - 1) /
                                        kSliceM);
  const float* ql = q + layer * n_query * kHidden + p0;
  const float* dl = d + layer * n_query * kN2 + n0;
  const bool colsum = blockIdx.x == 0;

  // slice `it` of this split into stage it % kWgradStages: d rows (kTN
  // wide) then q rows (kTP wide); rows past the split's end are zero
  auto load_rows = [&](float* dst, int ld, const float* src, long long lds,
                       long long m0, auto width) {
    constexpr int kW = decltype(width)::value / 4;  // 16-byte chunks a row
    constexpr int kChunks = kSliceM * kW;
    static_assert(kChunks % T::kThreads == 0, "wgrad chunks");
#pragma unroll
    for (int i = 0; i < kChunks / T::kThreads; ++i) {
      const int c = tid + i * T::kThreads;
      const int r = c / kW;
      const int col = (c % kW) * 4;
      if (m0 + r < m_end)
        copy16_async(dst + r * ld + col, src + (m0 + r) * lds + col);
      else
        *reinterpret_cast<float4*>(dst + r * ld + col) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // slice `it` of this split into stage it % kWgradStages: d rows (kTN
  // wide) then q rows (kTP wide); rows past the split's end are zero
  auto load_slice = [&](int it) {
    if (it >= n_slices) return;
    float* ds = stages + (it % kWgradStages) * T::kStage;
    const long long m0 = m_begin + static_cast<long long>(it) * kSliceM;
    load_rows(ds, T::kLdD, dl, kN2, m0,
              std::integral_constant<int, T::kTN>());
    load_rows(ds + kSliceM * T::kLdD, T::kLdQ, ql, kHidden, m0,
              std::integral_constant<int, T::kTP>());
  };
  // slice it's q, split, into slab buffer it % 2 in the chain's B layout:
  // k8 step k8, hi | lo, element (m = 8 k8 + 4 h + c, p = 8 g + r) at [g,
  // h, r, c]; a warp writes 32 consecutive floats
  auto transform = [&](int it) {
    if (it >= n_slices) return;
    const float* qs = stages + (it % kWgradStages) * T::kStage +
                      kSliceM * T::kLdD;
    float* slab = slabs + (it & 1) * T::kSlab;
    const int c = lane & 3;
    const int r = lane >> 2;
    constexpr int kG = T::kTP / 8;
    constexpr int kPerWarp = kK8 * 2 * kG / (T::kThreads / 32);
    float v[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int x = warp + i * (T::kThreads / 32);
      const int g = x % kG;
      const int h = (x / kG) & 1;
      const int k8 = x / (2 * kG);
      v[i] = qs[(8 * k8 + 4 * h + c) * T::kLdQ + 8 * g + r];
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int x = warp + i * (T::kThreads / 32);
      const int g = x % kG;
      const int h = (x / kG) & 1;
      const int k8 = x / (2 * kG);
      uint32_t hi, lo;
      split_tf32(v[i], hi, lo);
      float* dst = slab + k8 * 2 * T::kTP * 8 + g * 64 + h * 32 + lane;
      dst[0] = u2f(hi);
      dst[T::kTP * 8] = u2f(lo);
    }
    fence_proxy_async();
  };

  float acc[T::kTP / 2];
#pragma unroll
  for (int c = 0; c < T::kTP / 2; ++c) acc[c] = 0.f;
  float bsum = 0.f;

#pragma unroll
  for (int st = 0; st < kWgradStages - 1; ++st) {
    load_slice(st);
    async_commit();
  }
  async_wait<kWgradStages - 2>();
  __syncthreads();
  transform(0);
  for (int it = 0; it < n_slices; ++it) {
    async_wait<kWgradStages - 3>();
    // slices it and it + 1 have landed for every thread, slab it % 2 is
    // written, and every thread is done with iteration it - 1 (its
    // products, its slab and the stage of slice it - 1)
    __syncthreads();
    load_slice(it + kWgradStages - 1);
    async_commit();
    const float* ds = stages + (it % kWgradStages) * T::kStage;
    uint32_t ah[kK8][4], al[kK8][4];
#pragma unroll
    for (int k8 = 0; k8 < kK8; ++k8) {
      // A = d^T: a (n, k) = ds[k][n]
      const float* ap = ds + (8 * k8 + tig) * T::kLdD + wrow0 + gid;
      split_tf32(ap[0], ah[k8][0], al[k8][0]);
      split_tf32(ap[8], ah[k8][1], al[k8][1]);
      split_tf32(ap[4 * T::kLdD], ah[k8][2], al[k8][2]);
      split_tf32(ap[4 * T::kLdD + 8], ah[k8][3], al[k8][3]);
    }
    if (colsum && tid < T::kTN) {
#pragma unroll 8
      for (int r = 0; r < kSliceM; ++r) bsum += ds[r * T::kLdD + tid];
    }
    const float* slab = slabs + (it & 1) * T::kSlab;
    float t[T::kTP / 2];
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < kK8; ++k8) {
      const float* b = slab + k8 * 2 * T::kTP * 8;
      if (k8 == 0)
        wgmma_tf32<T::kTP, true>(t, al[k8], b);
      else
        wgmma_tf32<T::kTP, false>(t, al[k8], b);
      wgmma_tf32<T::kTP, false>(t, ah[k8], b + T::kTP * 8);
      wgmma_tf32<T::kTP, false>(t, ah[k8], b);
    }
#if defined(__CUDA_ARCH__)
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
    transform(it + 1);  // meanwhile, into the other slab
#if defined(__CUDA_ARCH__)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#endif
    fence_regs(t);
    // the products read ah and al until the wait: keep their registers
    fence_regs(reinterpret_cast<float(&)[kK8 * 4]>(ah));
    fence_regs(reinterpret_cast<float(&)[kK8 * 4]>(al));
#pragma unroll
    for (int c = 0; c < T::kTP / 2; ++c) acc[c] += t[c];
  }

  float* out = part + split * part_stride;
  float* wout = out + o_wcat + static_cast<long long>(layer) * kHidden * kN2;
#pragma unroll
  for (int i = 0; i < T::kTP / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + wrow0 + gid + 8 * (c >> 1);
      const int p = p0 + 8 * i + 2 * tig + (c & 1);
      wout[static_cast<long long>(p) * kN2 + n] = acc[4 * i + c];
    }
  if (colsum && tid < T::kTN) {
    const int n = n0 + tid;
    out[o_bcat + static_cast<long long>(layer) * kN2 + n] =
        n >= kHidden ? bsum : 0.f;
  }
}

// Partial gradients of a product with a thin (<= 3 column) factor over
// one split of queries (blockIdx.y), for the 32 wide columns n of
// blockIdx.x (one per lane):
//   prod[t, n] = sum_m T[m % t_rows, t] * W[m, n]   (t < nt)
// written at part[split, o_prod + (t_major ? t * n_wide + n : n * nt + t)],
// and, where the offsets are >= 0, the column sums of W (o_wsum + n) and
// of T (o_tsum + n for n < nt). Warp w takes rows w, w + kThinWarps, ...;
// the warps' partials are added in warp order.
__global__ void __launch_bounds__(kThinThreads)
thin_kernel(const float* __restrict__ w, int ldw, int n_wide,
            const float* __restrict__ tm, int ldt, int nt, long long t_rows,
            long long n_query, float* __restrict__ part,
            long long part_stride, long long o_prod, int t_major,
            long long o_wsum, long long o_tsum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][5][32]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int split = blockIdx.y;
  const long long m_begin = static_cast<long long>(split) * kSplitRows;
  const long long m_end =
      m_begin + kSplitRows < n_query ? m_begin + kSplitRows : n_query;
  float v5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // 3 products, wsum, tsum
  if (n < n_wide) {
    for (long long m = m_begin + warp; m < m_end; m += kThinWarps) {
      const float v = w[m * ldw + n];
      const float* trow = tm + (m % t_rows) * ldt;
      v5[0] = fmaf(trow[0], v, v5[0]);
      if (nt > 1) v5[1] = fmaf(trow[1], v, v5[1]);
      if (nt > 2) v5[2] = fmaf(trow[2], v, v5[2]);
      v5[3] += v;
      if (n < nt) v5[4] += trow[n];
    }
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) red[(warp * 5 + k) * 32 + lane] = v5[k];
  __syncthreads();
  if (warp != 0 || n >= n_wide) return;
  float sum[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int w2 = 0; w2 < kThinWarps; ++w2)
#pragma unroll
    for (int k = 0; k < 5; ++k) sum[k] += red[(w2 * 5 + k) * 32 + lane];
  float* out = part + split * part_stride;
  for (int t = 0; t < nt; ++t)
    out[o_prod + (t_major ? static_cast<long long>(t) * n_wide + n
                          : static_cast<long long>(n) * nt + t)] = sum[t];
  if (o_wsum >= 0) out[o_wsum + n] = sum[3];
  if (o_tsum >= 0 && n < nt) out[o_tsum + n] = sum[4];
}

// out[i] = sum over splits s = 0, 1, ... of part[s, i], in that order.
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, int n_split, long long n_grad,
              float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_grad) return;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += part[s * n_grad + i];
  out[i] = acc;
}

// The whole backward as a sequence of launches. `launch(kernel, grid,
// block, smem, args...)` is the caller's: a CUDA launch on its stream, or
// a host emulation in a test harness. Returns the first error.
template <int kNC, bool kWindow, class Launch>
int run_bwd(Launch& launch, const float* z, const float* syn,
            const int* rows, const int* cols, const float* w0,
            const float* b0, const float* wslab, const float* bcat,
            const float* wl, const float* wtslab, const float* g,
            float* dz, float* grads, float* scratch, int batch, int h_in,
            int w_in, int h_out, int w_out, int s_h, int s_w,
            int n_layers) {
  constexpr int kHidden = kNC * 32;
  const long long m = static_cast<long long>(batch) * h_out * w_out;
  const Plan plan(m, kHidden, n_layers);
  int err = 0;
  if (m > 0) {
    err = launch(decode_bwd_chain_kernel<kNC, kWindow>,
                 static_cast<unsigned>((m + kTileM - 1) / kTileM), kThreads,
                 ChainTiling<kHidden>::kSmem, z, syn, rows, cols, w0, b0,
                 wslab, bcat, wl, wtslab, g, scratch, batch, h_in, w_in,
                 h_out, w_out, s_h, s_w, n_layers);
    if (err) return err;
  }
  const long long n_dz =
      static_cast<long long>(batch) * h_in * w_in * n_layers * kHidden;
  if (n_dz > 0) {
    err = launch(fold_dz_kernel<kWindow>,
                 static_cast<unsigned>((n_dz + 255) / 256), 256, 0, z, rows,
                 cols, static_cast<const float*>(scratch), dz, batch, h_in,
                 w_in, h_out, w_out, s_h, s_w, kHidden, n_layers);
    if (err) return err;
  }
  float* part = scratch + plan.s_part;
  if (m > 0 && n_layers > 1) {
    using W = WgradTiling<kHidden>;
    err = launch(wgrad_kernel<kHidden>,
                 dim3(kHidden / W::kTP, 2 * kHidden / W::kTN,
                      plan.n_split * (n_layers - 1)),
                 W::kThreads, W::kSmem,
                 static_cast<const float*>(scratch + plan.s_q),
                 static_cast<const float*>(scratch + plan.s_db), m,
                 plan.n_split, part, plan.n_grad, plan.o_wcat, plan.o_bcat);
    if (err) return err;
  }
  if (m > 0) {
    const dim3 grid((kHidden + 31) / 32, plan.n_split);
    // dW0 (3, H) and db0: W = dpre_0, T = syn (one row per HR position)
    err = launch(thin_kernel, grid, kThinThreads, kThinSmem,
                 static_cast<const float*>(scratch + plan.s_p0), kHidden,
                 kHidden, syn, 3, 3, static_cast<long long>(h_out) * w_out,
                 m, part, plan.n_grad, plan.o_w0, 1, plan.o_b0, -1LL);
    if (err) return err;
    // dWl (H, 3) and dbl: W = q_{L-1}, T = g
    err = launch(thin_kernel, grid, kThinThreads, kThinSmem,
                 static_cast<const float*>(
                     scratch + plan.s_q +
                     static_cast<long long>(n_layers - 1) * m * kHidden),
                 kHidden, kHidden, g, 3, 3, m, m, part, plan.n_grad,
                 plan.o_wl, 0, -1LL, plan.o_bl);
    if (err) return err;
  }
  return launch(reduce_kernel,
                static_cast<unsigned>((plan.n_grad + 255) / 256), 256, 0,
                static_cast<const float*>(part), plan.n_split, plan.n_grad,
                grads);
}

}  // namespace decoder_bwd
