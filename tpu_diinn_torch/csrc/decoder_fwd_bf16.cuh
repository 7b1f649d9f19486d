// The bf16 forward of the fused DIINN mode-3 decoder, designed for Hopper
// (sm_90a): decode_int_fwd and decode_window_fwd in the bf16 mode (bf16 = 1
// at decoder_fused.cu's interface). The fp32 forwards keep
// decoder_fused.cuh's kernel, and the backward recomputes the forward
// with hopper_chain.cuh's chain_forward; this kernel computes the same
// numbers (every product sums its k16 steps into fp32 in the same order,
// and the elementwise arithmetic is the same expressions), so its output
// is bit-identical to that routine's bf16 forward.
//
// What bounds it on this card: the elementwise work more than the
// products. The products (3 * 256 * 512 * 2 FLOP a query and layer at
// hidden 256) take 0.118 ms at 989 TFLOP/s for the flagship's x4
// training call (B 4, LR 48); the weights stream from L2 (every tile
// reads all of [Wkq | Wq], 256 KB a layer); and every element of k and q
// costs about 20 fp32-pipe instructions (widen z, relu, the polynomial
// sine, k * sin, rounding), on the fp32 pipes while the tensor cores
// wait unless something else runs beside it. What the design does:
//
// - 128 queries a CTA, two consumer warpgroups of 64 queries each, every
//   one over all hidden columns: both read each weight slab of one
//   shared ring, so a slab streams from L2 once for 128 queries (half the
//   bytes of the fp32 design's 64-query tiles with a ring a warpgroup);
// - a producer warpgroup (one thread of it) issues the TMA bulk copies of
//   the slabs into the ring (full barriers with the copies' bytes, empty
//   barriers that the 8 consumer warps arrive on once their products have
//   read a slot, commit group by commit group); setmaxnreg gives its
//   registers to the consumers;
// - A (the q tile) stays in shared memory in wgmma's K-major layout (core
//   matrices of 8 rows x 16 bytes, as the B slabs) and is read through a
//   descriptor: a column block's 16 k16 steps issue back to back in four
//   commit groups, each as soon as its slabs have landed, with no
//   register loads of A between them;
// - the two warpgroups run apart: one's epilogue runs while the other's
//   products do. (Taking turns on the tensor cores through named
//   barriers, as FlashAttention-3 schedules its softmax, was slower on the
//   card: PERF.md.) They share no query, so a layer boundary needs no
//   CTA-wide barrier;
// - each epilogue keeps its block's q in registers (bf16 pairs) until the
//   warpgroup's last product of the layer has read the q tile, and then
//   writes the tile in place: one q tile a warpgroup, which leaves room
//   for a ring of two column blocks;
// - epilogues mask a dead row's q to zero rather than branch around it (a
//   branch splits the unrolled epilogue into a basic block a pair, and
//   the compiler then cannot interleave the pairs' dependent chains);
// - a persistent grid, one CTA an SM walking the tiles; W0, b0, Wl and bl
//   staged once a CTA in shared memory as fp32; the next tile's z rows go
//   to L2 by bulk prefetches while this tile runs.
//
// The head sums each (query, channel) over k in order, one running fp32
// sum, as the reference's product does (decoder_fused.cuh). Registers:
// the consumers' epilogues hold the accumulator (64 at hidden 256) and a
// layer's q (64); setmaxnreg gives them 232 a thread, the producer 40
// (384 threads; a lone producer warp beside 256 consumer threads would
// leave one SM quarter three warps, and every thread 168 registers).
//
// Off the card a host harness (hopper_host.h, decoder_fused_host.cpp)
// provides wgmma with A from shared memory (deferred to the warpgroup's
// wait, so that a slot released too early shows in the result), the named
// barriers and the mbarriers' arrivals; setmaxnreg is nothing there.

#pragma once

#include <cstdint>

#include "hopper_chain.cuh"

namespace hopper_chain {

#if !defined(__CUDACC__)
void host_wgmma_bf16_ss(float* d, int n, const uint16_t* a,
                        const uint16_t* b);
void host_wgmma_commit();
void host_wgmma_wait(int pending);
void host_mbar_arrive(uint64_t* bar);
void host_bar_sync(int id, int count);
#endif

// wgmma's descriptor of a K-major operand in shared memory without
// swizzle, core matrices of 8 rows x 16 bytes, the two k halves of a k16
// step 128 bytes apart, 8-row groups 256 bytes apart: the B slabs'
// layout (b_desc), and the q tile's (FwdTiling::q_at).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return b_desc(p);
}

// One warpgroup's D (64 x N) += A (64 x 16) * B (16 x N) in bf16 with fp32
// sums, both operands from shared memory (K-major, no transpose).
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16],
                                                   const uint16_t* a,
                                                   const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(smem_desc(a)), "l"(smem_desc(b)), "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_bf16_ss(d, 32, a, b);
#endif
}

__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   const uint16_t* a,
                                                   const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(smem_desc(a)), "l"(smem_desc(b)), "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_bf16_ss(d, 64, a, b);
#endif
}

__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                   const uint16_t* a,
                                                   const uint16_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(smem_desc(a)), "l"(smem_desc(b)), "r"(1));
#elif !defined(__CUDACC__)
  host_wgmma_bf16_ss(d, 128, a, b);
#endif
}

template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2],
                                         const uint16_t* a,
                                         const uint16_t* b) {
  if constexpr (kN == 32) {
    wgmma_ss_m64n32k16(d, a, b);
  } else if constexpr (kN == 64) {
    wgmma_ss_m64n64k16(d, a, b);
  } else {
    static_assert(kN == 128, "wgmma N");
    wgmma_ss_m64n128k16(d, a, b);
  }
}

__device__ __forceinline__ void ss_commit() {
#if defined(__CUDA_ARCH__)
  wgmma_commit();
#elif !defined(__CUDACC__)
  host_wgmma_commit();
#endif
}

// Wait until at most kPending committed groups of wgmma_ss are in flight.
template <int kPending>
__device__ __forceinline__ void ss_wait() {
#if defined(__CUDA_ARCH__)
  wgmma_wait<kPending>();
#elif !defined(__CUDACC__)
  host_wgmma_wait(kPending);
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

// Named barrier `id` (1..15) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
#elif !defined(__CUDACC__)
  host_bar_sync(id, count);
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

}  // namespace hopper_chain

namespace decoder_fwd_bf16 {

using namespace hopper_chain;

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kRows = 64;                       // queries a warpgroup
constexpr int kTile = kConsumers * kRows;       // queries a CTA's tile
// warpgroup 0 the producer (one thread issues the copies), 1..kConsumers
// the consumers
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kEmptyArrivals = 4 * kConsumers;  // one a consumer warp
// registers a thread after setmaxnreg: 128 * (kProducerRegs + 2 *
// kConsumerRegs) <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barrier kWgBar + wg: consumer warpgroup wg alone
constexpr int kWgBar = 1;

// The kernel's split of the work and its shared memory. Column block c
// (of kBlocks) is pass c / 2 of the fp32 design's warpgroup c % 2:
// ChainTiling's slabs (forward_slabs in the wrapper) serve it unchanged,
// kSteps slabs of kNF columns (the k and then the a columns of kJB hidden
// columns from jb(c)) a block. Offsets in bytes.
template <int kHidden>
struct FwdTiling {
  using C = ChainTiling<kHidden, Bf16>;
  static constexpr int kPasses = C::kPasses;
  static constexpr int kJB = C::kJB;
  static constexpr int kNF = C::kNF;
  static constexpr int kBlocks = 2 * kPasses;
  static constexpr int kSteps = kHidden / 16;
  // a block's products commit in kGroups groups of kGroupSteps k16 steps
  static constexpr int kGroupSteps = kSteps < 4 ? kSteps : 4;
  static constexpr int kGroups = kSteps / kGroupSteps;
  static constexpr int kSlab = kNF * 16;                 // elements
  static constexpr uint32_t kSlabBytes = kSlab * 2;
  // two column blocks' slabs: a block's slots are refilled while the next
  // block is read
  static constexpr int kRing = 2 * kSteps > 16 ? 2 * kSteps : 16;
  static constexpr int kQTile = kRows * kHidden;         // elements
  static constexpr int kFull = 0;
  static constexpr int kEmpty = kFull + kRing * 8;
  static constexpr int kZoff = kEmpty + kRing * 8;
  static constexpr int kSyn = kZoff + kConsumers * kRows * 8;
  static constexpr int kW0 = kSyn + kConsumers * kRows * 3 * 4;
  static constexpr int kB0 = kW0 + 3 * kHidden * 4;
  static constexpr int kWl = kB0 + kHidden * 4;
  static constexpr int kBl = kWl + kHidden * 3 * 4;
  static constexpr int kQ = (kBl + 16 + 127) / 128 * 128;
  static constexpr int kRingOff = kQ + kConsumers * kQTile * 2;
  static constexpr int kSmem = kRingOff + kRing * kSlab * 2;
  static_assert((kRing & (kRing - 1)) == 0, "ring of a power of two");
  static_assert(kSmem <= 232448, "shared memory");

  // the first hidden column of block c
  __device__ __forceinline__ static int jb(int c) {
    return (c & 1) * (kHidden / 2) + (c >> 1) * kJB;
  }
  // the first slab of block c of layer `layer` (1..L-1); its k16 steps
  // are 2 slabs apart
  __device__ __forceinline__ static long long slab0(int layer, int c) {
    return ((static_cast<long long>(layer - 1) * kPasses + (c >> 1)) *
                kSteps * 2 + (c & 1)) * kSlab;
  }
  // element (m, k) of a q tile: k16 step k / 16 a 64 x 16 block of 2 KB,
  // in it 8-row groups of 256 B, each two core matrices (k 0..7, 8..15) of
  // 8 rows x 16 B
  __device__ __forceinline__ static int q_at(int m, int k) {
    return (k >> 4) * 1024 + (m >> 3) * 128 + ((k >> 3) & 1) * 64 +
           (m & 7) * 8 + (k & 7);
  }
};

// `bytes` (a multiple of 16) from global p into L2, by the TMA unit.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
#else
  (void)p;
  (void)bytes;
#endif
}

// For each commit group kG.. of the kGroups in flight, oldest first: wait
// until it is done (kGroups - 1 - kG groups still pending), then
// release(kG).
template <int kG, int kGroups, class F>
__device__ __forceinline__ void release_groups(F&& release) {
  if constexpr (kG < kGroups) {
    ss_wait<kGroups - 1 - kG>();
    release(kG);
    release_groups<kG + 1, kGroups>(release);
  }
}

// a_0 = syn @ W0 + b0 at hidden column j (W0 and b0 staged as fp32): the
// expression of hopper_chain's pre0, so the same sums
__device__ __forceinline__ float pre0_staged(const float* sv,
                                             const float* w0,
                                             const float* b0, int j,
                                             int hidden) {
  return sv[0] * w0[j] + sv[1] * w0[hidden + j] + sv[2] * w0[2 * hidden + j] +
         b0[j];
}

__device__ __forceinline__ float2 widen2(uint32_t v) {
  return make_float2(bf16_float(v & 0xffffu), bf16_float(v >> 16));
}

// kNC = hidden / 32, kWindow the index-vector gather (rows/cols) over the
// integer-ratio one (s_h/s_w), as decoder_fused.cuh's decode_fwd_kernel
// in the Bf16 policy: z, w0, wslab and wl bf16 (their 16 bits), biases,
// syn and out fp32.
template <int kNC, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
decode_fwd_bf16_kernel(const uint16_t* __restrict__ z,
                       const float* __restrict__ syn,
                       const int* __restrict__ rows,
                       const int* __restrict__ cols,
                       const uint16_t* __restrict__ w0,
                       const float* __restrict__ b0,
                       const uint16_t* __restrict__ wslab,
                       const float* __restrict__ bcat,
                       const uint16_t* __restrict__ wl,
                       const float* __restrict__ bl, float* __restrict__ out,
                       int batch, int h_in, int w_in, int h_out, int w_out,
                       int s_h, int s_w, int n_layers) {
  constexpr int kHidden = kNC * 32;
  using T = FwdTiling<kHidden>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + T::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem_raw + T::kEmpty);
  float* w0s = reinterpret_cast<float*>(smem_raw + T::kW0);
  float* b0s = reinterpret_cast<float*>(smem_raw + T::kB0);
  float* wls = reinterpret_cast<float*>(smem_raw + T::kWl);
  float* bls = reinterpret_cast<float*>(smem_raw + T::kBl);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_raw + T::kRingOff);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  const long long n_tiles = (n_query + kTile - 1) / kTile;
  const long long c_all = static_cast<long long>(n_layers) * kHidden;

  if (tid == 0) {
    for (int i = 0; i < T::kRing; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kEmptyArrivals);
    }
  }
  for (int i = tid; i < 3 * kHidden; i += kThreads) {
    w0s[i] = bf16_float(w0[i]);
    wls[i] = bf16_float(wl[i]);
  }
  for (int i = tid; i < kHidden; i += kThreads) b0s[i] = b0[i];
  if (tid < 3) bls[tid] = bl[tid];
  __syncthreads();

  // the producer: every slab of every tile of this CTA, in the order the
  // consumers read them, into the ring slot n % kRing once both
  // warpgroups have released its previous use
  const int role = warpgroup_uniform();
  if (role == 0) {
    set_max_regs_dec<kProducerRegs>();
    if (tid == 0 && n_layers > 1) {
      uint32_t n = 0;
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int layer = 1; layer < n_layers; ++layer)
          for (int c = 0; c < T::kBlocks; ++c) {
            const uint16_t* src = wslab + T::slab0(layer, c);
            for (int s = 0; s < T::kSteps; ++s, ++n) {
              const int slot = n & (T::kRing - 1);
              mbar_wait_loop(empty + slot, ((n / T::kRing) & 1u) ^ 1u);
              bulk_load(ring + slot * T::kSlab, src + 2LL * s * T::kSlab,
                        T::kSlabBytes, full + slot);
            }
          }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 .. wg * 64 + 63 of each tile; warp
  // w of it rows 16 (w % 4) .. + 15, a thread the accumulator elements of
  // wgmma's layout (rows 16 (w % 4) + gid (+ 8), columns 8 i + 2 tig (+ 1))
  set_max_regs_inc<kConsumerRegs>();
  const int wg = role - 1;
  const int lt = tid & 127;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = ((tid >> 5) & 3) * 16;
  long long* zoff = reinterpret_cast<long long*>(smem_raw + T::kZoff) +
                    wg * kRows;
  float* synv = reinterpret_cast<float*>(smem_raw + T::kSyn) +
                wg * kRows * 3;
  uint16_t* q = reinterpret_cast<uint16_t*>(smem_raw + T::kQ) +
                wg * T::kQTile;
  const int my_bar = kWgBar + wg;
  uint32_t n = 0;  // slabs read so far

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // 1) the warpgroup's queries: each one's LR pixel (-1 past the ragged
    //    edge) and syn row, rounded to bf16 as the product's operand.
    //    Meanwhile threads 64..127 bring the next tile's z rows into L2
    //    (one bulk prefetch a pixel, where the query left of it reads
    //    another), and on the first tile threads 0..63 this tile's: the
    //    epilogues' z loads then hit L2, not device memory
    bar_sync(my_bar, 128);  // the last tile's head has read the q tile
    {
      const long long qt = lt < kRows ? tile : tile + gridDim.x;
      const long long qi = qt * kTile + wg * kRows + (lt & (kRows - 1));
      long long off = -1;
      if (qi < n_query) {
        const int x = static_cast<int>(qi % w_out);
        const long long t = qi / w_out;
        const int y = static_cast<int>(t % h_out);
        const long long b = t / h_out;
        const int ry = kWindow ? rows[y] : y / s_h;
        const int cx = kWindow ? cols[x] : x / s_w;
        off = ((b * h_in + ry) * w_in + cx) * c_all;
        const bool first = x == 0 || cx != (kWindow ? cols[x - 1]
                                                    : (x - 1) / s_w);
        if (first && (lt >= kRows || tile == blockIdx.x))
          prefetch_l2(z + off, static_cast<uint32_t>(c_all * 2));
        if (lt < kRows) {
          const float* sp =
              syn + (static_cast<long long>(y) * w_out + x) * 3;
          synv[lt * 3 + 0] = round_bf16(sp[0]);
          synv[lt * 3 + 1] = round_bf16(sp[1]);
          synv[lt * 3 + 2] = round_bf16(sp[2]);
        }
      } else if (lt < kRows) {
        synv[lt * 3 + 0] = 0.f;
        synv[lt * 3 + 1] = 0.f;
        synv[lt * 3 + 2] = 0.f;
      }
      if (lt < kRows) zoff[lt] = off;
    }
    bar_sync(my_bar, 128);
    // a dead row reads the call's first z row and stores zero
    // (its q, computed all the same, is masked to zero: a branch around
    // the computation would split the unrolled epilogues into one basic
    // block a pair, and the compiler could not interleave them)
    long long zrow[2];
    uint32_t live[2];  // all ones for a live row, zero for a dead one
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long off = zoff[wrow0 + gid + 8 * hh];
      live[hh] = off >= 0 ? 0xffffffffu : 0u;
      zrow[hh] = off >= 0 ? off : 0;
    }

    // 2) layer 0 at the thread's elements of every hidden column (its z
    //    pairs loaded all at once, so that their latencies overlap)
    {
      constexpr int kNB = kHidden / 8;
      uint32_t zz[kNB][2];
#pragma unroll
      for (int i = 0; i < kNB; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          zz[i][hh] = *reinterpret_cast<const uint32_t*>(
              z + zrow[hh] + 8 * i + 2 * tig);
#pragma unroll
      for (int i = 0; i < kNB; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wrow0 + gid + 8 * hh;
          const int j = 8 * i + 2 * tig;
          const float2 zv = widen2(zz[i][hh]);
          const float k0 = fmaxf(zv.x, 0.f);
          const float k1 = fmaxf(zv.y, 0.f);
          const float a0 = pre0_staged(synv + m * 3, w0s, b0s, j, kHidden);
          const float a1 = pre0_staged(synv + m * 3, w0s, b0s, j + 1, kHidden);
          const uint32_t v =
              pack_bf16(k0 * poly_sin(a0), k1 * poly_sin(a1)) & live[hh];
          *reinterpret_cast<uint32_t*>(q + T::q_at(m, j)) = v;
        }
    }
    fence_proxy_async();  // the products read q through the async proxy
    bar_sync(my_bar, 128);

    // 3) layers 1..L-1: block by block, [k | a] = q @ [Wkq | Wq], then
    //    its epilogue into registers; the layer's q into the tile once
    //    every block's products are done
    for (int layer = 1; layer < n_layers; ++layer) {
      const float* bq =
          bcat + static_cast<long long>(layer - 1) * 2 * kHidden + kHidden;
      constexpr int kNB = T::kJB / 8;
      uint32_t qn[T::kBlocks][kNB][2];
#pragma unroll
      for (int c = 0; c < T::kBlocks; ++c) {
        float acc[T::kNF / 2];
#pragma unroll
        for (int i = 0; i < T::kNF / 2; ++i) acc[i] = 0.f;
        fence_regs(acc);
        // the block's products in kGroups commit groups of kGroupSteps k16
        // steps, each issued back to back once its slabs have landed
        auto wait_slabs = [&](int g) {
#pragma unroll
          for (int s = g * T::kGroupSteps; s < (g + 1) * T::kGroupSteps;
               ++s) {
            const uint32_t ns = n + s;
            mbar_wait_loop(full + (ns & (T::kRing - 1)),
                           (ns / T::kRing) & 1u);
          }
        };
#pragma unroll
        for (int g = 0; g < T::kGroups; ++g) {
          wait_slabs(g);
          wgmma_fence();
#pragma unroll
          for (int s = g * T::kGroupSteps; s < (g + 1) * T::kGroupSteps;
               ++s)
            wgmma_ss<T::kNF>(acc, q + s * 1024,
                             ring + ((n + s) & (T::kRing - 1)) * T::kSlab);
          ss_commit();
        }
        // the block's z pairs and biases meanwhile
        const int j0 = T::jb(c) + 2 * tig;
        uint32_t zz[kNB][2];
        float2 bb[kNB];
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          bb[i] = load2(bq + j0 + 8 * i);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            zz[i][hh] = *reinterpret_cast<const uint32_t*>(
                z + zrow[hh] + layer * kHidden + j0 + 8 * i);
        }
        // each group's slots back to the producer as soon as its products
        // are done
        release_groups<0, T::kGroups>([&](int g) {
#pragma unroll
          for (int s = g * T::kGroupSteps; s < (g + 1) * T::kGroupSteps;
               ++s)
            mbar_arrive_if(empty + ((n + s) & (T::kRing - 1)), lane == 0);
        });
        fence_regs(acc);
        n += T::kSteps;
        // acc blocks [0, kNB): k columns; [kNB, 2 kNB): a columns
#pragma unroll
        for (int i = 0; i < kNB; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ck = 4 * i + 2 * hh;
            const int ca = 4 * (i + kNB) + 2 * hh;
            const float2 zv = widen2(zz[i][hh]);
            const float k0 = fmaxf(acc[ck] + zv.x, 0.f);
            const float k1 = fmaxf(acc[ck + 1] + zv.y, 0.f);
            const float a0 = acc[ca] + bb[i].x;
            const float a1 = acc[ca + 1] + bb[i].y;
            qn[c][i][hh] =
                pack_bf16(k0 * poly_sin(a0), k1 * poly_sin(a1)) & live[hh];
          }
      }
      bar_sync(my_bar, 128);  // every product of the layer has read q
#pragma unroll
      for (int c = 0; c < T::kBlocks; ++c)
#pragma unroll
        for (int i = 0; i < kNB; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(
                q + T::q_at(wrow0 + gid + 8 * hh,
                            T::jb(c) + 8 * i + 2 * tig)) = qn[c][i][hh];
      fence_proxy_async();
      bar_sync(my_bar, 128);
    }

    // 4) head: out = q @ Wl + bl, one running fp32 sum over k in order a
    //    (query, channel), as the reference's product sums it. Threads
    //    0..63 of the warpgroup sum channels 0 and 1 of query lt, 64..127
    //    channel 2 of query lt - 64; a thread reads 8 k of its row at once
    {
      const int m = lt & (kRows - 1);
      const int o0 = lt < kRows ? 0 : 2;
      const int o1 = lt < kRows ? 1 : 2;  // 64..127 sum channel 2 twice
      const long long qi = tile * kTile + wg * kRows + m;
      if (qi < n_query) {
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
        for (int k0 = 0; k0 < kHidden; k0 += 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(q + T::q_at(m, k0));
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float qv = bf16_float((e & 1) ? w4[e >> 1] >> 16
                                                : w4[e >> 1] & 0xffffu);
            acc0 = fmaf(qv, wls[(k0 + e) * 3 + o0], acc0);
            acc1 = fmaf(qv, wls[(k0 + e) * 3 + o1], acc1);
          }
        }
        out[qi * 3 + o0] = acc0 + bls[o0];
        if (o0 == 0) out[qi * 3 + 1] = acc1 + bls[1];
      }
    }
  }
}

// The bf16 forward as its launch: a persistent grid of at most `max_ctas`
// CTAs (the card's SM count) over the 128-query tiles. `launch(kernel,
// grid, block, smem, args...)` is the caller's, as for run_fwd. Returns
// its error.
template <int kNC, bool kWindow, class Launch>
int run_fwd_bf16(Launch& launch, const uint16_t* z, const float* syn,
                 const int* rows, const int* cols, const uint16_t* w0,
                 const float* b0, const uint16_t* wslab, const float* bcat,
                 const uint16_t* wl, const float* bl, float* out, int batch,
                 int h_in, int w_in, int h_out, int w_out, int s_h, int s_w,
                 int n_layers, int max_ctas) {
  const long long m = static_cast<long long>(batch) * h_out * w_out;
  if (m == 0) return 0;
  const long long tiles = (m + kTile - 1) / kTile;
  const long long grid = tiles < max_ctas ? tiles : max_ctas;
  return launch(decode_fwd_bf16_kernel<kNC, kWindow>,
                static_cast<unsigned>(grid), kThreads,
                FwdTiling<kNC * 32>::kSmem, z, syn, rows, cols, w0, b0,
                wslab, bcat, wl, bl, out, batch, h_in, w_in, h_out, w_out,
                s_h, s_w, n_layers);
}

}  // namespace decoder_fwd_bf16
