// Implicit-GEMM convolution for the fp32 inference encoder (sm_90a): a
// stride-1, same-padded k x k conv (k = 1 or 3) on NHWC fp32 channel
// slabs, with 3xTF32 products on the tensor cores (wgmma), and bias, ReLU
// and a residual add fused into its epilogue.
//
// It replaces no TPU kernel: on the TPU these convs were XLA convs. On the
// card cuDNN's fp32 convs (TF32 off, as fp32 requires) run on the CUDA
// cores, NCHW, at about 28 TFLOP/s, with layout kernels and a growing
// torch.cat around every residual dense block. This kernel is the fp32
// inference path of RDN, EDSR-baseline and the stacked LR conv
// (kernels/encoder_conv.py); training and bf16 keep cuDNN.
//
// What bounds it on this card: the products. RDN-B at 192x256 is 2.2e12
// FLOP a request; in 3xTF32 (three TF32 products a multiply-add, fp32-level
// error, hopper_chain.cuh) that is 13.4 ms at 495 TFLOP/s, against about 3
// ms for the bytes (each conv reads its channel prefix once, and the split
// weights). What the design does about it:
//
// - the GEMM is M = output pixels, N = output channels, K = taps x input
//   channels. A tile is kTileRows image rows x kTileCols pixels (M = 192)
//   by kN = 64 output channels: 64-channel convs are one N tile, the
//   stacked LR conv's 1024 sixteen. A CTA walks its tiles persistently,
//   one CTA an SM, so that a tile's epilogue overlaps the next tile's loads;
// - K runs chunk by chunk of kKc = 32 input channels, and within a chunk tap
//   by tap. A chunk's activations come in as ONE box by TMA from a 4-D
//   tensor map over the slab (channels, W, H, B): the tile's rows and
//   columns with a (k - 1) / 2 halo, whose out-of-bounds zero fill is the
//   same padding (and masks the ragged edge and the channels past C_in).
//   Every tap reads the same box shifted, so a chunk is loaded once for
//   its 9 taps. 128-byte swizzle: a pixel's 32 channels are one 128-byte
//   row, its 16-byte groups permuted by the pixel's index mod 8, so a
//   warp's fragment loads spread evenly over the banks;
// - the weights are split once into TF32 hi and lo and laid out in wgmma's
//   B layout by the wrapper (weight_slabs, cached per parameter), one
//   16 KB slab a (N tile, chunk, tap); one producer thread streams them
//   into an mbarrier ring by TMA bulk copies, beside the activation boxes;
// - three consumer warpgroups, one an image row of the tile (64 pixels,
//   wgmma's M), each load their A fragments from the box (16-byte loads,
//   the k order permuted to match) and split them in registers, then
//   issue the three wgmma TF32 (a_lo b_hi, a_hi b_lo, a_hi b_hi) a k8
//   step; the next tap's values load while a tap's products run. A
//   tensor-core product truncates its sum, so the 12 products of a tap go
//   to a fresh accumulator that is added to the running sum in fp32
//   (hopper_chain.cuh's 3xTF32 note); the three warpgroups run apart, so
//   one's adds overlap the others' products;
// - the epilogue adds the bias, then ReLU, then a residual read from a
//   third slab, and writes Cout channels into a channel slice of the
//   output slab (which may be the input's own slab), and optionally of a
//   second one.
//
// Off the card, a host harness (hopper_host.h, encoder_conv_host.cpp)
// runs the launch with one std::thread per CUDA thread and the TMA box
// load emulated with its zero fill and swizzle.

#pragma once

#include <cstdint>

#include "hopper_chain.cuh"

#if !defined(__CUDACC__) && !defined(__grid_constant__)
#define __grid_constant__
#endif

namespace encoder_conv {

using namespace hopper_chain;

#if defined(__CUDACC__)
using TensorMap = CUtensorMap;
#else
// The host harness's tensor map: what cuTensorMapEncodeTiled is given.
struct TensorMap {
  const float* base;
  long long dims[4];     // elements, innermost first
  long long strides[3];  // bytes, of dims 1..3
  int box[4];
};
void host_tma_load_4d(void* dst, const TensorMap* map, int c0, int c1,
                      int c2, int c3, uint32_t bytes, uint64_t* bar);
#endif

constexpr int kConsumers = 3;                 // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileRows = kConsumers;         // image rows a tile
constexpr int kTileCols = 64;                 // pixels a row: wgmma's M
constexpr int kN = 64;                        // output channels a tile
constexpr int kKc = 32;                       // input channels a chunk
constexpr int kSteps = kKc / 8;               // k8 steps a tap and chunk
// one (N tile, chunk, tap) of B: kSteps k8 steps, each hi then lo, kN * 8
// floats apiece (mma_b_slabs' layout)
constexpr int kSlabFloats = kSteps * 2 * kN * 8;
constexpr uint32_t kSlabBytes = kSlabFloats * 4;
constexpr int kEmptyArrivals = 4 * kConsumers;  // one a consumer warp
// registers a thread after setmaxnreg: 128 * (40 + 3 * 152) <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 152;

template <int kKs>
struct Tiling {
  static_assert(kKs == 1 || kKs == 3, "kernel size 1 or 3");
  static constexpr int kPad = (kKs - 1) / 2;
  static constexpr int kTaps = kKs * kKs;
  static constexpr int kBoxW = kTileCols + 2 * kPad;
  static constexpr int kBoxH = kTileRows + 2 * kPad;
  static constexpr uint32_t kBoxBytes = kBoxW * kBoxH * kKc * 4;
  static constexpr int kAStride = (kBoxBytes + 1023) / 1024 * 1024;
  // a 1x1 chunk is one tap: more of them in flight
  static constexpr int kAStages = kKs == 1 ? 4 : 2;
  static constexpr int kBStages = kKs == 1 ? 6 : 8;
  // byte offsets from the 1024-aligned base (the swizzle's period)
  static constexpr int kA = 0;
  static constexpr int kB = kA + kAStages * kAStride;
  static constexpr int kBars = kB + kBStages * static_cast<int>(kSlabBytes);
  static constexpr int kEnd = kBars + 2 * (kAStages + kBStages) * 8;
  static constexpr int kSmem = kEnd + 1024;   // room to align the base
  static_assert(kSmem <= 232448, "shared memory");
};

// The kernel's arguments besides the tensor map. Slabs are NHWC with a
// channel stride (`*_cs`, elements) of their own; out, res and out2 point
// at channel 0 of their slice. res and out2 may be null.
struct Params {
  const float* wslab;  // weight_slabs: (N tiles, chunks, taps, kSlabFloats)
  const float* bias;   // (cout,)
  float* out;
  const float* res;
  float* out2;
  long long out_cs, res_cs, out2_cs;
  int batch, height, width, cout, n_chunks, relu;
};

// Float offset of 16-byte group g (channels 4 g .. 4 g + 3) of pixel p
// of a box in shared memory: a pixel's kKc channels are one 128-byte row
// whose groups are permuted by p mod 8 (TMA's 128-byte swizzle, base
// 1024-aligned), so that the 8 pixels of a fragment's rows hit 8 groups.
__device__ __forceinline__ int box_at(int p, int g) {
  return p * kKc + (((g ^ p) & 7) << 2);
}

// A tap's A values of this thread: the kSteps k8 steps of rows p and
// p + 8 (p the thread's box pixel), as raw[2 j] (row p) and raw[2 j + 1]
// (row p + 8) for steps 2 j and 2 j + 1. Within each 16 channels the k
// order is permuted, the B slabs alike (weight_slabs): channel
// 16 j + 4 c + 2 u + h is step 2 j + u's k index 4 h + c, so that the
// four values a thread needs of a row and two steps, k = tig and tig + 4
// of each, are channels 16 j + 4 tig .. + 3, one 16-byte load.
__device__ __forceinline__ void load_tap(const float* box, int p, int tig,
                                         float4 (&raw)[kSteps]) {
#pragma unroll
  for (int j = 0; j < kSteps / 2; ++j) {
    raw[2 * j] =
        *reinterpret_cast<const float4*>(box + box_at(p, 4 * j + tig));
    raw[2 * j + 1] = *reinterpret_cast<const float4*>(
        box + box_at(p + 8, 4 * j + tig));
  }
}

// The split fragments of a tap's raw values (load_tap): a0 (row p, tig),
// a2 (p, tig + 4), a1 and a3 the same of row p + 8.
__device__ __forceinline__ void split_tap(const float4 (&raw)[kSteps],
                                          Tf32::Frag (&fr)[kSteps]) {
#pragma unroll
  for (int j = 0; j < kSteps / 2; ++j) {
    const float4 v = raw[2 * j], w = raw[2 * j + 1];
    Tf32::Frag& a = fr[2 * j];
    Tf32::Frag& b = fr[2 * j + 1];
    split_tf32(v.x, a.hi[0], a.lo[0]);
    split_tf32(v.y, a.hi[2], a.lo[2]);
    split_tf32(v.z, b.hi[0], b.lo[0]);
    split_tf32(v.w, b.hi[2], b.lo[2]);
    split_tf32(w.x, a.hi[1], a.lo[1]);
    split_tf32(w.y, a.hi[3], a.lo[3]);
    split_tf32(w.z, b.hi[1], b.lo[1]);
    split_tf32(w.w, b.hi[3], b.lo[3]);
  }
}

// A 4-D box (coordinates innermost first, the outer ones may be negative
// or past the end: zero filled) from the tensor map into shared memory
// by the TMA unit; bar's current phase completes when its `bytes` have
// landed. One thread issues it.
__device__ __forceinline__ void tma_load_box(void* dst, const TensorMap* map,
                                             int c0, int c1, int c2, int c3,
                                             uint32_t bytes, uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
#elif !defined(__CUDACC__)
  host_tma_load_4d(dst, map, c0, c1, c2, c3, bytes, bar);
#endif
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
#if defined(__CUDA_ARCH__)
  const uint32_t a = smem_u32(p);
#else
  const uint32_t a = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
#endif
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Where unit u (N tile major, then batch, tile row, tile column) lies.
struct Unit {
  int nt, b, ty, tx;
};

__device__ __forceinline__ Unit unit_at(long long u, long long n_tiles,
                                        int tiles_y, int tiles_x) {
  Unit r;
  r.nt = static_cast<int>(u / n_tiles);
  long long t = u % n_tiles;
  r.tx = static_cast<int>(t % tiles_x);
  t /= tiles_x;
  r.ty = static_cast<int>(t % tiles_y);
  r.b = static_cast<int>(t / tiles_y);
  return r;
}

template <int kKs>
__global__ void __launch_bounds__(kThreads, 1)
    conv_implicit_gemm_3xtf32_kernel(const __grid_constant__ TensorMap map,
                                     const Params p) {
  using T = Tiling<kKs>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  float* sa = reinterpret_cast<float*>(base + T::kA);
  float* sb = reinterpret_cast<float*>(base + T::kB);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(base + T::kBars);
  uint64_t* a_empty = a_full + T::kAStages;
  uint64_t* b_full = a_empty + T::kAStages;
  uint64_t* b_empty = b_full + T::kBStages;
  const int tid = threadIdx.x;
  const int tiles_x = (p.width + kTileCols - 1) / kTileCols;
  const int tiles_y = (p.height + kTileRows - 1) / kTileRows;
  const long long n_tiles = static_cast<long long>(p.batch) * tiles_y *
                            tiles_x;
  const long long n_units = n_tiles * ((p.cout + kN - 1) / kN);

  if (tid == 0) {
    for (int i = 0; i < T::kAStages; ++i) {
      mbar_init(a_full + i, 1);
      mbar_init(a_empty + i, kEmptyArrivals);
    }
    for (int i = 0; i < T::kBStages; ++i) {
      mbar_init(b_full + i, 1);
      mbar_init(b_empty + i, kEmptyArrivals);
    }
  }
  __syncthreads();

  // the producer: for each unit and chunk, the activation box into A slot
  // na % kAStages, then the chunk's taps' weight slabs into B slot
  // nb % kBStages, each once every consumer warp has released the slot's
  // previous use
  const int role = warpgroup_uniform();
  if (role == 0) {
    set_max_regs_dec<kProducerRegs>();
    if (tid == 0) {
      uint32_t na = 0, nb = 0;
      for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
        const Unit w = unit_at(u, n_tiles, tiles_y, tiles_x);
        const float* src = p.wslab + static_cast<long long>(w.nt) *
                                         p.n_chunks * T::kTaps * kSlabFloats;
        for (int q = 0; q < p.n_chunks; ++q) {
          const int as = static_cast<int>(na % T::kAStages);
          mbar_wait_loop(a_empty + as, ((na / T::kAStages) & 1u) ^ 1u);
          tma_load_box(sa + as * (T::kAStride / 4), &map, q * kKc,
                       w.tx * kTileCols - T::kPad, w.ty * kTileRows - T::kPad,
                       w.b, T::kBoxBytes, a_full + as);
          ++na;
          for (int t = 0; t < T::kTaps; ++t, ++nb) {
            const int bs = static_cast<int>(nb % T::kBStages);
            mbar_wait_loop(b_empty + bs, ((nb / T::kBStages) & 1u) ^ 1u);
            bulk_load(sb + bs * kSlabFloats,
                      src + (static_cast<long long>(q) * T::kTaps + t) *
                                kSlabFloats,
                      kSlabBytes, b_full + bs);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: tile row c; warp w of it the row's pixels
  // 16 w .. 16 w + 15, a thread the accumulator elements of wgmma's layout
  // (pixels 16 w + gid (+ 8), channels 8 i + 2 tig (+ 1))
  set_max_regs_inc<kConsumerRegs>();
  const int c = role - 1;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int warp = (tid >> 5) & 3;
  const bool leader = lane == 0;
  uint32_t na = 0, nb = 0;
  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit w = unit_at(u, n_tiles, tiles_y, tiles_x);
    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    for (int q = 0; q < p.n_chunks; ++q) {
      const int as = static_cast<int>(na % T::kAStages);
      mbar_wait_loop(a_full + as, (na / T::kAStages) & 1u);
      const float* box = sa + as * (T::kAStride / 4);
      // the next tap's raw values load while this tap's products run
      float4 raw[kSteps];
      load_tap(box, c * T::kBoxW + 16 * warp + gid, tig, raw);
#pragma unroll
      for (int t = 0; t < T::kTaps; ++t) {
        const uint32_t n = nb + t;
        const int bs = static_cast<int>(n % T::kBStages);
        mbar_wait_loop(b_full + bs, (n / T::kBStages) & 1u);
        const float* slab = sb + bs * kSlabFloats;
        Tf32::Frag fr[kSteps];
        split_tap(raw, fr);
        float f[kN / 2];
        wgmma_fence();
        Tf32::mma<kN, true>(f, fr[0], slab);
#pragma unroll
        for (int s = 1; s < kSteps; ++s)
          Tf32::mma<kN, false>(f, fr[s], slab + s * 2 * kN * 8);
        wgmma_commit();
        if (t + 1 < T::kTaps) {
          const int dy = (t + 1) / kKs, dx = (t + 1) % kKs;
          load_tap(box, (c + dy) * T::kBoxW + 16 * warp + gid + dx, tig,
                   raw);
        }
        wgmma_wait<0>();
        fence_regs(f);
#pragma unroll
        for (int s = 0; s < kSteps; ++s) Tf32::fence_frag(fr[s]);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[i] += f[i];
        mbar_arrive_if(b_empty + bs, leader);
      }
      nb += T::kTaps;
      mbar_arrive_if(a_empty + as, leader);
      ++na;
    }

    // the epilogue: (acc + bias), ReLU, + residual, into out (and out2)
    const int y = w.ty * kTileRows + c;
    if (y < p.height) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = w.tx * kTileCols + 16 * warp + gid + 8 * hh;
        if (x >= p.width) continue;
        const long long pix =
            (static_cast<long long>(w.b) * p.height + y) * p.width + x;
#pragma unroll
        for (int i = 0; i < kN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = w.nt * kN + 8 * i + 2 * tig + e;
            if (n >= p.cout) continue;
            float v = acc[4 * i + 2 * hh + e] + p.bias[n];
            if (p.relu) v = fmaxf(v, 0.f);
            if (p.res) v += p.res[pix * p.res_cs + n];
            p.out[pix * p.out_cs + n] = v;
            if (p.out2) p.out2[pix * p.out2_cs + n] = v;
          }
      }
    }
  }
}

// The launch: a persistent grid of at most one CTA an SM (n_sm).
// Returns the launcher's error (0 = launched).
template <int kKs, class Launch>
int run_conv(Launch& launch, const TensorMap& map, const Params& p,
             int n_sm) {
  using T = Tiling<kKs>;
  const long long tiles =
      static_cast<long long>(p.batch) *
      ((p.height + kTileRows - 1) / kTileRows) *
      ((p.width + kTileCols - 1) / kTileCols) * ((p.cout + kN - 1) / kN);
  if (tiles == 0) return 0;
  const int grid = static_cast<int>(tiles < n_sm ? tiles : n_sm);
  return launch(conv_implicit_gemm_3xtf32_kernel<kKs>, dim3(grid),
                dim3(kThreads), T::kSmem, map, p);
}

}  // namespace encoder_conv
