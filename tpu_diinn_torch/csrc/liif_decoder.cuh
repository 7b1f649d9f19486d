// LIIF's query MLP for Hopper (sm_90a): one kernel decodes a column chunk
// of HR queries, from the corner lookups to the blended RGB value.
//
// It replaces no TPU kernel: the JAX package runs LIIF's per-query
// products as XLA dense ops. On the card the torch path (nn/liif.py,
// LIIF._blend) runs them as cuBLAS fp32 SGEMMs on the CUDA cores (TF32
// off, as fp32 requires), with two gathers, the rel and cell dense layers,
// ReLUs and the area blend as separate passes: about 27 launches a chunk
// and corner, every intermediate through device memory.
//
// The function, for an HR query (b, y, x) of a chunk and each corner k of
// the local ensemble (k in the blend's order, nn/liif.py _CORNERS):
//
//   h0 = relu(z[b, iy_k[y], ix_k[x]] + (rel_k @ W_rel + b_rel)
//             + cell @ W_cell)                rel_k = (ry_k[y], rx_k[x])
//   h_i = relu(h_{i-1} @ W_i + b_i)           i = 1..3 (256 x 256)
//   pred_k = h3 @ W_4 + b_4                   (256 -> 3)
//   area_k = |ry_k[y] * rx_k[x]| + 1e-9
//   out = sum_k pred_k * area_{3-k} / sum_k area_k   (the diagonal swap)
//
// z is imnet_feat's conv of the LR features (the first layer's unfolded
// part, computed once at LR by the caller), NHWC with 256 channels.
//
// What bounds it on this card: the products. A query and corner is 3 x
// 256 x 256 multiply-adds on the tensor cores; in 3xTF32 (three wgmma TF32
// products a multiply-add, fp32-level error: hopper_chain.cuh) that is
// 165 TFLOP/s of fp32-accurate products. Next, the weights: every row of
// a tile reads all of W_1..W_3 (1.5 MB split into hi and lo) from L2, so
// the rows that share one pass over them set the L2 traffic. What the
// design does:
//
// - a CTA's tile is 32 queries x 4 corners = 128 rows: two consumer
//   warpgroups of 16 queries each, a warpgroup's 64 rows (wgmma's M) its
//   queries' four corners, warp k of it corner k. Both warpgroups read
//   each weight slab of one shared ring, so the weights stream from L2
//   once for 128 rows;
// - a producer warpgroup (one thread of it) streams the split weights by
//   TMA bulk copies into the ring, one 8 KB slab a (layer, k8 step,
//   128-column half): full barriers with the copies'
//   bytes, empty barriers that the 8 consumer warps arrive on once their
//   products have read a slot; setmaxnreg gives its registers to the
//   consumers;
// - a warpgroup keeps its activations in one fp32 tile in shared memory
//   (64 x 256, rows padded to 260 floats against bank conflicts) and
//   overwrites it in place at each layer's epilogue: wgmma reads A from
//   registers, and a warp's A rows are its own rows of the tile, so a
//   layer boundary needs no barrier beyond the warp;
// - each pair of k8 steps sums its six products per 128-column half into
//   a fresh accumulator, added to the running sum in fp32 (the 3xTF32 note
//   of hopper_chain.cuh: a tensor-core product truncates its sum);
// - layer 0 gathers each row's z (1 KB, coalesced across the warp) and
//   adds the rel and cell parts on the CUDA cores; the last hidden layer's
//   epilogue computes W_4's three outputs from the accumulators (partial
//   sums over the thread's columns, then across the four lanes of a row);
//   the area blend runs through 1 KB of shared memory a warpgroup. Nothing
//   but the blended value reaches device memory;
// - a persistent grid, one CTA an SM, walks the chunk's tiles; the small
//   operands (W_rel, b_rel, the cell part, b_1..b_3, W_4, b_4) are staged
//   once a CTA.
//
// Off the card a host harness (hopper_host.h, liif_decoder_host.cpp) runs
// the launch with one std::thread per CUDA thread, and the tests hold it
// against the torch path.

#pragma once

#include <cstdint>

#include "hopper_chain.cuh"

#if !defined(__CUDACC__) && !defined(__grid_constant__)
#define __grid_constant__
#endif

#if !defined(__CUDACC__)
namespace hopper_chain {
void host_bar_sync(int id, int count);
}  // namespace hopper_chain

// the CUDA intrinsics of IEEE arithmetic that the compiler never fuses
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
#endif

namespace liif_decoder {

using namespace hopper_chain;

#if !defined(__CUDACC__)
void host_warp_sync();
#endif

constexpr int kHidden = 256;                  // every hidden layer's width
constexpr int kOut = 3;
constexpr int kCorners = 4;
constexpr int kLayers = 3;                    // W_1..W_3 on the tensor cores
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kQueries = 16;                  // queries a warpgroup
constexpr int kRows = kCorners * kQueries;    // a warpgroup's rows: 64
constexpr int kTile = kConsumers * kQueries;  // queries a CTA's tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kHalfN = kHidden / 2;           // one wgmma's N
constexpr int kPairs = kHidden / 16;          // pairs of k8 steps a layer
// slabs a layer, in the order the producer streams them: (k8 step,
// half); a slab is one k8 step of 128 columns, hi then lo
// (kernels/liif_decoder.py, weight_slabs); the consumers read a pair of k8
// steps' four slabs half by half
constexpr int kSlabsPerLayer = kPairs * 2 * 2;
constexpr int kSlabFloats = kHalfN * 16;
constexpr uint32_t kSlabBytes = kSlabFloats * 4;
constexpr int kRing = 8;                      // slabs in flight
constexpr int kEmptyArrivals = 4 * kConsumers;  // one a consumer warp
// registers a thread after setmaxnreg: 128 * (40 + 2 * 232) <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kWgBar = 1;                     // named barrier 1 + warpgroup
constexpr int kLd = kHidden + 4;              // activation tile row stride

// The small operands (floats), as the wrapper packs them (small_operands):
// W_rel's two columns, b_rel, W_cell's two columns, b_1..b_3, W_4 (row c
// at kW4 + 256 c) and b_4.
constexpr int kWr0 = 0;
constexpr int kWr1 = kWr0 + kHidden;
constexpr int kBr = kWr1 + kHidden;
constexpr int kWc0 = kBr + kHidden;
constexpr int kWc1 = kWc0 + kHidden;
constexpr int kB1 = kWc1 + kHidden;           // b_l at kB1 + 256 (l - 1)
constexpr int kW4 = kB1 + kLayers * kHidden;
constexpr int kB4 = kW4 + kOut * kHidden;
constexpr int kSmallFloats = kB4 + 4;

// Shared memory, byte offsets: the ring's barriers, the small operands,
// the cell part (cell @ W_cell), each warpgroup's row table (z offset, ry,
// rx) and blend buffer (pred, area), the activation tiles, the ring.
constexpr int kFull = 0;
constexpr int kEmpty = kFull + kRing * 8;
constexpr int kSmall = kEmpty + kRing * 8;
constexpr int kCell = kSmall + kSmallFloats * 4;
constexpr int kMeta = kCell + kHidden * 4;
constexpr int kMetaBytes = kRows * (8 + 4 + 4 + 4 * 4);
constexpr int kA = (kMeta + kConsumers * kMetaBytes + 127) / 128 * 128;
constexpr int kRingOff = kA + kConsumers * kRows * kLd * 4;
constexpr int kSmem = kRingOff + kRing * static_cast<int>(kSlabBytes);
static_assert((kRing & (kRing - 1)) == 0, "ring of a power of two");
static_assert(kSmem <= 232448, "shared memory");

// The kernel's arguments. z is (batch, h_in, w_in, kHidden); corner k's
// index vectors iy[k] (h_c) and ix[k] (w_c), int64 where idx64 else int32,
// and rel vectors ry[k], rx[k]; the chunk's query (b, y, x) writes
// out[b * out_sb + y * out_sy + 3 x + c].
struct Params {
  const float* z;
  const void* iy[kCorners];
  const float* ry[kCorners];
  const void* ix[kCorners];
  const float* rx[kCorners];
  const float* cell;    // (2,)
  const float* small;   // kSmallFloats
  const float* wslab;   // kLayers * kSlabsPerLayer slabs
  float* out;
  long long out_sb, out_sy;
  int batch, h_in, w_in, h_c, w_c, idx64;
};

__device__ __forceinline__ long long index_at(const void* v, int i,
                                              int idx64) {
  return idx64 ? static_cast<const long long*>(v)[i]
               : static_cast<long long>(static_cast<const int*>(v)[i]);
}

// Named barrier `id` (1..15) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
#elif !defined(__CUDACC__)
  host_bar_sync(id, count);
#endif
}

// The warp's lanes order their shared-memory accesses (the host harness's
// lanes run apart: its hook holds them at a barrier).
__device__ __forceinline__ void warp_sync() {
#if defined(__CUDA_ARCH__)
  __syncwarp();
#elif !defined(__CUDACC__)
  host_warp_sync();
#endif
}

__device__ __forceinline__ float4 load4(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(reinterpret_cast<const float4*>(p));
#else
  return *reinterpret_cast<const float4*>(p);
#endif
}

__device__ __forceinline__ float4 load4_shared(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Layer 0 at one element: relu((z + (rel @ W_rel + b_rel)) + cell part),
// in the torch path's order of sums.
__device__ __forceinline__ float layer0(float z, float ry, float rx, float w0,
                                        float w1, float b, float c) {
  return fmaxf(z + (fmaf(rx, w1, ry * w0) + b) + c, 0.f);
}

__device__ __forceinline__ float4 layer0_4(float4 z, float ry, float rx,
                                           float4 w0, float4 w1, float4 b,
                                           float4 c) {
  return make_float4(layer0(z.x, ry, rx, w0.x, w1.x, b.x, c.x),
                     layer0(z.y, ry, rx, w0.y, w1.y, b.y, c.y),
                     layer0(z.z, ry, rx, w0.z, w1.z, b.z, c.z),
                     layer0(z.w, ry, rx, w0.w, w1.w, b.w, c.w));
}

__global__ void __launch_bounds__(kThreads, 1)
    query_mlp_3xtf32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem_raw + kEmpty);
  float* small = reinterpret_cast<float*>(smem_raw + kSmall);
  float* cellw = reinterpret_cast<float*>(smem_raw + kCell);
  float* ring = reinterpret_cast<float*>(smem_raw + kRingOff);
  const int tid = threadIdx.x;
  const long long n_query =
      static_cast<long long>(p.batch) * p.h_c * p.w_c;
  const long long n_tiles = (n_query + kTile - 1) / kTile;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kEmptyArrivals);
    }
  }
  for (int i = tid; i < kSmallFloats; i += kThreads) small[i] = p.small[i];
  {
    const float c0 = p.cell[0], c1 = p.cell[1];
    for (int j = tid; j < kHidden; j += kThreads)
      cellw[j] = fmaf(c1, p.small[kWc1 + j], c0 * p.small[kWc0 + j]);
  }
  __syncthreads();

  // the producer: every slab of every tile of this CTA, in the order of
  // weight_slabs, into ring slot n % kRing once both warpgroups have
  // released its previous use
  const int role = warpgroup_uniform();
  if (role == 0) {
    set_max_regs_dec<kProducerRegs>();
    if (tid == 0) {
      uint32_t n = 0;
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int s = 0; s < kLayers * kSlabsPerLayer; ++s, ++n) {
          const int slot = n & (kRing - 1);
          mbar_wait_loop(empty + slot, ((n / kRing) & 1u) ^ 1u);
          bulk_load(ring + slot * kSlabFloats,
                    p.wslab + static_cast<long long>(s) * kSlabFloats,
                    kSlabBytes, full + slot);
        }
    }
    return;
  }

  // a consumer warpgroup: queries wg * 16 .. wg * 16 + 15 of each tile;
  // warp k of it corner k, rows 16 k .. 16 k + 15 of its tile (query
  // q at row 16 k + q); a thread the accumulator elements of wgmma's
  // layout (rows 16 k + gid (+ 8), columns 8 i + 2 tig (+ 1))
  set_max_regs_inc<kConsumerRegs>();
  const int wg = role - 1;
  const int lt = tid & 127;
  const int lane = tid & 31;
  const int warp = lt >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = warp * kQueries;
  unsigned char* meta = smem_raw + kMeta + wg * kMetaBytes;
  long long* zoff = reinterpret_cast<long long*>(meta);
  float* rys = reinterpret_cast<float*>(meta + kRows * 8);
  float* rxs = rys + kRows;
  float* pred = rxs + kRows;  // (row, [pred 0..2, area])
  float* a = reinterpret_cast<float*>(smem_raw + kA) + wg * kRows * kLd;
  const int my_bar = kWgBar + wg;
  uint32_t n = 0;  // slabs read so far

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long q0 = tile * kTile + wg * kQueries;

    // 1) the warp's rows: corner `warp` of queries q0 .. q0 + 15, each
    //    one's z offset and rel (a query past the end reads the first z
    //    row, and writes nothing)
    if (lane < kQueries) {
      const long long qi = q0 + lane;
      long long off = 0;
      float ry = 0.f, rx = 0.f;
      if (qi < n_query) {
        const int x = static_cast<int>(qi % p.w_c);
        const long long t = qi / p.w_c;
        const int y = static_cast<int>(t % p.h_c);
        const long long b = t / p.h_c;
        off = ((b * p.h_in + index_at(p.iy[warp], y, p.idx64)) * p.w_in +
               index_at(p.ix[warp], x, p.idx64)) *
              kHidden;
        ry = p.ry[warp][y];
        rx = p.rx[warp][x];
      }
      zoff[wrow0 + lane] = off;
      rys[wrow0 + lane] = ry;
      rxs[wrow0 + lane] = rx;
    }
    warp_sync();

    // 2) layer 0 into the activation tile: lane l takes columns 4 l ..
    //    4 l + 3 and 128 + 4 l .. of each of the warp's rows, whose z rows
    //    load all at once
    {
      float4 zz[kQueries][2];
#pragma unroll
      for (int r = 0; r < kQueries; ++r) {
        const float* zr = p.z + zoff[wrow0 + r] + 4 * lane;
        zz[r][0] = load4(zr);
        zz[r][1] = load4(zr + kHalfN);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = h * kHalfN + 4 * lane;
        const float4 w0 = load4_shared(small + kWr0 + j);
        const float4 w1 = load4_shared(small + kWr1 + j);
        const float4 bb = load4_shared(small + kBr + j);
        const float4 cc = load4_shared(cellw + j);
#pragma unroll
        for (int r = 0; r < kQueries; ++r) {
          const int m = wrow0 + r;
          *reinterpret_cast<float4*>(a + m * kLd + j) =
              layer0_4(zz[r][h], rys[m], rxs[m], w0, w1, bb, cc);
        }
      }
    }
    warp_sync();

    // 3) W_1..W_3: each pair of k8 steps' products per half into a fresh
    //    accumulator, then the epilogue: bias and relu back into the tile
    //    (W_1, W_2), or bias, relu and W_4 (W_3)
    float o[2][kOut];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < kOut; ++c) o[hh][c] = 0.f;
#pragma unroll 1
    for (int layer = 0; layer < kLayers; ++layer) {
      float acc[kHidden / 2];
#pragma unroll
      for (int i = 0; i < kHidden / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int pr = 0; pr < kPairs; ++pr) {
        Tf32::Frag f[2];
        Tf32::load_frag<kLd>(a, wrow0, 16 * pr, gid, tig, f[0]);
        Tf32::load_frag<kLd>(a, wrow0, 16 * pr + 8, gid, tig, f[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // k8 step 2 pr (+ 1) of half h: slab n + h (+ 2)
          const uint32_t n0 = n + h;
          const uint32_t n1 = n0 + 2;
          const int s0 = n0 & (kRing - 1);
          const int s1 = n1 & (kRing - 1);
          mbar_wait_loop(full + s0, (n0 / kRing) & 1u);
          mbar_wait_loop(full + s1, (n1 / kRing) & 1u);
          float t[kHalfN / 2];
          wgmma_fence();
          Tf32::mma<kHalfN, true>(t, f[0], ring + s0 * kSlabFloats);
          Tf32::mma<kHalfN, false>(t, f[1], ring + s1 * kSlabFloats);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(t);
          Tf32::fence_frag(f[0]);
          Tf32::fence_frag(f[1]);
#pragma unroll
          for (int i = 0; i < kHalfN / 2; ++i) acc[h * kHalfN / 2 + i] += t[i];
          mbar_arrive_if(empty + s0, lane == 0);
          mbar_arrive_if(empty + s1, lane == 0);
        }
        n += 4;
      }
      const float* bias = small + kB1 + layer * kHidden;
      if (layer + 1 < kLayers) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < kHalfN / 8; ++i) {
            const int j = h * kHalfN + 8 * i + 2 * tig;
            const float2 bb = load2(bias + j);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int c = h * kHalfN / 2 + 4 * i + 2 * hh;
              store2(a + (wrow0 + gid + 8 * hh) * kLd + j,
                     fmaxf(acc[c] + bb.x, 0.f), fmaxf(acc[c + 1] + bb.y, 0.f));
            }
          }
        warp_sync();
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < kHalfN / 8; ++i) {
            const int j = h * kHalfN + 8 * i + 2 * tig;
            const float2 bb = load2(bias + j);
            float2 w4[kOut];
#pragma unroll
            for (int c = 0; c < kOut; ++c)
              w4[c] = load2(small + kW4 + c * kHidden + j);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int e = h * kHalfN / 2 + 4 * i + 2 * hh;
              const float v0 = fmaxf(acc[e] + bb.x, 0.f);
              const float v1 = fmaxf(acc[e + 1] + bb.y, 0.f);
#pragma unroll
              for (int c = 0; c < kOut; ++c)
                o[hh][c] = fmaf(v1, w4[c].y, fmaf(v0, w4[c].x, o[hh][c]));
            }
          }
      }
    }
    // the row's W_4 sums over the four lanes that hold its columns
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        o[hh][c] += __shfl_xor_sync(0xffffffffu, o[hh][c], 1);
        o[hh][c] += __shfl_xor_sync(0xffffffffu, o[hh][c], 2);
      }

    // 4) the blend: each row's prediction and area into the warpgroup's
    //    buffer, then one thread a query sums its four corners in the torch
    //    path's order into the output
    bar_sync(my_bar, 128);  // the last tile's blend has read the buffer
    if (tig == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wrow0 + gid + 8 * hh;
#pragma unroll
        for (int c = 0; c < kOut; ++c)
          pred[m * 4 + c] = o[hh][c] + small[kB4 + c];
        pred[m * 4 + 3] = fabsf(rys[m] * rxs[m]) + 1e-9f;
      }
    }
    bar_sync(my_bar, 128);
    if (lt < kQueries) {
      const long long qi = q0 + lt;
      if (qi < n_query) {
        const int x = static_cast<int>(qi % p.w_c);
        const long long t = qi / p.w_c;
        const int y = static_cast<int>(t % p.h_c);
        const long long b = t / p.h_c;
        float ar[kCorners];
#pragma unroll
        for (int k = 0; k < kCorners; ++k)
          ar[k] = pred[(k * kQueries + lt) * 4 + 3];
        const float tot = __fadd_rn(__fadd_rn(__fadd_rn(ar[3], ar[2]), ar[1]),
                                    ar[0]);
        float wk[kCorners];
#pragma unroll
        for (int k = 0; k < kCorners; ++k)
          wk[k] = __fdiv_rn(ar[kCorners - 1 - k], tot);
        float* dst = p.out + b * p.out_sb + y * p.out_sy + 3LL * x;
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          float v = __fmul_rn(pred[lt * 4 + c], wk[0]);
#pragma unroll
          for (int k = 1; k < kCorners; ++k)
            v = __fadd_rn(v, __fmul_rn(pred[(k * kQueries + lt) * 4 + c],
                                       wk[k]));
          dst[c] = v;
        }
      }
    }
  }
}

// The launch: a persistent grid of at most `max_ctas` CTAs (the card's SM
// count) over the chunk's tiles of kTile queries. `launch(kernel, grid,
// block, smem, args...)` is the caller's (hopper_chain::CudaLaunch on the
// card). Returns its error (0 = launched).
template <class Launch>
int run_decode(Launch& launch, const Params& p, int max_ctas) {
  const long long n_query = static_cast<long long>(p.batch) * p.h_c * p.w_c;
  if (n_query == 0) return 0;
  const long long tiles = (n_query + kTile - 1) / kTile;
  const long long grid = tiles < max_ctas ? tiles : max_ctas;
  return launch(query_mlp_3xtf32_kernel, dim3(static_cast<unsigned>(grid)),
                dim3(kThreads), kSmem, p);
}

}  // namespace liif_decoder
