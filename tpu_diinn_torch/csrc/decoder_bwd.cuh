// Device code of the fused DIINN mode-3 decoder backward on the tensor
// cores (sm_90a), in fp32 accuracy (Tf32) or the bf16 mode (Bf16).
//
// The VJP of the chain of hopper_chain.cuh for an upstream gradient g
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
// 3xTF32 scheme (hopper_chain.cuh), which keeps fp32-level error. The
// chain's weights come split from the wrapper in wgmma's shared-memory B
// layout (kernels/decoder_fused.py, mma_b_slabs) and stream in by TMA bulk
// copies into an mbarrier-guarded ring; the activations are split in
// registers as wgmma's A. The weight-gradient kernel splits both of its
// operands itself.
//
// The recomputed forward is hopper_chain.cuh's chain_forward, the routine
// the forward kernels run, so it computes the forward's q bit for bit.
//
// In the Bf16 policy (the JAX package's bf16 mode, its _chain_bwd and
// _bwd_kernel_int) every product takes bf16 operands and sums in fp32: the
// recomputed forward as the forward kernels run it; dq = bf16(g) @ Wl^T
// and bf16(d) @ [Wkq | Wq]^T; dWcat = q^T bf16(d), dW0 = bf16(syn)^T
// bf16(dpre_0) and dWl = q^T bf16(g), q already bf16. The elementwise
// work, the bias gradients (sums of the unrounded d, dpre_0 and g) and the
// scratch stay fp32; dz sums in fp32 and is rounded to bf16 once, as it
// is stored.

#pragma once

#include <cstdint>
#include <type_traits>

#include "hopper_chain.cuh"

namespace decoder_bwd {

using namespace hopper_chain;

constexpr int kSplitRows = 2048;   // queries per weight-gradient split
constexpr int kSliceM = 32;        // queries per wgrad shared-memory stage
constexpr int kWgradStages = 3;
constexpr int kThinThreads = 256;
constexpr int kThinWarps = kThinThreads / 32;
constexpr int kThinSmem = kThinWarps * 5 * 32 * 4;

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

// Recompute and backprop the chain for one tile of kTileM queries.
// wslab and wtslab hold each layer's [Wkq | Wq] (H x 2H) and its
// transpose (2H x H) as wgmma B slabs (mma_b_slabs in the wrapper), in
// the policy P's type, as z, w0 and wl.
template <int kNC, bool kWindow, class P>
__global__ void __launch_bounds__(kThreads, 1)
decode_bwd_chain_kernel(const typename P::Z* __restrict__ z,
                        const float* __restrict__ syn,
                        const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const typename P::W* __restrict__ w0,
                        const float* __restrict__ b0,
                        const typename P::W* __restrict__ wslab,
                        const float* __restrict__ bcat,
                        const typename P::W* __restrict__ wl,
                        const typename P::W* __restrict__ wtslab,
                        const float* __restrict__ g,
                        float* __restrict__ scratch, int batch, int h_in,
                        int w_in, int h_out, int w_out, int s_h, int s_w,
                        int n_layers) {
  constexpr int kHidden = kNC * 32;
  using T = ChainTiling<kHidden, P>;
  using A = typename P::A;
  using W = typename P::W;
  constexpr int kNB = T::kND / 8;     // n8 blocks a thread holds in dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* zoff = reinterpret_cast<long long*>(smem_raw);
  float* synv = reinterpret_cast<float*>(smem_raw + kTileM * 8);
  float* gv = synv + kTileM * 3;
  A* q_cur = reinterpret_cast<A*>(smem_raw + T::kHead);
  A* q_next = q_cur + kTileM * T::kLdQ;
  A* dtile = q_cur;

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
  W* ring_f = reinterpret_cast<W*>(smem_raw + T::kRingF) +
              wg * kStages * T::kSlabF;
  W* ring_d = reinterpret_cast<W*>(smem_raw + T::kRingD) +
              wg * kStages * T::kSlabD;
  uint32_t phase = 0;
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileM;
  const long long layer_floats = n_query * kHidden;
  const Plan plan(n_query, kHidden, n_layers);
  float* sq = scratch + plan.s_q;
  float* sk = scratch + plan.s_k;
  float* sa = scratch + plan.s_a;
  float* sdb = scratch + plan.s_db;
  float* sp0 = scratch + plan.s_p0;
  float* sz0 = scratch + plan.s_z0;

  // 1) each query's LR pixel (-1 past the ragged edge), syn and g (g as
  //    the dq product's operand, rounded to the policy's type); the rings'
  //    barriers
  const long long qi = load_queries<kWindow, P>(
      zoff, synv, syn, rows, cols, batch, h_in, w_in, h_out, w_out, s_h, s_w,
      static_cast<long long>(n_layers) * kHidden);
  if (tid < kTileM) {
#pragma unroll
    for (int o = 0; o < 3; ++o)
      gv[tid * 3 + o] = qi >= 0 ? P::round(g[qi * 3 + o]) : 0.f;
  }
  if (tid == 0) {
    uint64_t* all = reinterpret_cast<uint64_t*>(smem_raw + T::kBars);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(all + i, 1);
  }
  __syncthreads();

  // 2) and 3) the forward (chain_forward, as the forward kernels run it),
  //    storing q_i (i = 0..L-1), k_i and a_i (i >= 1) to the scratch
  chain_forward<P, kHidden, false>(
      zoff, synv, z, w0, b0, wslab, bcat, n_layers, q_cur, q_next, ring_f,
      bars, phase,
      [&](int layer, int, int m, int j, float q0, float q1, float k0,
          float k1, float a0, float a1) {
        const long long at = (tile0 + m) * kHidden + j;
        store2(sq + layer * layer_floats + at, q0, q1);
        if (layer > 0) {
          store2(sk + (layer - 1) * layer_floats + at, k0, k1);
          store2(sa + (layer - 1) * layer_floats + at, a0, a1);
        }
      });

  // The thread's dq elements (wgmma's layout for N = kND): n8 block i,
  // half hh, columns j, j + 1.
#define CHAIN_FOR_DQ_PAIRS                          \
  _Pragma("unroll") for (int i = 0; i < kNB; ++i)   \
  _Pragma("unroll") for (int hh = 0; hh < 2; ++hh)

  // 4) dq = g @ Wl^T at the thread's elements (registers from here on)
  float dq[T::kND / 2];
  CHAIN_FOR_DQ_PAIRS {
    const int m = wrow0 + gid + 8 * hh;
    const int j = jw + 8 * i + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      dq[4 * i + 2 * hh + e] =
          gv[m * 3 + 0] * P::to_float(wl[(j + e) * 3 + 0]) +
          gv[m * 3 + 1] * P::to_float(wl[(j + e) * 3 + 1]) +
          gv[m * 3 + 2] * P::to_float(wl[(j + e) * 3 + 2]);
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
          P::store_a2(dtile + m * T::kLdD + j, dk[0], dk[1]);
          P::store_a2(dtile + m * T::kLdD + kHidden + j, dp[0], dp[1]);
        }
    }
#pragma unroll
    for (int c = 0; c < T::kND / 2; ++c) dq[c] = 0.f;
    __syncthreads();  // publish the d tile
    wg_product<P, T::kND, 2 * kHidden, T::kLdD, false>(
        dq, dtile, wrow0,
        wtslab + (static_cast<long long>(layer - 1) *
                      (2 * kHidden / P::kK) * 2 + wg) * T::kSlabD,
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
    const float2 zz = P::load_z2(z + off + j);
    const float kv[2] = {fmaxf(zz.x, 0.f), fmaxf(zz.y, 0.f)};
    float p0[2], d0[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s, co;
      poly_sincos(pre0<P>(synv + m * 3, w0, b0, j + e, kHidden), s, co);
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
// that read LR pixel (b, r, c); band 0 is masked by z_0 > 0. The sum is
// fp32, stored in z's type (rounded once, for Bf16).
template <bool kWindow, class P>
__global__ void __launch_bounds__(256)
fold_dz_kernel(const typename P::Z* __restrict__ z,
               const int* __restrict__ rows, const int* __restrict__ cols,
               const float* __restrict__ scratch,
               typename P::Z* __restrict__ dz,
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
  if (band == 0 && !(P::to_float(z[pix * c_all + j]) > 0.f)) acc = 0.f;
  dz[idx] = P::from_float(acc);
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
// a fresh accumulator that is then added in fp32 (see 3xTF32 above). In
// the Bf16 policy both operands are rounded to bf16 on their way into the
// fragments and slabs, and a slice is two wgmma BF16 k16 steps; the column
// sums take the unrounded d.
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

template <int kHidden, class P>
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
  // h, r, c]; a warp writes 32 consecutive floats. Bf16: k16 step k16,
  // element (m = 16 k16 + 8 h + c, p = 8 g + r) at [g, h, r, c], a thread
  // writing pairs of c.
  auto transform = [&](int it) {
    if (it >= n_slices) return;
    const float* qs = stages + (it % kWgradStages) * T::kStage +
                      kSliceM * T::kLdD;
    if constexpr (!P::kBf16) {
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
    } else {
      uint32_t* slab = reinterpret_cast<uint32_t*>(slabs + (it & 1) *
                                                    T::kSlab);
      constexpr int kPairs = kSliceM * T::kTP / 2;
      static_assert(kPairs % T::kThreads == 0, "wgrad bf16 slab");
#pragma unroll
      for (int i = 0; i < kPairs / T::kThreads; ++i) {
        const int e = 2 * (tid + i * T::kThreads);
        const int c = e & 7;
        const int r = (e >> 3) & 7;
        const int h = (e >> 6) & 1;
        const int g = (e >> 7) % (T::kTP / 8);
        const int k16 = (e >> 7) / (T::kTP / 8);
        const float* src = qs + (16 * k16 + 8 * h + c) * T::kLdQ + 8 * g + r;
        slab[e >> 1] = pack_bf16(src[0], src[T::kLdQ]);
      }
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
    if (colsum && tid < T::kTN) {
#pragma unroll 8
      for (int r = 0; r < kSliceM; ++r) bsum += ds[r * T::kLdD + tid];
    }
    float t[T::kTP / 2];
    if constexpr (!P::kBf16) {
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
      const float* slab = slabs + (it & 1) * T::kSlab;
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
      wgmma_commit();
      transform(it + 1);  // meanwhile, into the other slab
      wgmma_wait<0>();
      fence_regs(t);
      // the products read ah and al until the wait: keep their registers
#pragma unroll
      for (int k8 = 0; k8 < kK8; ++k8) {
        fence_regs(ah[k8]);
        fence_regs(al[k8]);
      }
    } else {
      constexpr int kK16 = kSliceM / 16;
      uint32_t a16[kK16][4];
#pragma unroll
      for (int k16 = 0; k16 < kK16; ++k16) {
        // A = bf16(d)^T: a (n, k) = ds[k][n], pairs of k
        const float* ap = ds + (16 * k16 + 2 * tig) * T::kLdD + wrow0 + gid;
        a16[k16][0] = pack_bf16(ap[0], ap[T::kLdD]);
        a16[k16][1] = pack_bf16(ap[8], ap[T::kLdD + 8]);
        a16[k16][2] = pack_bf16(ap[8 * T::kLdD], ap[9 * T::kLdD]);
        a16[k16][3] = pack_bf16(ap[8 * T::kLdD + 8], ap[9 * T::kLdD + 8]);
      }
      const uint16_t* slab =
          reinterpret_cast<const uint16_t*>(slabs + (it & 1) * T::kSlab);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kK16; ++k16) {
        const uint16_t* b = slab + k16 * T::kTP * 16;
        if (k16 == 0)
          wgmma_bf16<T::kTP, true>(t, a16[k16], b);
        else
          wgmma_bf16<T::kTP, false>(t, a16[k16], b);
      }
      wgmma_commit();
      transform(it + 1);  // meanwhile, into the other slab
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int k16 = 0; k16 < kK16; ++k16) fence_regs(a16[k16]);
    }
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
// the warps' partials are added in warp order. With bf16 set, the product
// takes both factors rounded to bf16 (the column sums do not).
__global__ void __launch_bounds__(kThinThreads)
thin_kernel(const float* __restrict__ w, int ldw, int n_wide,
            const float* __restrict__ tm, int ldt, int nt, long long t_rows,
            long long n_query, float* __restrict__ part,
            long long part_stride, long long o_prod, int t_major,
            long long o_wsum, long long o_tsum, int bf16) {
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
      if (bf16) {
        const float vr = round_bf16(v);
        v5[0] = fmaf(round_bf16(trow[0]), vr, v5[0]);
        if (nt > 1) v5[1] = fmaf(round_bf16(trow[1]), vr, v5[1]);
        if (nt > 2) v5[2] = fmaf(round_bf16(trow[2]), vr, v5[2]);
      } else {
        v5[0] = fmaf(trow[0], v, v5[0]);
        if (nt > 1) v5[1] = fmaf(trow[1], v, v5[1]);
        if (nt > 2) v5[2] = fmaf(trow[2], v, v5[2]);
      }
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
template <int kNC, bool kWindow, class P, class Launch>
int run_bwd(Launch& launch, const typename P::Z* z, const float* syn,
            const int* rows, const int* cols, const typename P::W* w0,
            const float* b0, const typename P::W* wslab, const float* bcat,
            const typename P::W* wl, const typename P::W* wtslab,
            const float* g, typename P::Z* dz, float* grads, float* scratch,
            int batch, int h_in, int w_in, int h_out, int w_out, int s_h,
            int s_w, int n_layers) {
  constexpr int kHidden = kNC * 32;
  const long long m = static_cast<long long>(batch) * h_out * w_out;
  const Plan plan(m, kHidden, n_layers);
  int err = 0;
  if (m > 0) {
    err = launch(decode_bwd_chain_kernel<kNC, kWindow, P>,
                 static_cast<unsigned>((m + kTileM - 1) / kTileM), kThreads,
                 ChainTiling<kHidden, P>::kSmem, z, syn, rows, cols, w0, b0,
                 wslab, bcat, wl, wtslab, g, scratch, batch, h_in, w_in,
                 h_out, w_out, s_h, s_w, n_layers);
    if (err) return err;
  }
  const long long n_dz =
      static_cast<long long>(batch) * h_in * w_in * n_layers * kHidden;
  if (n_dz > 0) {
    err = launch(fold_dz_kernel<kWindow, P>,
                 static_cast<unsigned>((n_dz + 255) / 256), 256, 0, z, rows,
                 cols, static_cast<const float*>(scratch), dz, batch, h_in,
                 w_in, h_out, w_out, s_h, s_w, kHidden, n_layers);
    if (err) return err;
  }
  float* part = scratch + plan.s_part;
  if (m > 0 && n_layers > 1) {
    using W = WgradTiling<kHidden>;
    err = launch(wgrad_kernel<kHidden, P>,
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
                 m, part, plan.n_grad, plan.o_w0, 1, plan.o_b0, -1LL,
                 int{P::kBf16});
    if (err) return err;
    // dWl (H, 3) and dbl: W = q_{L-1}, T = g
    err = launch(thin_kernel, grid, kThinThreads, kThinSmem,
                 static_cast<const float*>(
                     scratch + plan.s_q +
                     static_cast<long long>(n_layers - 1) * m * kHidden),
                 kHidden, kHidden, g, 3, 3, m, m, part, plan.n_grad,
                 plan.o_wl, 0, -1LL, plan.o_bl, int{P::kBf16});
    if (err) return err;
  }
  return launch(reduce_kernel,
                static_cast<unsigned>((plan.n_grad + 255) / 256), 256, 0,
                static_cast<const float*>(part), plan.n_split, plan.n_grad,
                grads);
}

}  // namespace decoder_bwd
