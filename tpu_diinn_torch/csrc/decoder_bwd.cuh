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
// work is split into passes that each own their outputs.
//
// Tf32 (run_bwd_tf32):
//
// 1. decode_bwd_chain_kernel: per tile of kTileM queries, recompute the
//    chain and backprop it. The tile keeps q (forward) or d[kq | q]
//    (backward) in shared memory as the A operand of its products; the
//    per-query activations that the backprop and the reductions need (q_i,
//    k_i and a_i for i >= 1, d[kq | q]_i, dpre_0, dzt_0) go to a scratch
//    buffer in device memory (18,432 B a query at hidden 256, L = 4). k_0
//    and a_0 are recomputed from z and syn.
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
// Bf16 (run_bwd_bf16; the JAX package's bf16 mode, its _chain_bwd and
// _bwd_kernel_int): every product takes bf16 operands and sums in fp32;
// the elementwise work, the bias gradients (sums of the unrounded dqp,
// dpre_0 and g) and the dz folds are fp32, and dz is rounded to bf16 once.
// At 989 TFLOP/s the products bound the call at a sixth of the Tf32 time,
// which would leave the Tf32 design's bytes (about 55 KB a query through
// device memory) in charge, so it keeps little, and nothing per query in
// fp32 where it folds dz (PlanBf16):
//
// 1. decode_bwd_chain_bf16_kernel runs the forward of layers 0..L-2 only,
//    copying each q_i tile to the scratch in bf16 (lossless: q is rounded
//    to bf16 for its product anyway). Layer by layer from L-1 down it
//    recomputes k_i and a_i from q_{i-1} with the same routine and
//    operands as the forward (wg_product on the forward's weight slabs,
//    pass by pass), so they equal the forward's bit for bit; wgmma's
//    accumulator puts a pass's (m, j) of k and a in the thread that holds
//    dq's (m, j), so dkq and dqp form in registers. q_{i-1} comes back
//    from the scratch (still in L2) into shared memory; the d tile,
//    bf16(d) = bf16([dkq | dqp]), goes to the scratch as the weight
//    gradient's operand. That is 4,608 B a query at hidden 256, L = 4,
//    against 18,432, written by streaming stores (store16). The thin sums
//    (dW0, db0, dWl, dbl) and dbcat's q half are per-tile fp32 partials.
// 2. dz. The integer route orders a tile by LR pixel where s_h * s_w <=
//    kTileM, so that it holds kTileM / (s_h s_w) whole pixels
//    (16 at x2, 7 at x3 with one dead row, 4 at x4): the CTA stages dkq_i
//    (and dzt_0) in fp32 in shared memory, sums each pixel's queries in HR
//    row-major order, masks band 0 by z_0 > 0, rounds once and stores dz;
//    no other pass touches dz. Elsewhere (the window route, and s_h * s_w
//    > kTileM) the chain writes dkq_i and dzt_0 in fp32 (4,096 B a
//    query) and fold_dz_bf16_kernel sums them.
// 3. wgrad_bf16_kernel reads bf16 q and d as they are, on tiles of 128 p
//    by 256 n that read each operand twice; tile_sum_kernel adds the
//    per-tile partials of each split in order, and reduce_kernel the
//    splits. About 11 KB a query move through device memory in all.
//
// What bounds it, measured on the card (PERF.md): neither those bytes nor
// the products (their bound is 0.35 ms at x4, B 4, LR 48). The chain
// kernel, one CTA of 8 warps an SM, spends its time in latency: each
// 64-query tile streams 2 MB of weight slabs from L2 through a 4-slot
// ring a warpgroup, pair of k steps after pair, and its epilogues and
// column sums wait on loads and shuffles between the products.

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
constexpr int kSliceBf16 = 64;    // rows a Bf16 weight-gradient slice

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

// The Bf16 backward's scratch, in bytes. Its chain kernel runs n_tiles
// tiles of kTileM rows. Where the integer route's run of queries per LR
// pixel (run = s_h * s_w; 0 for the window route) fits a tile (fold), row
// r of tile t is query r % run of LR pixel t ppt + r / run (ppt = kTileM /
// run pixels a tile); otherwise row r of tile t is query t kTileM + r.
// Rows past the last query (or pixel) are dead and hold zeros. Per row:
// q_i (i = 0..L-2, bf16, hidden each) and bf16(d[kq | q]_i) (i = 1..L-1,
// 2 hidden each); without fold, per query, dzt_0 and dkq_i (fp32, hidden
// each, band by band). Then one partial of the gradient vector without
// dWcat per tile (thin: dW0, db0, dbcat, dWl, dbl at their offsets in
// grad less wcat), and one whole partial per split of kSplitRows rows
// (grad, the Tf32 layout over n_rows rows). b_thin is the bytes of the
// per-row and per-query sections.
struct PlanBf16 {
  bool fold;
  int ppt;
  long long n_tiles, n_rows;
  Plan grad;
  long long wcat, n_thin, t_wl, t_bl;
  long long b_q, b_d, b_dz, b_thin, b_part, b_total;

  __host__ __device__ static long long tiles(long long m, long long n_pix,
                                             int run) {
    if (run >= 1 && run <= kTileM) {
      const int per = kTileM / run;
      return (n_pix + per - 1) / per;
    }
    return (m + kTileM - 1) / kTileM;
  }

  __host__ __device__ PlanBf16(long long m, long long n_pix, int run,
                               int hidden, int n_layers)
      : grad(tiles(m, n_pix, run) * kTileM, hidden, n_layers) {
    const long long h = hidden;
    const long long l1 = n_layers - 1;
    fold = run >= 1 && run <= kTileM;
    ppt = fold ? kTileM / run : 0;
    n_tiles = tiles(m, n_pix, run);
    n_rows = n_tiles * kTileM;
    wcat = grad.o_bcat - grad.o_wcat;
    n_thin = grad.n_grad - wcat;
    t_wl = grad.o_wl - wcat;
    t_bl = grad.o_bl - wcat;
    b_q = 0;
    b_d = b_q + l1 * n_rows * h * 2;
    b_dz = b_d + l1 * n_rows * 2 * h * 2;
    b_thin = b_dz + (fold ? 0 : n_layers * m * h * 4);
    b_part = b_thin + (n_tiles * n_thin * 4 + 15) / 16 * 16;
    b_total = b_part + static_cast<long long>(grad.n_split) * grad.n_grad * 4;
  }
};

// Bytes of scratch one backward call needs (activations_only: its per-row
// and per-query sections, without the partial sums), for n_query queries
// reading n_pix LR pixels in runs of `run` (s_h * s_w; 0: the window).
inline long long scratch_bytes(long long n_query, long long n_pix, int run,
                               int hidden, int n_layers, bool bf16,
                               bool activations_only) {
  if (bf16) {
    const PlanBf16 plan(n_query, n_pix, run, hidden, n_layers);
    return activations_only ? plan.b_thin : plan.b_total;
  }
  const Plan plan(n_query, hidden, n_layers);
  return (activations_only ? plan.s_part : plan.s_total) * 4;
}

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
// fp32, stored in z's type.
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
  // h, r, c]; a warp writes 32 consecutive floats.
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
    if (colsum && tid < T::kTN) {
#pragma unroll 8
      for (int r = 0; r < kSliceM; ++r) bsum += ds[r * T::kLdD + tid];
    }
    float t[T::kTP / 2];
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

// ---------------------------------------------------------------------------
// The Bf16 backward (the top of the file, and PlanBf16).
// ---------------------------------------------------------------------------

// The sum over a warp's 16 rows of a column value that the thread holds
// for its rows gid and gid + 8 (wgmma's accumulator layout), those two
// already added: every lane of the same tig gets the same sum.
__device__ __forceinline__ float warp_rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// A 16-byte store of the chain kernel's scratch rows, which only a later
// kernel reads: streaming (evict first), so that the 4.6 KB a query that
// pass through L2 do not evict the weight slabs that every tile streams
// from it (plain stores make the chain kernel slower: PERF.md,
// tools/chain_split.py's bf16_plain_stores).
__device__ __forceinline__ void store16(void* p, float4 v) {
#if defined(__CUDA_ARCH__)
  __stcs(reinterpret_cast<float4*>(p), v);
#else
  *reinterpret_cast<float4*>(p) = v;
#endif
}

// As load_queries, for the integer route's tiles in LR pixel order
// (PlanBf16 with fold): row r of the CTA's tile is HR query u = r % run
// (row u / s_w, column u % s_w) of LR pixel blockIdx.x * ppt + r / run, -1
// past ppt pixels or the last pixel.
__device__ __forceinline__ long long load_pixel_queries(
    long long* zoff, float* synv, const float* __restrict__ syn, int batch,
    int h_in, int w_in, int s_h, int s_w, int ppt, long long c_all) {
  const int tid = threadIdx.x;
  if (tid >= kTileM) return -1;
  const int run = s_h * s_w;
  const int p = tid / run;
  const int u = tid - p * run;
  const long long pix = static_cast<long long>(blockIdx.x) * ppt + p;
  long long qi = -1, off = -1;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (p < ppt && pix < static_cast<long long>(batch) * h_in * w_in) {
    const int cx = static_cast<int>(pix % w_in);
    const long long t = pix / w_in;
    const int ry = static_cast<int>(t % h_in);
    const long long b = t / h_in;
    const int w_out = w_in * s_w;
    const int y = ry * s_h + u / s_w;
    const int x = cx * s_w + u % s_w;
    qi = (b * h_in * s_h + y) * w_out + x;
    off = pix * c_all;
    const float* sp = syn + (static_cast<long long>(y) * w_out + x) * 3;
    s0 = round_bf16(sp[0]);
    s1 = round_bf16(sp[1]);
    s2 = round_bf16(sp[2]);
  }
  zoff[tid] = off;
  synv[tid * 3 + 0] = s0;
  synv[tid * 3 + 1] = s1;
  synv[tid * 3 + 2] = s2;
  return qi;
}

// dz of the Bf16 backward where its chain kernel does not fold (the window
// route, and s_h * s_w > kTileM): fold_dz_kernel's sums over PlanBf16's
// fp32 dz section (band by band, hidden a query), eight channels of one
// pixel a thread (two 16-byte loads a query), so that the pixel's query
// ranges are found once for eight channels; each channel summed in
// fold_dz_kernel's order and rounded to bf16 once.
template <bool kWindow>
__global__ void __launch_bounds__(256)
fold_dz_bf16_kernel(const uint16_t* __restrict__ z,
                    const int* __restrict__ rows,
                    const int* __restrict__ cols,
                    const unsigned char* __restrict__ scratch,
                    uint16_t* __restrict__ dz, int batch, int h_in,
                    int w_in, int h_out, int w_out, int s_h, int s_w,
                    int hidden, int n_layers) {
  const long long c_all = static_cast<long long>(n_layers) * hidden;
  const long long c8 = c_all / 8;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * h_in * w_in * c8) return;
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  const PlanBf16 plan(n_query, 0, 0, hidden, n_layers);
  const int ch = static_cast<int>(idx % c8) * 8;
  const long long pix = idx / c8;
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
  const float* src = reinterpret_cast<const float*>(scratch + plan.b_dz) +
                     band * n_query * hidden + j;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int y = y0; y < y1; ++y) {
    const long long row = (b * h_out + y) * w_out;
    for (int x = x0; x < x1; ++x) {
      const float4* s = reinterpret_cast<const float4*>(src + (row + x) *
                                                        hidden);
      const float4 lo = s[0], hi = s[1];
      acc[0] += lo.x;
      acc[1] += lo.y;
      acc[2] += lo.z;
      acc[3] += lo.w;
      acc[4] += hi.x;
      acc[5] += hi.y;
      acc[6] += hi.z;
      acc[7] += hi.w;
    }
  }
  uint32_t out[4];
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    float v[2] = {acc[k], acc[k + 1]};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (band == 0 && !(bf16_float(z[pix * c_all + j + k + e]) > 0.f))
        v[e] = 0.f;
    out[k / 2] = pack_bf16(v[0], v[1]);
  }
  *reinterpret_cast<float4*>(dz + pix * c_all + ch) =
      make_float4(u2f(out[0]), u2f(out[1]), u2f(out[2]), u2f(out[3]));
}

// The Bf16 chain kernel's shared memory, in bytes: the query table (z
// offsets, syn, g rounded to bf16, g as given), the rings' barriers, one
// ring a warpgroup that the recompute's and the dq products share, the q
// tile, the d tile (the forward's second q tile), the fp32 staging of
// dkq_i (dzt_0) for the fold or the scratch (stride kLdF), and each row
// group's (warp % 4) column sums, up to four values a column (kRed).
template <int kHidden>
struct ChainBf16Tiling {
  using T = ChainTiling<kHidden, Bf16>;
  static constexpr int kSlab = T::kSlabF > T::kSlabD ? T::kSlabF : T::kSlabD;
  static constexpr int kLdF = kHidden + 8;
  static constexpr int kRed = 4 * kHidden;
  static constexpr int kSyn = kTileM * 8;
  static constexpr int kG = kSyn + kTileM * 3 * 4;
  static constexpr int kGu = kG + kTileM * 3 * 4;
  static constexpr int kBars = kGu + kTileM * 3 * 4;
  static constexpr int kRing = kBars + 2 * kStages * 8;
  static constexpr int kQ = kRing + 2 * kStages * kSlab * 2;
  static constexpr int kD = kQ + kTileM * T::kLdQ * 2;
  static constexpr int kFoldBuf = kD + kTileM * T::kLdD * 2;
  static constexpr int kRedBuf = kFoldBuf + kTileM * kLdF * 4;
  static constexpr int kSmem = kRedBuf + 4 * kRed * 4;
  static_assert(T::kLdQ <= T::kLdD && kSmem <= 232448, "chain bf16 tiling");
};

// The Bf16 chain: per tile of kTileM rows (PlanBf16's order), the forward
// of layers 0..L-2 storing q_i (bf16) to the scratch, then layer by layer
// from L-1 down k_i and a_i recomputed from q_{i-1}, d[kq | q]_i into the
// d tile (the dq product's A) and, bf16, the scratch; dz folded in the
// tile (kFold) or dkq_i and dzt_0 written in fp32 for
// fold_dz_bf16_kernel; the tile's thin partial (dW0, db0, dbcat's q half,
// dWl, dbl). Arguments as
// decode_bwd_chain_kernel's, with dz and the byte scratch.
template <int kNC, bool kWindow, bool kFold>
__global__ void __launch_bounds__(kThreads, 1)
decode_bwd_chain_bf16_kernel(
    const uint16_t* __restrict__ z, const float* __restrict__ syn,
    const int* __restrict__ rows, const int* __restrict__ cols,
    const uint16_t* __restrict__ w0, const float* __restrict__ b0,
    const uint16_t* __restrict__ wslab, const float* __restrict__ bcat,
    const uint16_t* __restrict__ wl, const uint16_t* __restrict__ wtslab,
    const float* __restrict__ g, uint16_t* __restrict__ dz,
    unsigned char* __restrict__ scratch, int batch, int h_in, int w_in,
    int h_out, int w_out, int s_h, int s_w, int n_layers) {
  using P = Bf16;
  constexpr int kHidden = kNC * 32;
  using T = ChainTiling<kHidden, P>;
  using S = ChainBf16Tiling<kHidden>;
  constexpr int kNB = T::kND / 8;    // n8 blocks a thread holds in dq
  constexpr int kNBP = T::kJB / 8;   // n8 blocks of a pass's k (a) columns
  constexpr int kRowChunks = kHidden / 8;  // 16-byte chunks of a q row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* zoff = reinterpret_cast<long long*>(smem_raw);
  float* synv = reinterpret_cast<float*>(smem_raw + S::kSyn);
  float* gv = reinterpret_cast<float*>(smem_raw + S::kG);
  float* gu = reinterpret_cast<float*>(smem_raw + S::kGu);
  uint16_t* qt = reinterpret_cast<uint16_t*>(smem_raw + S::kQ);
  uint16_t* dtile = reinterpret_cast<uint16_t*>(smem_raw + S::kD);
  float* fbuf = reinterpret_cast<float*>(smem_raw + S::kFoldBuf);
  float* red = reinterpret_cast<float*>(smem_raw + S::kRedBuf);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wg = warp >> 2;
  const int wrow0 = (warp & 3) * 16;
  const int jw = wg * (kHidden / 2);  // the warpgroup's first column
  const bool producer = (tid & 127) == 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + S::kBars) +
                   wg * kStages;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_raw + S::kRing) +
                   wg * kStages * S::kSlab;
  float* red_w = red + (warp & 3) * S::kRed;  // the warp's row group's sums
  uint32_t phase = 0;
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  const long long n_pix = static_cast<long long>(batch) * h_in * w_in;
  const int run = kWindow ? 0 : s_h * s_w;
  const PlanBf16 plan(n_query, n_pix, run, kHidden, n_layers);
  const long long tile = blockIdx.x;
  const long long row0 = tile * kTileM;
  const long long c_all = static_cast<long long>(n_layers) * kHidden;
  uint16_t* sq = reinterpret_cast<uint16_t*>(scratch + plan.b_q);
  uint16_t* sd = reinterpret_cast<uint16_t*>(scratch + plan.b_d);
  float* sdz = reinterpret_cast<float*>(scratch + plan.b_dz);
  float* thin = reinterpret_cast<float*>(scratch + plan.b_thin) +
                tile * plan.n_thin;
  auto q_row = [&](int layer, int m) {
    return sq + (layer * plan.n_rows + row0 + m) * kHidden;
  };
  // rows [0, n) of a tile in shared memory (row stride ld elements) to
  // consecutive rows of `width` elements at dst, 16 bytes a thread
  // (store16)
  auto copy_rows = [&](auto* dst, const auto* src, int ld, int width,
                       int n) {
    const int per = 16 / static_cast<int>(sizeof(*src));
    const int chunks = width / per;
    for (int c = tid; c < n * chunks; c += kThreads) {
      const int r = c / chunks;
      const int col = (c - r * chunks) * per;
      store16(dst + static_cast<long long>(r) * width + col,
              *reinterpret_cast<const float4*>(src + r * ld + col));
    }
  };

  // 1) each row's query, syn and g (rounded to bf16 as the products'
  //    operand, and as given for dbl); the rings' barriers
  long long qi;
  if constexpr (kFold)
    qi = load_pixel_queries(zoff, synv, syn, batch, h_in, w_in, s_h, s_w,
                            plan.ppt, c_all);
  else
    qi = load_queries<kWindow, P>(zoff, synv, syn, rows, cols, batch, h_in,
                                  w_in, h_out, w_out, s_h, s_w, c_all);
  if (tid < kTileM) {
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float v = qi >= 0 ? g[qi * 3 + o] : 0.f;
      gu[tid * 3 + o] = v;
      gv[tid * 3 + o] = P::round(v);
    }
  }
  if (tid == 0) {
    uint64_t* all = reinterpret_cast<uint64_t*>(smem_raw + S::kBars);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(all + i, 1);
  }
  __syncthreads();

  // 2) the forward of layers 0..L-2 (chain_forward, as the forward kernels
  //    run it), each q_i tile copied to the scratch (dead rows zero: the
  //    weight gradient reads every row); q_{L-2} ends in qt
  if (n_layers > 1) {
    uint16_t* q_even = n_layers % 2 == 0 ? qt : dtile;
    chain_forward<P, kHidden, false>(
        zoff, synv, z, w0, b0, wslab, bcat, n_layers - 1, q_even,
        q_even == qt ? dtile : qt, ring, bars, phase,
        [](int, int, int, int, float, float, float, float, float, float) {},
        [&](int layer, const uint16_t* tile) {
          copy_rows(q_row(layer, 0), tile, T::kLdQ, kHidden, kTileM);
        });
  }

  // 3) dq = g @ Wl^T at the thread's elements (wgmma's layout for N =
  //    kND: n8 block i, half hh, columns j, j + 1), registers from here on
  float dq[T::kND / 2];
#pragma unroll
  for (int i = 0; i < kNB; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = wrow0 + gid + 8 * hh;
      const int j = jw + 8 * i + 2 * tig;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dq[4 * i + 2 * hh + e] =
            gv[m * 3 + 0] * P::to_float(wl[(j + e) * 3 + 0]) +
            gv[m * 3 + 1] * P::to_float(wl[(j + e) * 3 + 1]) +
            gv[m * 3 + 2] * P::to_float(wl[(j + e) * 3 + 2]);
    }
  long long zrow[2];  // as chain_forward: a dead row reads the first z row
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long off = zoff[wrow0 + gid + 8 * hh];
    zrow[hh] = off >= 0 ? off : 0;
  }
  // the row groups' column sums, added in order, into the tile's partial:
  // sum column c < kHidden to thin[dst_a + c], the others to thin[dst_b +
  // c - kHidden]
  auto flush = [&](int n_cols, long long dst_a, long long dst_b) {
    for (int c = tid; c < n_cols; c += kThreads) {
      const float v = red[c] + red[S::kRed + c] + red[2 * S::kRed + c] +
                      red[3 * S::kRed + c];
      thin[c < kHidden ? dst_a + c : dst_b + (c - kHidden)] = v;
    }
  };
  // the staged dz terms of band `band`: with kFold, each pixel's queries
  // summed in HR row-major order into dz (band 0 masked by z_0 > 0);
  // else the tile's live rows (queries row0..) copied to the fp32 band at
  // sdz_band
  auto stage_out = [&](int band, float* sdz_band) {
    if constexpr (kFold) {
      for (int o = tid; o < plan.ppt * kHidden; o += kThreads) {
        const int p = o / kHidden;
        const int j = o - p * kHidden;
        const long long pix = tile * plan.ppt + p;
        if (pix >= n_pix) break;
        float acc = 0.f;
        for (int u = 0; u < run; ++u)
          acc += fbuf[(p * run + u) * S::kLdF + j];
        if (band == 0 && !(P::to_float(z[pix * c_all + j]) > 0.f)) acc = 0.f;
        dz[pix * c_all + band * kHidden + j] = P::from_float(acc);
      }
    } else {
      const long long live = n_query - row0;
      copy_rows(sdz_band + row0 * kHidden, fbuf, S::kLdF, kHidden,
                live < kTileM ? static_cast<int>(live) : kTileM);
    }
  };

  // 4) layers L-1..1: k_i and a_i recomputed pass by pass from q_{i-1}
  //    (qt) as chain_forward computes them, d[kq | q]_i formed in
  //    registers, then dq = d @ [Wkq | Wq]^T (K = 2H)
  for (int layer = n_layers - 1; layer >= 1; --layer) {
    const bool last = layer == n_layers - 1;
    const float* bq = bcat + static_cast<long long>(layer - 1) * 2 * kHidden +
                      kHidden;
    uint16_t* sd_layer = sd + (layer - 1) * plan.n_rows * 2 * kHidden;
    float* sdz_layer = sdz + layer * n_query * kHidden;
#pragma unroll
    for (int pass = 0; pass < T::kPasses; ++pass) {
      float acc[T::kNF / 2];
#pragma unroll
      for (int c = 0; c < T::kNF / 2; ++c) acc[c] = 0.f;
      wg_product<P, T::kNF, kHidden, T::kLdQ, false>(
          acc, qt, wrow0,
          wslab + ((static_cast<long long>(layer - 1) * T::kPasses + pass) *
                       (kHidden / P::kK) * 2 + wg) * T::kSlabF,
          2LL * T::kSlabF, ring, bars, phase, producer, lane);
      // acc blocks [0, kNBP): k columns; [kNBP, 2 kNBP): a columns
      const int j0 = jw + pass * T::kJB + 2 * tig;
      constexpr int kC = kNBP < 4 ? kNBP : 4;
#pragma unroll
      for (int i0 = 0; i0 < kNBP; i0 += kC) {
        float2 zz[kC][2], bb[kC];
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          bb[i] = load2(bq + j0 + 8 * (i0 + i));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            zz[i][hh] = P::load_z2(z + zrow[hh] + layer * kHidden + j0 +
                                   8 * (i0 + i));
        }
        float cs[kC][2], cw[kC][2][3];  // sums of dqp; of q_{L-1} bf16(g)
#pragma unroll
        for (int i = 0; i < kC; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            cs[i][e] = 0.f;
#pragma unroll
            for (int o = 0; o < 3; ++o) cw[i][e][o] = 0.f;
          }
#pragma unroll
        for (int i = 0; i < kC; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = wrow0 + gid + 8 * hh;
            const int j = j0 + 8 * (i0 + i);
            const int ck = 4 * (i0 + i) + 2 * hh;
            const int ca = 4 * (i0 + i + kNBP) + 2 * hh;
            const float kv[2] = {fmaxf(acc[ck] + zz[i][hh].x, 0.f),
                                 fmaxf(acc[ck + 1] + zz[i][hh].y, 0.f)};
            const float av[2] = {acc[ca] + bb[i].x, acc[ca + 1] + bb[i].y};
            float dk[2], dp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float s, co;
              poly_sincos(av[e], s, co);
              const float d = dq[4 * (pass * kNBP + i0 + i) + 2 * hh + e];
              dk[e] = kv[e] > 0.f ? d * s : 0.f;
              dp[e] = (d * kv[e]) * co;
              cs[i][e] += dp[e];
              if (last) {  // q_{L-1}, as the forward rounds it
                const float q = P::round(kv[e] * s);
#pragma unroll
                for (int o = 0; o < 3; ++o) cw[i][e][o] += q * gv[m * 3 + o];
              }
            }
            P::store_a2(dtile + m * T::kLdD + j, dk[0], dk[1]);
            P::store_a2(dtile + m * T::kLdD + kHidden + j, dp[0], dp[1]);
            store2(fbuf + m * S::kLdF + j, dk[0], dk[1]);
          }
#pragma unroll
        for (int i = 0; i < kC; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * (i0 + i) + e;
            const float v = warp_rows_sum(cs[i][e]);
            if (gid == 0) red_w[j] = v;
            if (last) {
#pragma unroll
              for (int o = 0; o < 3; ++o) {
                const float w = warp_rows_sum(cw[i][e][o]);
                if (gid == 0) red_w[kHidden + j * 3 + o] = w;
              }
            }
          }
      }
    }
    __syncthreads();  // the d tile, the staging and the sums are whole
    copy_rows(sd_layer + row0 * 2 * kHidden, dtile, T::kLdD, 2 * kHidden,
              kTileM);
    stage_out(layer, sdz_layer);
    if (layer >= 2) {  // q_{layer-2} into qt behind the products below
      for (int c = tid; c < kTileM * kRowChunks; c += kThreads) {
        const int r = c / kRowChunks;
        const int col = (c % kRowChunks) * 8;
        copy16_async(reinterpret_cast<float*>(qt + r * T::kLdQ + col),
                     reinterpret_cast<const float*>(q_row(layer - 2, r) +
                                                    col));
      }
      async_commit();
    }
    flush(last ? 4 * kHidden : kHidden,
          plan.grad.o_bcat - plan.wcat + (layer - 1) * 2 * kHidden + kHidden,
          plan.t_wl);
#pragma unroll
    for (int c = 0; c < T::kND / 2; ++c) dq[c] = 0.f;
    wg_product<P, T::kND, 2 * kHidden, T::kLdD, false>(
        dq, dtile, wrow0,
        wtslab + (static_cast<long long>(layer - 1) *
                      (2 * kHidden / P::kK) * 2 + wg) * T::kSlabD,
        2LL * T::kSlabD, ring, bars, phase, producer, lane);
    async_wait<0>();
    __syncthreads();  // qt holds q_{layer-2}; the tile buffers are free
  }

  // 5) layer 0: dpre_0 and dzt_0 with k_0 and a_0 recomputed; dpre_0
  //    staged in fp32 in the d tile (free now: kLdD bf16 is kHidden + 4
  //    floats a row), then db0 and dW0 = bf16(syn)^T bf16(dpre_0) summed
  //    a column a thread, rows in order
  float* pbuf = reinterpret_cast<float*>(dtile);
  constexpr int kLdP = T::kLdD / 2;
  constexpr int kC0 = kNB < 4 ? kNB : 4;
#pragma unroll
  for (int i0 = 0; i0 < kNB; i0 += kC0) {
    float2 zz[kC0][2];
#pragma unroll
    for (int i = 0; i < kC0; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        zz[i][hh] = P::load_z2(z + zrow[hh] + jw + 8 * (i0 + i) + 2 * tig);
#pragma unroll
    for (int i = 0; i < kC0; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wrow0 + gid + 8 * hh;
        const int j = jw + 8 * (i0 + i) + 2 * tig;
        const float kv[2] = {fmaxf(zz[i][hh].x, 0.f),
                             fmaxf(zz[i][hh].y, 0.f)};
        float p0[2], d0[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s, co;
          poly_sincos(pre0<P>(synv + m * 3, w0, b0, j + e, kHidden), s, co);
          const float d = dq[4 * (i0 + i) + 2 * hh + e];
          p0[e] = (d * kv[e]) * co;
          d0[e] = d * s;
        }
        store2(pbuf + m * kLdP + j, p0[0], p0[1]);
        store2(fbuf + m * S::kLdF + j, d0[0], d0[1]);
      }
  }
  __syncthreads();
  for (int j = tid; j < kHidden; j += kThreads) {
    float sb = 0.f, sw[3] = {0.f, 0.f, 0.f};
    for (int m = 0; m < kTileM; ++m) {
      const float v = pbuf[m * kLdP + j];
      sb += v;
      const float r = P::round(v);
#pragma unroll
      for (int c = 0; c < 3; ++c) sw[c] += synv[m * 3 + c] * r;
    }
    thin[plan.grad.o_b0 + j] = sb;
#pragma unroll
    for (int c = 0; c < 3; ++c) thin[plan.grad.o_w0 + c * kHidden + j] = sw[c];
  }
  if (tid < 3) {
    float s = 0.f;
    for (int m = 0; m < kTileM; ++m) s += gu[m * 3 + tid];
    thin[plan.t_bl + tid] = s;
  }
  stage_out(0, sdz);

  // 6) one layer only: dWl = q_0^T bf16(g), q_0 recomputed as the forward
  //    computes it
  if (n_layers == 1) {
#pragma unroll
    for (int i0 = 0; i0 < kNB; i0 += kC0) {
      float cw[kC0][2][3];
#pragma unroll
      for (int i = 0; i < kC0; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 0; o < 3; ++o) cw[i][e][o] = 0.f;
#pragma unroll
      for (int i = 0; i < kC0; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wrow0 + gid + 8 * hh;
          const int j = jw + 8 * (i0 + i) + 2 * tig;
          const float2 zz = P::load_z2(z + zrow[hh] + j);
          const float kv[2] = {fmaxf(zz.x, 0.f), fmaxf(zz.y, 0.f)};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float q = P::round(
                kv[e] * poly_sin(pre0<P>(synv + m * 3, w0, b0, j + e,
                                         kHidden)));
#pragma unroll
            for (int o = 0; o < 3; ++o) cw[i][e][o] += q * gv[m * 3 + o];
          }
        }
#pragma unroll
      for (int i = 0; i < kC0; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            const float v = warp_rows_sum(cw[i][e][o]);
            const int j = jw + 8 * (i0 + i) + 2 * tig + e;
            if (gid == 0) red_w[j * 3 + o] = v;
          }
    }
    __syncthreads();
    flush(3 * kHidden, plan.t_wl, plan.t_wl + kHidden);
  }
}

// The Bf16 weight gradient: for one split of kSplitRows rows of the
// scratch, wgrad_kernel's product dWcat_i^T = d_i^T q_{i-1} (the n x p
// tile (blockIdx.y, blockIdx.x), warpgroup w taking n rows 64w..64w+63, A
// = d^T from registers, B = q from shared memory; kSliceM-row slices
// through a kWgradStages-deep cp.async ring, each slice's q rewritten
// K-major into one of two slabs while the previous slice's products run),
// on the bf16 q and d as the chain kernel stores them: no rounding, one
// wgmma BF16 per k16 step summed straight into the accumulator, and tiles
// of 128 p by 256 n, so that each operand is read twice at hidden 256. No
// column sums: dbcat's q half sums the unrounded dqp in the chain kernel.
template <int kHidden>
struct WgradBf16Tiling {
  static constexpr int kTP = kHidden < 128 ? kHidden : 128;  // wgmma N
  static constexpr int kTN = 2 * kHidden < 256 ? 2 * kHidden : 256;
  static constexpr int kGroups = kTN / 64;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kLdD = kTN + 8;   // bf16 elements
  static constexpr int kLdQ = kTP + 8;
  static constexpr int kStage = kSliceBf16 * (kLdD + kLdQ);
  static constexpr int kSlab = kSliceBf16 * kTP;
  static constexpr int kSmem = (kWgradStages * kStage + 2 * kSlab) * 2;
  static_assert(kTN % 64 == 0 && kTP % 16 == 0, "wgrad tiling");
};

template <int kHidden>
__global__ void __launch_bounds__(WgradBf16Tiling<kHidden>::kThreads, 1)
wgrad_bf16_kernel(const uint16_t* __restrict__ q,
                  const uint16_t* __restrict__ d, long long n_rows,
                  int n_split, float* __restrict__ part,
                  long long part_stride, long long o_wcat) {
  using T = WgradBf16Tiling<kHidden>;
  constexpr int kN2 = 2 * kHidden;
  constexpr int kK16 = kSliceBf16 / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* slabs = stages + kWgradStages * T::kStage;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow0 = warp * 16;             // the warp's n rows in the tile
  const int layer = blockIdx.z / n_split;  // 0-based: dWcat_{layer + 1}
  const int split = blockIdx.z - layer * n_split;
  const int p0 = blockIdx.x * T::kTP;
  const int n0 = blockIdx.y * T::kTN;
  const long long m_begin = static_cast<long long>(split) * kSplitRows;
  const long long m_end =
      m_begin + kSplitRows < n_rows ? m_begin + kSplitRows : n_rows;
  const int n_slices = static_cast<int>((m_end - m_begin + kSliceBf16 - 1) /
                                        kSliceBf16);
  const uint16_t* ql = q + layer * n_rows * kHidden + p0;
  const uint16_t* dl = d + layer * n_rows * kN2 + n0;

  // rows [m0, m0 + kSliceBf16) of src (width values a row) into dst; rows
  // past the split's end are zero
  auto load_rows = [&](uint16_t* dst, int ld, const uint16_t* src,
                       long long lds, long long m0, auto width) {
    constexpr int kW = decltype(width)::value / 8;  // 16-byte chunks a row
    constexpr int kChunks = kSliceBf16 * kW;
    static_assert(kChunks % T::kThreads == 0, "wgrad chunks");
#pragma unroll
    for (int i = 0; i < kChunks / T::kThreads; ++i) {
      const int c = tid + i * T::kThreads;
      const int r = c / kW;
      const int col = (c % kW) * 8;
      float* to = reinterpret_cast<float*>(dst + r * ld + col);
      if (m0 + r < m_end)
        copy16_async(to, reinterpret_cast<const float*>(
                             src + (m0 + r) * lds + col));
      else
        *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // slice `it` into stage it % kWgradStages: d rows (kTN wide), then q
  // rows (kTP wide)
  auto load_slice = [&](int it) {
    if (it >= n_slices) return;
    uint16_t* ds = stages + (it % kWgradStages) * T::kStage;
    const long long m0 = m_begin + static_cast<long long>(it) * kSliceBf16;
    load_rows(ds, T::kLdD, dl, kN2, m0,
              std::integral_constant<int, T::kTN>());
    load_rows(ds + kSliceBf16 * T::kLdD, T::kLdQ, ql, kHidden, m0,
              std::integral_constant<int, T::kTP>());
  };
  // slice it's q into slab buffer it % 2 in the chain's bf16 B layout:
  // k16 step k16, element (m = 16 k16 + 8 h + c, p = 8 g + r) at [g, h, r,
  // c], a thread writing pairs of c
  auto transform = [&](int it) {
    if (it >= n_slices) return;
    const uint16_t* qs = stages + (it % kWgradStages) * T::kStage +
                         kSliceBf16 * T::kLdD;
    uint32_t* slab = reinterpret_cast<uint32_t*>(slabs + (it & 1) *
                                                 T::kSlab);
    constexpr int kPairs = kSliceBf16 * T::kTP / 2;
    static_assert(kPairs % T::kThreads == 0, "wgrad slab");
#pragma unroll
    for (int i = 0; i < kPairs / T::kThreads; ++i) {
      const int e = 2 * (tid + i * T::kThreads);
      const int c = e & 7;
      const int r = (e >> 3) & 7;
      const int h = (e >> 6) & 1;
      const int g = (e >> 7) % (T::kTP / 8);
      const int k16 = (e >> 7) / (T::kTP / 8);
      const uint16_t* src = qs + (16 * k16 + 8 * h + c) * T::kLdQ + 8 * g + r;
      slab[e >> 1] = src[0] | (static_cast<uint32_t>(src[T::kLdQ]) << 16);
    }
    fence_proxy_async();
  };

  float acc[T::kTP / 2];
#pragma unroll
  for (int c = 0; c < T::kTP / 2; ++c) acc[c] = 0.f;
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
    // written, and every thread is done with iteration it - 1
    __syncthreads();
    load_slice(it + kWgradStages - 1);
    async_commit();
    const uint16_t* ds = stages + (it % kWgradStages) * T::kStage;
    uint32_t a16[kK16][4];
#pragma unroll
    for (int k16 = 0; k16 < kK16; ++k16) {
      // A = d^T: a (n, k) = ds[k][n], pairs of k
      const uint16_t* ap = ds + (16 * k16 + 2 * tig) * T::kLdD + wrow0 + gid;
      auto pair = [](uint16_t lo, uint16_t hi) {
        return lo | (static_cast<uint32_t>(hi) << 16);
      };
      a16[k16][0] = pair(ap[0], ap[T::kLdD]);
      a16[k16][1] = pair(ap[8], ap[T::kLdD + 8]);
      a16[k16][2] = pair(ap[8 * T::kLdD], ap[9 * T::kLdD]);
      a16[k16][3] = pair(ap[8 * T::kLdD + 8], ap[9 * T::kLdD + 8]);
    }
    const uint16_t* slab = slabs + (it & 1) * T::kSlab;
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kK16; ++k16)
      wgmma_bf16<T::kTP, false>(acc, a16[k16], slab + k16 * T::kTP * 16);
    wgmma_commit();
    transform(it + 1);  // meanwhile, into the other slab
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int k16 = 0; k16 < kK16; ++k16) fence_regs(a16[k16]);
  }

  float* wout = part + split * part_stride + o_wcat +
                static_cast<long long>(layer) * kHidden * kN2;
#pragma unroll
  for (int i = 0; i < T::kTP / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + wrow0 + gid + 8 * (c >> 1);
      const int p = p0 + 8 * i + 2 * tig + (c & 1);
      wout[static_cast<long long>(p) * kN2 + n] = acc[4 * i + c];
    }
}

// part[split, grad index of e] = the sum over the split's tiles, in order,
// of the chain's thin partials thin[tile, e] (grad without dWcat: e at
// o_wcat and past it is grad's e + wcat); the kq halves of dbcat, which no
// tile writes, are 0.
__global__ void __launch_bounds__(256)
tile_sum_kernel(const float* __restrict__ thin, long long n_tiles,
                long long n_thin, long long wcat, int hidden, int n_layers,
                float* __restrict__ part, long long n_grad,
                long long o_wcat) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_thin) return;
  constexpr int kTiles = kSplitRows / kTileM;
  static_assert(kSplitRows % kTileM == 0, "whole tiles a split");
  const long long t0 = static_cast<long long>(blockIdx.y) * kTiles;
  const long long t1 = t0 + kTiles < n_tiles ? t0 + kTiles : n_tiles;
  const long long b = e - o_wcat;  // within dbcat
  const bool kq = b >= 0 &&
                  b < static_cast<long long>(n_layers - 1) * 2 * hidden &&
                  b % (2 * hidden) < hidden;
  float acc = 0.f;
  if (!kq)
    for (long long t = t0; t < t1; ++t) acc += thin[t * n_thin + e];
  part[blockIdx.y * n_grad + (e < o_wcat ? e : e + wcat)] = acc;
}

// The Bf16 backward as a sequence of launches (run_bwd's arguments, the
// scratch as PlanBf16's bytes).
template <int kNC, bool kWindow, class Launch>
int run_bwd_bf16(Launch& launch, const uint16_t* z, const float* syn,
                 const int* rows, const int* cols, const uint16_t* w0,
                 const float* b0, const uint16_t* wslab, const float* bcat,
                 const uint16_t* wl, const uint16_t* wtslab, const float* g,
                 uint16_t* dz, float* grads, unsigned char* scratch,
                 int batch, int h_in, int w_in, int h_out, int w_out,
                 int s_h, int s_w, int n_layers) {
  constexpr int kHidden = kNC * 32;
  const long long m = static_cast<long long>(batch) * h_out * w_out;
  const long long n_pix = static_cast<long long>(batch) * h_in * w_in;
  const PlanBf16 plan(m, n_pix, kWindow ? 0 : s_h * s_w, kHidden, n_layers);
  const Plan& gp = plan.grad;
  int err = 0;
  if (plan.n_tiles > 0) {
    const unsigned grid = static_cast<unsigned>(plan.n_tiles);
    // the window route never folds (run 0): <kNC, true, false> either way
    if (plan.fold)
      err = launch(decode_bwd_chain_bf16_kernel<kNC, kWindow, !kWindow>,
                   grid, kThreads, ChainBf16Tiling<kHidden>::kSmem,
                   z, syn, rows, cols, w0, b0, wslab, bcat, wl, wtslab, g, dz,
                   scratch, batch, h_in, w_in, h_out, w_out, s_h, s_w,
                   n_layers);
    else
      err = launch(decode_bwd_chain_bf16_kernel<kNC, kWindow, false>, grid,
                   kThreads, ChainBf16Tiling<kHidden>::kSmem, z, syn,
                   rows, cols, w0, b0, wslab, bcat, wl, wtslab, g, dz,
                   scratch, batch, h_in, w_in, h_out, w_out, s_h, s_w,
                   n_layers);
    if (err) return err;
  }
  const long long n_dz8 = n_pix * n_layers * kHidden / 8;
  if (!plan.fold && n_dz8 > 0) {
    err = launch(fold_dz_bf16_kernel<kWindow>,
                 static_cast<unsigned>((n_dz8 + 255) / 256), 256, 0, z, rows,
                 cols, static_cast<const unsigned char*>(scratch), dz, batch,
                 h_in, w_in, h_out, w_out, s_h, s_w, kHidden, n_layers);
    if (err) return err;
  }
  float* part = reinterpret_cast<float*>(scratch + plan.b_part);
  if (plan.n_tiles > 0 && n_layers > 1) {
    using W = WgradBf16Tiling<kHidden>;
    err = launch(wgrad_bf16_kernel<kHidden>,
                 dim3(kHidden / W::kTP, 2 * kHidden / W::kTN,
                      gp.n_split * (n_layers - 1)),
                 W::kThreads, W::kSmem,
                 reinterpret_cast<const uint16_t*>(scratch + plan.b_q),
                 reinterpret_cast<const uint16_t*>(scratch + plan.b_d),
                 plan.n_rows, gp.n_split, part, gp.n_grad, gp.o_wcat);
    if (err) return err;
  }
  if (plan.n_tiles > 0) {
    err = launch(tile_sum_kernel,
                 dim3(static_cast<unsigned>((plan.n_thin + 255) / 256),
                      static_cast<unsigned>(gp.n_split)),
                 256, 0, reinterpret_cast<const float*>(scratch + plan.b_thin),
                 plan.n_tiles, plan.n_thin, plan.wcat, kHidden, n_layers,
                 part, gp.n_grad, gp.o_wcat);
    if (err) return err;
  }
  return launch(reduce_kernel, static_cast<unsigned>((gp.n_grad + 255) / 256),
                256, 0, static_cast<const float*>(part), gp.n_split,
                gp.n_grad, grads);
}

// The Tf32 backward as a sequence of launches (run_bwd's arguments).
template <int kNC, bool kWindow, class Launch>
int run_bwd_tf32(Launch& launch, const float* z, const float* syn,
                 const int* rows, const int* cols, const float* w0,
                 const float* b0, const float* wslab, const float* bcat,
                 const float* wl, const float* wtslab, const float* g,
                 float* dz, float* grads, float* scratch, int batch,
                 int h_in, int w_in, int h_out, int w_out, int s_h, int s_w,
                 int n_layers) {
  using P = Tf32;
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

// The whole backward as a sequence of launches. `launch(kernel, grid,
// block, smem, args...)` is the caller's: a CUDA launch on its stream, or
// a host emulation in a test harness. scratch: scratch_bytes(...) bytes,
// 16-byte aligned. Returns the first error.
template <int kNC, bool kWindow, class P, class Launch>
int run_bwd(Launch& launch, const typename P::Z* z, const float* syn,
            const int* rows, const int* cols, const typename P::W* w0,
            const float* b0, const typename P::W* wslab, const float* bcat,
            const typename P::W* wl, const typename P::W* wtslab,
            const float* g, typename P::Z* dz, float* grads, float* scratch,
            int batch, int h_in, int w_in, int h_out, int w_out, int s_h,
            int s_w, int n_layers) {
  if constexpr (P::kBf16)
    return run_bwd_bf16<kNC, kWindow>(
        launch, z, syn, rows, cols, w0, b0, wslab, bcat, wl, wtslab, g, dz,
        grads, reinterpret_cast<unsigned char*>(scratch), batch, h_in, w_in,
        h_out, w_out, s_h, s_w, n_layers);
  else
    return run_bwd_tf32<kNC, kWindow>(
        launch, z, syn, rows, cols, w0, b0, wslab, bcat, wl, wtslab, g, dz,
        grads, scratch, batch, h_in, w_in, h_out, w_out, s_h, s_w,
        n_layers);
}

}  // namespace decoder_bwd
