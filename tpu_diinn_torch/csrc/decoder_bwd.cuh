// Device code of the fused DIINN mode-3 decoder backward (fp32, sm_90a).
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
//    chain and backprop it. The tile keeps q (then dq) and one half of the
//    layer's d[kq | q] in shared memory; the per-query activations that the
//    reductions need (q_i, k_i, a_i, d[kq | q]_i, dpre_0, dzt_0) go to a
//    scratch buffer in device memory.
// 2. fold_dz_kernel: one thread per dz element sums the queries that read
//    its LR pixel. Nearest-exact indices are non-decreasing, so those
//    queries are one HR row range times one HR column range; each element
//    has one writer and no atomics are needed.
// 3. wgrad_kernel (dWcat, dbcat) and thin_kernel (dW0, db0, dWl, dbl):
//    each CTA reduces one split of kSplitRows queries into its own slice
//    of a partial buffer; reduce_kernel then sums the splits in a fixed
//    order. The weight gradients are deterministic.
//
// The polynomial sine and cosine are core/fastmath.py's (_poly_sincos):
// the same coefficients and Cody-Waite constants, copied here.

#pragma once

#include <cstdint>

#include "decoder_fused.cuh"

namespace decoder_bwd {

using decoder_fused::async_commit;
using decoder_fused::async_wait;
using decoder_fused::copy16_async;
using decoder_fused::kRowsPerWarp;
using decoder_fused::kSliceK;
using decoder_fused::kThreads;
using decoder_fused::kTileM;

constexpr int kGemmTile = 128;     // wgrad output tile (P x N)
constexpr int kGemmSliceM = 16;    // query rows per wgrad smem stage
constexpr int kSplitRows = 4096;   // queries per weight-gradient split
constexpr int kThinThreads = 256;
constexpr int kWgradSmem = 2 * 2 * kGemmSliceM * kGemmTile * 4;
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

// Where each piece of the backward lives, in floats. Per query and layer
// the chain stores q, k and a (hidden each) and d[kq | q] (2 * hidden);
// layer 0 adds dpre_0 and dzt_0. The weight gradients are one flat vector
// [dw0 (3H) | db0 (H) | dwcat ((L-1) H 2H) | dbcat ((L-1) 2H) | dwl (3H) |
// dbl (3)], and the partial buffer holds one such vector per split.
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
    s_a = s_k + n_layers * layer;
    s_db = s_a + n_layers * layer;
    s_p0 = s_db + l1 * 2 * layer;
    s_z0 = s_p0 + layer;
    s_part = s_z0 + layer;
    s_total = s_part + static_cast<long long>(n_split) * n_grad;
  }
};

// Stage rows [k0, k0 + kSliceK) of a row-major (rows x kWidth) matrix.
template <int kWidth>
__device__ __forceinline__ void stage_rows(float* dst, const float* w,
                                           int k0) {
  constexpr int kChunks = kSliceK * kWidth / 4;
  const float* src = w + static_cast<long long>(k0) * kWidth;
  for (int i = threadIdx.x; i < kChunks; i += kThreads)
    copy16_async(dst + 4 * i, src + 4 * i);
}

// Shared-memory bytes of one chain CTA.
__host__ __device__ constexpr int chain_smem_bytes(int hidden) {
  return kTileM * 8                               // z offsets (int64)
         + 2 * kTileM * 3 * 4                     // syn and g rows
         + 2 * kTileM * (hidden + 1) * 4          // q / dq tile, d tile
         + 2 * kSliceK * 2 * hidden * 4;          // weight ring
}

// acc[r][c] += A[row0 + r, :] @ W for the warp's rows and the lane's
// columns, where A (kTileM x kHidden, stride kHidden + 1) lies in shared
// memory and W (kHidden x kHidden, row-major) streams from global memory
// through the two-stage ring. Starts and ends with every thread past a
// barrier.
template <int kNC>
__device__ __forceinline__ void gemm_square(
    float (&acc)[kRowsPerWarp][kNC], const float* a_tile,
    const float* __restrict__ w, float* ring, int row0, int lane) {
  constexpr int kHidden = kNC * 32;
  constexpr int kStride = kHidden + 1;
  constexpr int kSlices = kHidden / kSliceK;
  stage_rows<kHidden>(ring, w, 0);
  async_commit();
  for (int s = 0; s < kSlices; ++s) {
    if (s + 1 < kSlices) {
      stage_rows<kHidden>(ring + ((s + 1) & 1) * kSliceK * kHidden, w,
                          (s + 1) * kSliceK);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    const float* wb = ring + (s & 1) * kSliceK * kHidden;
    const int k0 = s * kSliceK;
#pragma unroll
    for (int kk = 0; kk < kSliceK; ++kk) {
      float a[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        a[r] = a_tile[(row0 + r) * kStride + k0 + kk];
      float b[kNC];
#pragma unroll
      for (int c = 0; c < kNC; ++c) b[c] = wb[kk * kHidden + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// Recompute and backprop the chain for one tile of kTileM queries.
// wcat_t holds each layer's [Wkq | Wq] transposed: (L-1, 2H, H).
template <int kNC, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
decode_bwd_chain_kernel(const float* __restrict__ z,
                        const float* __restrict__ syn,
                        const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const float* __restrict__ w0,
                        const float* __restrict__ b0,
                        const float* __restrict__ wcat,
                        const float* __restrict__ bcat,
                        const float* __restrict__ wl,
                        const float* __restrict__ wcat_t,
                        const float* __restrict__ g,
                        float* __restrict__ scratch, int batch, int h_in,
                        int w_in, int h_out, int w_out, int s_h, int s_w,
                        int n_layers) {
  constexpr int kHidden = kNC * 32;
  constexpr int kN2 = 2 * kHidden;
  constexpr int kQStride = kHidden + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* zoff = reinterpret_cast<long long*>(smem_raw);
  float* synv = reinterpret_cast<float*>(smem_raw + kTileM * 8);
  float* gv = synv + kTileM * 3;
  float* qs = gv + kTileM * 3;           // q during the forward, then dq
  float* ds = qs + kTileM * kQStride;    // one half of d[kq | q]
  float* ring = reinterpret_cast<float*>(
      smem_raw + kTileM * 8 + 2 * kTileM * 3 * 4
      + 2 * kTileM * kQStride * 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kRowsPerWarp;
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

  // 1) each query's LR pixel (-1 past the ragged edge), syn and g
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
  __syncthreads();

  // 2) forward, layer 0 (as decode_fwd_kernel, plus the stores)
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int m = row0 + r;
    const long long off = zoff[m];
    const long long at = (tile0 + m) * kHidden;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int j = lane + 32 * c;
      float q = 0.f;
      if (off >= 0) {
        const float pre = synv[m * 3 + 0] * w0[j] +
                          synv[m * 3 + 1] * w0[kHidden + j] +
                          synv[m * 3 + 2] * w0[2 * kHidden + j] + b0[j];
        const float k = fmaxf(z[off + j], 0.f);
        q = k * decoder_fused::poly_sin(pre);
        sq[at + j] = q;
        sk[at + j] = k;
        sa[at + j] = pre;
      }
      qs[m * kQStride + j] = q;
    }
  }
  __syncthreads();

  // 3) forward, layers 1..L-1: [k | a] = q @ [Wkq | Wq] (+ z_i, + bq_i)
  constexpr int kSlices = kHidden / kSliceK;
  for (int layer = 1; layer < n_layers; ++layer) {
    const float* w_layer =
        wcat + static_cast<long long>(layer - 1) * kHidden * kN2;
    float acc_k[kRowsPerWarp][kNC];
    float acc_q[kRowsPerWarp][kNC];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        acc_k[r][c] = 0.f;
        acc_q[r][c] = 0.f;
      }
    stage_rows<kN2>(ring, w_layer, 0);
    async_commit();
    for (int s = 0; s < kSlices; ++s) {
      if (s + 1 < kSlices) {
        stage_rows<kN2>(ring + ((s + 1) & 1) * kSliceK * kN2, w_layer,
                        (s + 1) * kSliceK);
        async_commit();
        async_wait<1>();
      } else {
        async_wait<0>();
      }
      __syncthreads();
      const float* wb = ring + (s & 1) * kSliceK * kN2;
      const int k0 = s * kSliceK;
#pragma unroll
      for (int kk = 0; kk < kSliceK; ++kk) {
        float a[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          a[r] = qs[(row0 + r) * kQStride + k0 + kk];
        float bk[kNC], bq[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          bk[c] = wb[kk * kN2 + lane + 32 * c];
          bq[c] = wb[kk * kN2 + kHidden + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            acc_k[r][c] = fmaf(a[r], bk[c], acc_k[r][c]);
            acc_q[r][c] = fmaf(a[r], bq[c], acc_q[r][c]);
          }
      }
      __syncthreads();
    }
    const float* bq_layer =
        bcat + static_cast<long long>(layer - 1) * kN2 + kHidden;
    const long long lbase = layer * layer_floats;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int m = row0 + r;
      const long long off = zoff[m];
      const long long at = lbase + (tile0 + m) * kHidden;
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int j = lane + 32 * c;
        float q = 0.f;
        if (off >= 0) {
          const float k =
              fmaxf(acc_k[r][c] + z[off + layer * kHidden + j], 0.f);
          const float a = acc_q[r][c] + bq_layer[j];
          q = k * decoder_fused::poly_sin(a);
          sq[at + j] = q;
          sk[at + j] = k;
          sa[at + j] = a;
        }
        qs[m * kQStride + j] = q;
      }
    }
    __syncthreads();
  }

  // 4) dq = g @ Wl^T. Each thread reads and writes only its own (row,
  //    column) elements of qs from here on, until the GEMMs' barriers.
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int m = row0 + r;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int j = lane + 32 * c;
      qs[m * kQStride + j] = gv[m * 3 + 0] * wl[j * 3 + 0] +
                             gv[m * 3 + 1] * wl[j * 3 + 1] +
                             gv[m * 3 + 2] * wl[j * 3 + 2];
    }
  }

  // 5) layers L-1..1: d[kq | q] elementwise, then dq = d @ [Wkq | Wq]^T in
  //    two K = hidden passes, one per half
  for (int layer = n_layers - 1; layer >= 1; --layer) {
    const long long lbase = layer * layer_floats;
    float* db_layer = sdb + (layer - 1) * 2 * layer_floats;
    const float* wt_layer =
        wcat_t + static_cast<long long>(layer - 1) * kN2 * kHidden;
    float acc[kRowsPerWarp][kNC];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[r][c] = 0.f;
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int m = row0 + r;
        const long long qi = tile0 + m;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const int j = lane + 32 * c;
          float d = 0.f;
          if (zoff[m] >= 0) {
            const float k = sk[lbase + qi * kHidden + j];
            float s, co;
            poly_sincos(sa[lbase + qi * kHidden + j], s, co);
            const float dq = qs[m * kQStride + j];
            d = half == 0 ? (k > 0.f ? dq * s : 0.f) : (dq * k) * co;
            db_layer[qi * kN2 + half * kHidden + j] = d;
          }
          ds[m * kQStride + j] = d;
        }
      }
      // the barrier at the top of gemm_square publishes ds
      gemm_square<kNC>(acc, ds, wt_layer + half * kHidden * kHidden, ring,
                       row0, lane);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        qs[(row0 + r) * kQStride + lane + 32 * c] = acc[r][c];
  }

  // 6) layer 0: dpre_0 and dzt_0 (masked by z_0 > 0 after the fold)
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int m = row0 + r;
    if (zoff[m] < 0) continue;
    const long long at = (tile0 + m) * kHidden;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int j = lane + 32 * c;
      const float k = sk[at + j];
      float s, co;
      poly_sincos(sa[at + j], s, co);
      const float dq = qs[m * kQStride + j];
      sp0[at + j] = (dq * k) * co;
      sz0[at + j] = dq * s;
    }
  }
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

// Partial weight gradients of one split of queries:
//   part[split, c_off + layer * c_layer + p * n_dim + n]
//       = sum_{m in split} A_layer[m, p] * B_layer[m, n]
// for p < p_dim, n < n_dim, on a kGemmTile x kGemmTile output tile, and
// (P tile 0 only) the column sums of B into part[split, s_off + layer *
// s_layer + n], written as 0 for n < s_from. blockIdx.z = layer * n_split
// + split.
__global__ void __launch_bounds__(256)
wgrad_kernel(const float* __restrict__ a, int lda, long long a_layer,
             const float* __restrict__ b, int ldb, long long b_layer,
             long long n_query, int p_dim, int n_dim, int n_split,
             float* __restrict__ part, long long part_stride, long long c_off,
             long long c_layer, long long s_off, long long s_layer,
             int s_from) {
  // two stages of [A slice | B slice], each kGemmSliceM x kGemmTile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  constexpr int kStage = 2 * kGemmSliceM * kGemmTile;
  constexpr int kPerThread = kGemmSliceM * kGemmTile / 256;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int layer = blockIdx.z / n_split;
  const int split = blockIdx.z - layer * n_split;
  const int p0 = blockIdx.x * kGemmTile;
  const int n0 = blockIdx.y * kGemmTile;
  const long long m_begin = static_cast<long long>(split) * kSplitRows;
  const long long m_end =
      m_begin + kSplitRows < n_query ? m_begin + kSplitRows : n_query;
  const float* al = a + layer * a_layer;
  const float* bl = b + layer * b_layer;
  const bool colsum = blockIdx.x == 0;

  float acc[8][8];
  float bsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  }
  // slice m0's elements of this thread, zero past the edges
  float ra[kPerThread], rb[kPerThread];
  auto load = [&](long long m0) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int el = tid + 256 * e;
      const int row = el / kGemmTile;
      const int col = el - row * kGemmTile;
      const long long m = m0 + row;
      const bool in_m = m < m_end;
      ra[e] = (in_m && p0 + col < p_dim) ? al[m * lda + p0 + col] : 0.f;
      rb[e] = (in_m && n0 + col < n_dim) ? bl[m * ldb + n0 + col] : 0.f;
    }
  };
  load(m_begin);
  int stage = 0;
  for (long long m0 = m_begin; m0 < m_end; m0 += kGemmSliceM) {
    // stage `stage` was last read two slices ago; every thread has since
    // passed the barrier below
    float* as = stages + stage * kStage;
    float* bs = as + kGemmSliceM * kGemmTile;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      as[tid + 256 * e] = ra[e];
      bs[tid + 256 * e] = rb[e];
    }
    __syncthreads();
    if (m0 + kGemmSliceM < m_end) load(m0 + kGemmSliceM);
#pragma unroll
    for (int k = 0; k < kGemmSliceM; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[k * kGemmTile + ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        bv[jj] = bs[k * kGemmTile + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      if (colsum && ty == 0) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) bsum[jj] += bv[jj];
      }
    }
    stage ^= 1;
  }
  float* out = part + split * part_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= p_dim) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < n_dim) out[c_off + layer * c_layer + p * n_dim + n] =
          acc[i][jj];
    }
  }
  if (colsum && ty == 0 && s_off >= 0) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < n_dim)
        out[s_off + layer * s_layer + n] = n >= s_from ? bsum[jj] : 0.f;
    }
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
            const float* b0, const float* wcat, const float* bcat,
            const float* wl, const float* wcat_t, const float* g, float* dz,
            float* grads, float* scratch, int batch, int h_in, int w_in,
            int h_out, int w_out, int s_h, int s_w, int n_layers) {
  constexpr int kHidden = kNC * 32;
  const long long m = static_cast<long long>(batch) * h_out * w_out;
  const Plan plan(m, kHidden, n_layers);
  int err = 0;
  if (m > 0) {
    err = launch(decode_bwd_chain_kernel<kNC, kWindow>,
                 static_cast<unsigned>((m + kTileM - 1) / kTileM), kThreads,
                 chain_smem_bytes(kHidden), z, syn, rows, cols, w0, b0, wcat,
                 bcat, wl, wcat_t, g, scratch, batch, h_in, w_in, h_out,
                 w_out, s_h, s_w, n_layers);
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
    const unsigned tiles = (kHidden + kGemmTile - 1) / kGemmTile;
    err = launch(wgrad_kernel,
                 dim3(tiles, (2 * kHidden + kGemmTile - 1) / kGemmTile,
                      plan.n_split * (n_layers - 1)),
                 256, kWgradSmem,
                 static_cast<const float*>(scratch + plan.s_q),
                 kHidden, plan.n_query * kHidden,
                 static_cast<const float*>(scratch + plan.s_db), 2 * kHidden,
                 2 * plan.n_query * kHidden, m, kHidden, 2 * kHidden,
                 plan.n_split, part, plan.n_grad, plan.o_wcat,
                 2LL * kHidden * kHidden, plan.o_bcat, 2LL * kHidden,
                 kHidden);
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
