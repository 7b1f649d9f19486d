// Device code of the fused DIINN mode-3 decoder forward on the tensor
// cores (sm_90a), in fp32 accuracy (Tf32) or the bf16 mode (Bf16). The
// card runs its Tf32 instances; the bf16 mode runs decoder_fwd_bf16.cuh's
// kernel, which computes the same numbers as the Bf16 instance here (the
// host tests hold the two bit for bit).
//
// Both kernels of decoder_fused.cu run, per tile of kTileM HR queries, the
// chain of hopper_chain.cuh (chain_forward: layer 0 elementwise, layers
// 1..L-1 as wgmma products in the policy's precision with the weights
// streamed by TMA), the routine the backward recomputes the forward with,
// and then the head
//
//   out = q_{L-1} @ Wl + bl
//
// from the last q tile (bf16 in the Bf16 policy, with Wl bf16: exact
// products), one running fp32 sum over k in order a (query, channel), as
// the reference's product sums it: the head's rounding lands
// on the output, whose L1 residual signs a training step reads. The two
// kernels differ only in how a query finds its LR pixel: an integer ratio
// (y / s_h, x / s_w), or int32 row and column index vectors for any ratio
// or a window of the HR grid.

#pragma once

#include <cstdint>

#include "hopper_chain.cuh"

namespace decoder_fused {

using namespace hopper_chain;

// kNC = hidden / 32. kWindow selects the index-vector gather (rows/cols)
// over the integer-ratio one (s_h/s_w). P is the precision policy: z, w0,
// wslab and wl are P::Z / P::W, the biases, syn and out fp32. wslab holds
// each layer's [Wkq | Wq] as wgmma B slabs (mma_b_slabs of
// chain_b_operands' forward operand, in the wrapper).
template <int kNC, bool kWindow, class P>
__global__ void __launch_bounds__(kThreads, 1)
decode_fwd_kernel(const typename P::Z* __restrict__ z,
                  const float* __restrict__ syn,
                  const int* __restrict__ rows, const int* __restrict__ cols,
                  const typename P::W* __restrict__ w0,
                  const float* __restrict__ b0,
                  const typename P::W* __restrict__ wslab,
                  const float* __restrict__ bcat,
                  const typename P::W* __restrict__ wl,
                  const float* __restrict__ bl,
                  float* __restrict__ out, int batch, int h_in, int w_in,
                  int h_out, int w_out, int s_h, int s_w, int n_layers) {
  constexpr int kHidden = kNC * 32;
  using T = ChainTiling<kHidden, P>;
  using A = typename P::A;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* zoff = reinterpret_cast<long long*>(smem_raw);
  float* synv = reinterpret_cast<float*>(smem_raw + kTileM * 8);
  A* q_cur = reinterpret_cast<A*>(smem_raw + T::kHead);
  A* q_next = q_cur + kTileM * T::kLdQ;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + T::kBars) +
                   wg * kStages;
  typename P::W* ring =
      reinterpret_cast<typename P::W*>(smem_raw + T::kRingF) +
      wg * kStages * T::kSlabF;
  uint32_t phase = 0;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileM;

  // 1) each query's LR pixel (-1 past the ragged edge) and syn; the rings'
  //    barriers
  load_queries<kWindow, P>(zoff, synv, syn, rows, cols, batch, h_in, w_in,
                           h_out, w_out, s_h, s_w,
                           static_cast<long long>(n_layers) * kHidden);
  if (tid == 0) {
    uint64_t* all = reinterpret_cast<uint64_t*>(smem_raw + T::kBars);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(all + i, 1);
  }
  __syncthreads();

  // 2) the chain; layer L-1's q lands in q_last
  A* q_last = (n_layers - 1) % 2 ? q_next : q_cur;
  chain_forward<P, kHidden, true>(
      zoff, synv, z, w0, b0, wslab, bcat, n_layers, q_cur, q_next, ring,
      bars, phase,
      [](int, int, int, int, float, float, float, float, float, float) {});

  // 3) head: one running sum over k in order a (query, channel), as the
  //    reference's product sums it
  if (tid < kTileM * 3) {
    const int m = tid / 3;
    const int o = tid - 3 * m;
    if (zoff[m] >= 0) {
      float acc = 0.f;
      for (int k = 0; k < kHidden; ++k)
        acc = fmaf(P::to_float(q_last[m * T::kLdQ + k]),
                   P::to_float(wl[k * 3 + o]), acc);
      out[(tile0 + m) * 3 + o] = acc + bl[o];
    }
  }
}

// The forward as its launch. `launch(kernel, grid, block, smem, args...)`
// is the caller's: a CUDA launch on its stream, or a host emulation in a
// test harness. Returns its error.
template <int kNC, bool kWindow, class P, class Launch>
int run_fwd(Launch& launch, const typename P::Z* z, const float* syn,
            const int* rows, const int* cols, const typename P::W* w0,
            const float* b0, const typename P::W* wslab, const float* bcat,
            const typename P::W* wl, const float* bl, float* out, int batch,
            int h_in, int w_in, int h_out, int w_out, int s_h, int s_w,
            int n_layers) {
  const long long m = static_cast<long long>(batch) * h_out * w_out;
  if (m == 0) return 0;
  return launch(decode_fwd_kernel<kNC, kWindow, P>,
                static_cast<unsigned>((m + kTileM - 1) / kTileM), kThreads,
                ChainTiling<kNC * 32, P>::kEndF, z, syn, rows, cols, w0, b0,
                wslab, bcat, wl, bl, out, batch, h_in, w_in, h_out, w_out,
                s_h, s_w, n_layers);
}

}  // namespace decoder_fused
