// Fused DIINN mode-3 decoder backward for Hopper (sm_90a): fp32 accuracy
// from 3xTF32 tensor-core products, or the bf16 mode from bf16 ones.
//
// Replaces two Pallas TPU kernels of tpu_diinn/kernels/decoder_fused.py:
//
// - decode_int_bwd    <- _bwd_pallas_int / _bwd_kernel_int: the VJP of
//   the integer-ratio training forward (x2, x3, x4). A query at (y, x)
//   reads LR pixel (y / s_h, x / s_w).
// - decode_window_bwd <- _bwd_pallas / _bwd_kernel (+ _chain_bwd): the VJP
//   of the arbitrary-ratio / window forward (x2.5 training). A query reads
//   LR pixel (rows[y], cols[x]) for non-decreasing int32 index vectors.
//
// What bounds it on this card. Per query the backward recomputes the
// forward (789,504 FLOP at hidden 256, L = 4) and then runs two products
// per layer of the same size (dq through [Wkq | Wq]^T and the weight
// gradient), 2,366,976 FLOP in all, against 12 B of g read and 4 KB of dz
// shared by the s_h * s_w queries of an LR pixel. In IEEE fp32 FFMA that is
// bound by the 67 TFLOP/s fp32 rate. Here every product runs on the
// tensor cores as wgmma TF32 in the 3xTF32 scheme, three TF32 products per
// fp32 product, which keeps fp32-level error: 165 TFLOP/s of fp32-accurate
// products at the 495 TFLOP/s TF32 peak. The chain kernel streams the
// split weights into an mbarrier-guarded ring with the TMA unit (one
// producer thread a warpgroup) and keeps the activation operand (q, or d
// = [dkq | dqp]) in shared memory, split into registers as wgmma's A. At
// that rate the bytes count too: the weight gradients are reduced over
// every query of the call, which no CTA owns, so the chain writes the
// activations the reductions need to device memory (18 KB per query at
// hidden 256) and the reductions read them back (30 KB). The Pallas
// kernels carry those sums across the TPU's sequential grid; here each
// split of kSplitRows queries writes its own partial and a last pass adds
// the splits in a fixed order, so the result is deterministic and uses no
// atomics.
//
// The bf16 instances (bf16 = 1 at the interface; decoder_bwd.cuh's Bf16
// policy) take z, W0, Wl and the weight slabs in bf16 and return dz in
// bf16 and the weight gradients in fp32, every product on bf16 operands
// with fp32 sums. At the 989 TFLOP/s bf16 peak the same products bound the
// call at a sixth of the fp32 time, so the bytes do: the Tf32 design moves
// about 55 KB a query through device memory. Their own design
// (decoder_bwd.cuh, run_bwd_bf16) stores q and the weight gradient's
// operand d in bf16 (4,608 B a query at hidden 256, L = 4), recomputes k
// and a from q rather than storing them, folds dz inside the chain
// kernel's tiles on the integer route (s_h * s_w <= 64; elsewhere 4,096 B
// a query of fp32 dz terms go to fold_dz_bf16_kernel), and sums the thin
// gradients per tile in the chain kernel: about 11 KB a query in all.
// Measured, what then bounds it is latency in its chain kernel
// (decoder_bwd.cuh, PERF.md).
//
// Interface: plain C, loaded with ctypes, like decoder_fused.cu. Each
// launcher runs on the caller's current device and stream, allocates
// nothing (the caller passes a scratch buffer of
// decoder_bwd_scratch_bytes(...) bytes, 16-byte aligned) and returns the
// first CUDA error of its launches (0 = launched).

#include <cuda_runtime.h>

#include "decoder_bwd.cuh"

namespace decoder_bwd {

template <bool kWindow, class P>
static int launch(const void* z_, const float* syn, const int* rows,
                  const int* cols, const void* w0_, const float* b0,
                  const void* wslab_, const float* bcat, const void* wl_,
                  const void* wtslab_, const float* g, void* dz_,
                  float* grads, float* scratch, int batch, int h_in,
                  int w_in, int h_out, int w_out, int s_h, int s_w,
                  int hidden, int n_layers, cudaStream_t stream) {
  using Z = typename P::Z;
  using W = typename P::W;
  const Z* z = static_cast<const Z*>(z_);
  Z* dz = static_cast<Z*>(dz_);
  const W* w0 = static_cast<const W*>(w0_);
  const W* wslab = static_cast<const W*>(wslab_);
  const W* wl = static_cast<const W*>(wl_);
  const W* wtslab = static_cast<const W*>(wtslab_);
  CudaLaunch launcher{stream};
#define DECODER_BWD_CASE(NC)                                                \
  case NC:                                                                  \
    return run_bwd<NC, kWindow, P>(launcher, z, syn, rows, cols, w0, b0,    \
                                   wslab, bcat, wl, wtslab, g, dz, grads,   \
                                   scratch, batch, h_in, w_in, h_out,       \
                                   w_out, s_h, s_w, n_layers);
  switch (hidden % 32 == 0 ? hidden / 32 : 0) {
    DECODER_BWD_CASE(1)
    DECODER_BWD_CASE(2)
    DECODER_BWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODER_BWD_CASE
}

template <bool kWindow>
static int launch_prec(int bf16, const void* z, const float* syn,
                       const int* rows, const int* cols, const void* w0,
                       const float* b0, const void* wslab, const float* bcat,
                       const void* wl, const void* wtslab, const float* g,
                       void* dz, float* grads, float* scratch, int batch,
                       int h_in, int w_in, int h_out, int w_out, int s_h,
                       int s_w, int hidden, int n_layers,
                       cudaStream_t stream) {
  return bf16 ? launch<kWindow, Bf16>(z, syn, rows, cols, w0, b0, wslab, bcat,
                                      wl, wtslab, g, dz, grads, scratch,
                                      batch, h_in, w_in, h_out, w_out, s_h,
                                      s_w, hidden, n_layers, stream)
              : launch<kWindow, Tf32>(z, syn, rows, cols, w0, b0, wslab, bcat,
                                      wl, wtslab, g, dz, grads, scratch,
                                      batch, h_in, w_in, h_out, w_out, s_h,
                                      s_w, hidden, n_layers, stream);
}

}  // namespace decoder_bwd

extern "C" {

// Bytes of scratch one backward call needs for `n_query` HR queries that
// read `n_pix` LR pixels in runs of `run` queries (s_h * s_w on the
// integer route, 0 on the window route), in the precision bf16; with
// activations_only, the bytes of its per-query sections alone (without
// the partial sums of the weight gradients).
long long decoder_bwd_scratch_bytes(long long n_query, long long n_pix,
                                    int run, int hidden, int n_layers,
                                    int bf16, int activations_only) {
  return decoder_bwd::scratch_bytes(n_query, n_pix, run, hidden, n_layers,
                                    bf16 != 0, activations_only != 0);
}

// z (B, H_in, W_in, L*hidden), syn (s_h*H_in, s_w*W_in, 3), w0, b0, bcat
// and wl as decoder_fused.cu takes them, wslab and wtslab the split
// wgmma B slabs of [Wkq | Wq] and of its transpose (the wrapper's
// mma_b_slabs), g (B, s_h*H_in, s_w*W_in, 3) -> dz (B, H_in, W_in,
// L*hidden) and the flat weight gradients (decoder_bwd::Plan); all fp32
// (bf16 = 0), or z, w0, wl, the slabs and dz bf16 (bf16 = 1); contiguous,
// 16-byte aligned.
int launch_decode_int_bwd(const void* z, const void* syn, const void* w0,
                          const void* b0, const void* wslab, const void* bcat,
                          const void* wl, const void* wtslab, const void* g,
                          void* dz, void* grads, void* scratch, int batch,
                          int h_in, int w_in, int s_h, int s_w, int hidden,
                          int n_layers, int bf16, void* stream) {
  return decoder_bwd::launch_prec<false>(
      bf16, z, static_cast<const float*>(syn), nullptr, nullptr, w0,
      static_cast<const float*>(b0), wslab, static_cast<const float*>(bcat),
      wl, wtslab, static_cast<const float*>(g), dz,
      static_cast<float*>(grads), static_cast<float*>(scratch), batch, h_in,
      w_in, s_h * h_in, s_w * w_in, s_h, s_w, hidden, n_layers,
      static_cast<cudaStream_t>(stream));
}

// As launch_decode_int_bwd for the window whose queries read LR rows
// rows (H_win,) and LR columns cols (W_win,), int32 and non-decreasing;
// syn (H_win, W_win, 3), g (B, H_win, W_win, 3).
int launch_decode_window_bwd(const void* z, const void* syn,
                             const void* rows, const void* cols,
                             const void* w0, const void* b0,
                             const void* wslab, const void* bcat,
                             const void* wl, const void* wtslab,
                             const void* g, void* dz,
                             void* grads, void* scratch, int batch, int h_in,
                             int w_in, int h_win, int w_win, int hidden,
                             int n_layers, int bf16, void* stream) {
  return decoder_bwd::launch_prec<true>(
      bf16, z, static_cast<const float*>(syn), static_cast<const int*>(rows),
      static_cast<const int*>(cols), w0, static_cast<const float*>(b0),
      wslab, static_cast<const float*>(bcat), wl, wtslab,
      static_cast<const float*>(g), dz, static_cast<float*>(grads),
      static_cast<float*>(scratch), batch, h_in, w_in, h_win, w_win, 1, 1,
      hidden, n_layers, static_cast<cudaStream_t>(stream));
}

const char* decoder_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
