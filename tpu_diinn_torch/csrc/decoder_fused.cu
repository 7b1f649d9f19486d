// Fused DIINN mode-3 decoder forward for Hopper (sm_90a): fp32 accuracy
// from 3xTF32 tensor-core products, or the bf16 mode from bf16 ones.
//
// Replaces two Pallas TPU kernels of tpu_diinn/kernels/decoder_fused.py:
//
// - decode_int_fwd    <- decode_fused_int_eval / _fwd_kernel_int (and the
//   training forward _fwd_pallas_int): the integer-ratio forward (x2, x3,
//   x4, x8 ...). A query at (y, x) reads z[b, y / s_h, x / s_w, :]
//   (nearest-exact for n_out = s * n_in is exactly i // s); the kernel
//   masks the ragged last tile itself instead of zero-padding the LR map as
//   the Pallas wrapper does.
// - decode_window_fwd <- _fwd_pallas / _fwd_kernel (+ _chain_fwd): the
//   arbitrary-ratio / window forward (x3.14, every chunk of the chunked
//   eval, x2.5 training). The Pallas kernel gathers rows and columns with
//   one-hot matmuls on the TPU's MXU; here each query reads z through int32
//   row and column index vectors, and a window is an offset into those
//   vectors.
//
// What bounds it on this card: the products. Each query costs 2 * (3*256 +
// 3*256*512 + 256*3) = 789,504 FLOP at hidden 256 and L = 4, against 4 KB
// of z read (shared by the s_h*s_w queries of an LR pixel, L2-resident) and
// 12 B written: thousands of FLOP per byte of device memory. In IEEE fp32
// FFMA that is bound by the 67 TFLOP/s fp32 rate; here the products run on
// the tensor cores as wgmma TF32 in the 3xTF32 scheme (three TF32 products
// per fp32 product, fp32-level error): 165 TFLOP/s of fp32-accurate
// products at the 495 TFLOP/s TF32 peak. What the design does about it
// (hopper_chain.cuh, decoder_fused.cuh): the whole k/q chain stays on chip
// (q tiles in shared memory, accumulators in registers), each layer's two
// products run as one [Wkq | Wq] product, the split weights stream from L2
// by TMA into an mbarrier ring, the next pair of k8 steps' A is loaded
// while the current products run, and each epilogue gathers its z rows
// all at once. Measured on the card (PERF.md), the products alone take
// about their bound; the weight stream (1 MB a layer for every 64-query
// tile) and the work between products do not hide behind them. The
// backward's chain kernel recomputes the forward with the same routine.
//
// The bf16 instances (bf16 = 1 at the interface) run the JAX package's bf16
// mode: z, W0, [Wkq | Wq] and Wl in bf16, biases, syn and out fp32; q is
// rounded to bf16 before every product (the head's too) and each product
// is one wgmma BF16 per k16 step with fp32 sums (989 TFLOP/s peak); the
// elementwise work stays fp32. They have a kernel of their own, designed
// for bf16 (decoder_fwd_bf16.cuh: 128-query tiles of two warpgroups on one
// shared weight ring fed by a producer warp, A from shared memory, the
// warpgroups' epilogues ping-ponged with their products, a persistent
// grid), bit-identical to the chain routine's bf16 forward
// (decode_fwd_kernel in the Bf16 policy), which the backward recomputes.
//
// Interface: plain C, loaded with ctypes. Each launcher runs on the
// caller's current device (the Python wrapper selects the tensors' device
// around the call), launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

#include "decoder_fused.cuh"
#include "decoder_fwd_bf16.cuh"

namespace decoder_fused {

// The fp32 instances.
template <bool kWindow>
static int launch_fp32(const void* z_, const float* syn, const int* rows,
                       const int* cols, const void* w0_, const float* b0,
                       const void* wslab_, const float* bcat,
                       const void* wl_, const float* bl, float* out,
                       int batch, int h_in, int w_in, int h_out, int w_out,
                       int s_h, int s_w, int hidden, int n_layers,
                       cudaStream_t stream) {
  const float* z = static_cast<const float*>(z_);
  const float* w0 = static_cast<const float*>(w0_);
  const float* wslab = static_cast<const float*>(wslab_);
  const float* wl = static_cast<const float*>(wl_);
  CudaLaunch launcher{stream};
#define DECODER_FUSED_CASE(NC)                                              \
  case NC:                                                                  \
    return run_fwd<NC, kWindow, Tf32>(launcher, z, syn, rows, cols, w0, b0, \
                                      wslab, bcat, wl, bl, out, batch,      \
                                      h_in, w_in, h_out, w_out, s_h, s_w,   \
                                      n_layers);
  // hidden 32, 64, 256 (the widths a config or test uses): one
  // instantiation each keeps the build short
  switch (hidden % 32 == 0 ? hidden / 32 : 0) {
    DECODER_FUSED_CASE(1)
    DECODER_FUSED_CASE(2)
    DECODER_FUSED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODER_FUSED_CASE
}

// The bf16 instances: decoder_fwd_bf16.cuh's kernel, a persistent grid of
// one CTA an SM.
template <bool kWindow>
static int launch_bf16(const void* z_, const float* syn, const int* rows,
                       const int* cols, const void* w0_, const float* b0,
                       const void* wslab_, const float* bcat,
                       const void* wl_, const float* bl, float* out,
                       int batch, int h_in, int w_in, int h_out, int w_out,
                       int s_h, int s_w, int hidden, int n_layers,
                       cudaStream_t stream) {
  using U = uint16_t;
  const U* z = static_cast<const U*>(z_);
  const U* w0 = static_cast<const U*>(w0_);
  const U* wslab = static_cast<const U*>(wslab_);
  const U* wl = static_cast<const U*>(wl_);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  CudaLaunch launcher{stream};
#define DECODER_FWD_BF16_CASE(NC)                                           \
  case NC:                                                                  \
    return decoder_fwd_bf16::run_fwd_bf16<NC, kWindow>(                     \
        launcher, z, syn, rows, cols, w0, b0, wslab, bcat, wl, bl, out,     \
        batch, h_in, w_in, h_out, w_out, s_h, s_w, n_layers, n_sm);
  switch (hidden % 32 == 0 ? hidden / 32 : 0) {
    DECODER_FWD_BF16_CASE(1)
    DECODER_FWD_BF16_CASE(2)
    DECODER_FWD_BF16_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODER_FWD_BF16_CASE
}

template <bool kWindow>
static int launch_prec(int bf16, const void* z, const float* syn,
                       const int* rows, const int* cols, const void* w0,
                       const float* b0, const void* wslab, const float* bcat,
                       const void* wl, const float* bl, float* out,
                       int batch, int h_in, int w_in, int h_out, int w_out,
                       int s_h, int s_w, int hidden, int n_layers,
                       cudaStream_t stream) {
  return bf16 ? launch_bf16<kWindow>(z, syn, rows, cols, w0, b0, wslab, bcat,
                                     wl, bl, out, batch, h_in, w_in, h_out,
                                     w_out, s_h, s_w, hidden, n_layers,
                                     stream)
              : launch_fp32<kWindow>(z, syn, rows, cols, w0, b0, wslab, bcat,
                                     wl, bl, out, batch, h_in, w_in, h_out,
                                     w_out, s_h, s_w, hidden, n_layers,
                                     stream);
}

}  // namespace decoder_fused

extern "C" {

// z (B, H_in, W_in, L*hidden), syn (s_h*H_in, s_w*W_in, 3), w0, b0, bcat,
// wl and bl as the wrapper packs them (pack_params), wslab the split wgmma
// B slabs of [Wkq | Wq] (the wrapper's mma_b_slabs) -> out (B, s_h*H_in,
// s_w*W_in, 3); all fp32 (bf16 = 0), or z, w0, wslab and wl bf16 (bf16 =
// 1); contiguous, 16-byte aligned.
int launch_decode_int_fwd(const void* z, const void* syn, const void* w0,
                          const void* b0, const void* wslab,
                          const void* bcat, const void* wl, const void* bl,
                          void* out, int batch, int h_in, int w_in, int s_h,
                          int s_w, int hidden, int n_layers, int bf16,
                          void* stream) {
  return decoder_fused::launch_prec<false>(
      bf16, z, static_cast<const float*>(syn), nullptr, nullptr, w0,
      static_cast<const float*>(b0), wslab, static_cast<const float*>(bcat),
      wl, static_cast<const float*>(bl), static_cast<float*>(out), batch,
      h_in, w_in, s_h * h_in, s_w * w_in, s_h, s_w, hidden, n_layers,
      static_cast<cudaStream_t>(stream));
}

// As launch_decode_int_fwd for the window whose queries read LR rows rows
// (H_win,) and LR columns cols (W_win,), int32; syn (H_win, W_win, 3),
// out (B, H_win, W_win, 3).
int launch_decode_window_fwd(const void* z, const void* syn,
                             const void* rows, const void* cols,
                             const void* w0, const void* b0,
                             const void* wslab, const void* bcat,
                             const void* wl, const void* bl, void* out,
                             int batch, int h_in, int w_in, int h_win,
                             int w_win, int hidden, int n_layers, int bf16,
                             void* stream) {
  return decoder_fused::launch_prec<true>(
      bf16, z, static_cast<const float*>(syn), static_cast<const int*>(rows),
      static_cast<const int*>(cols), w0, static_cast<const float*>(b0), wslab,
      static_cast<const float*>(bcat), wl, static_cast<const float*>(bl),
      static_cast<float*>(out), batch, h_in, w_in, h_win, w_win, 1, 1, hidden,
      n_layers, static_cast<cudaStream_t>(stream));
}

const char* decoder_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
