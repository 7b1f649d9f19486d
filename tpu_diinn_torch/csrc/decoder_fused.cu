// Fused DIINN mode-3 decoder forward for Hopper (sm_90a), fp32.
//
// Replaces two Pallas TPU kernels of tpu_diinn/kernels/decoder_fused.py:
//
// - decode_int_fwd    <- decode_fused_int_eval / _fwd_kernel_int: the
//   integer-ratio eval forward (x2, x3, x4, x8 ...). A query at (y, x)
//   reads z[b, y / s_h, x / s_w, :] (nearest-exact for n_out = s * n_in is
//   exactly i // s); the kernel masks the ragged last tile itself instead
//   of zero-padding the LR map as the Pallas wrapper does.
// - decode_window_fwd <- _fwd_pallas / _fwd_kernel (+ _chain_fwd): the
//   arbitrary-ratio / window forward (x3.14, every chunk of the chunked
//   eval). The Pallas kernel gathers rows and columns with one-hot matmuls
//   on the TPU's MXU; here each query reads z through int32 row and column
//   index vectors, and a window is an offset into those vectors.
//
// What bounds it on this card: the FP32 FFMA rate. Each query costs
// 2 * (3*256 + 3*256*512 + 256*3) = 789,504 FLOP at hidden 256 and L = 4,
// against 4 KB of z read (shared by s_h*s_w queries, L2-resident) and 12 B
// written: thousands of FLOP per byte of device memory. What the design
// does about it: the whole k/q chain stays on chip (q tile in shared
// memory, accumulators in registers), each layer's two GEMMs run as one
// fused [Wkq | Wq] pass so a q value loaded once feeds 2*hidden/32 FFMAs
// per lane, and the weights (1.5 MB, shared by every CTA) stream from L2
// through a two-stage cp.async ring while the previous stage computes.
// fp32 IEEE throughout; bf16 and tensor cores (wgmma) are later work.
//
// Interface: plain C, loaded with ctypes. Each launcher runs on the
// caller's current device (the Python wrapper selects the tensors' device
// around the call), launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

#include "decoder_fused.cuh"

namespace decoder_fused {

template <int kNC, bool kWindow>
static cudaError_t launch_nc(const float* z, const float* syn, const int* rows,
                             const int* cols, const float* w0, const float* b0,
                             const float* wcat, const float* bcat,
                             const float* wl, const float* bl, float* out,
                             int batch, int h_in, int w_in, int h_out,
                             int w_out, int s_h, int s_w, int n_layers,
                             cudaStream_t stream) {
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  if (n_query == 0) return cudaSuccess;
  const int smem = smem_bytes(kNC * 32);
  auto kernel = decode_fwd_kernel<kNC, kWindow>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>((n_query + kTileM - 1) / kTileM);
  kernel<<<grid, kThreads, smem, stream>>>(
      z, syn, rows, cols, w0, b0, wcat, bcat, wl, bl, out, batch, h_in, w_in,
      h_out, w_out, s_h, s_w, n_layers);
  return cudaGetLastError();
}

template <bool kWindow>
static int launch(const float* z, const float* syn,
                  const int* rows, const int* cols, const float* w0,
                  const float* b0, const float* wcat, const float* bcat,
                  const float* wl, const float* bl, float* out, int batch,
                  int h_in, int w_in, int h_out, int w_out, int s_h, int s_w,
                  int hidden, int n_layers, cudaStream_t stream) {
#define DECODER_FUSED_CASE(NC)                                              \
  case NC:                                                                  \
    return launch_nc<NC, kWindow>(z, syn, rows, cols, w0, b0, wcat, bcat,   \
                                  wl, bl, out, batch, h_in, w_in, h_out,    \
                                  w_out, s_h, s_w, n_layers, stream);
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

}  // namespace decoder_fused

extern "C" {

// z (B, H_in, W_in, L*hidden), syn (s_h*H_in, s_w*W_in, 3),
// out (B, s_h*H_in, s_w*W_in, 3); all fp32, contiguous.
int launch_decode_int_fwd(const void* z, const void* syn,
                          const void* w0, const void* b0, const void* wcat,
                          const void* bcat, const void* wl, const void* bl,
                          void* out, int batch, int h_in, int w_in, int s_h,
                          int s_w, int hidden, int n_layers, void* stream) {
  return decoder_fused::launch<false>(
      static_cast<const float*>(z), static_cast<const float*>(syn),
      nullptr, nullptr, static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(wcat),
      static_cast<const float*>(bcat), static_cast<const float*>(wl),
      static_cast<const float*>(bl), static_cast<float*>(out), batch, h_in,
      w_in, s_h * h_in, s_w * w_in, s_h, s_w, hidden, n_layers,
      static_cast<cudaStream_t>(stream));
}

// z (B, H_in, W_in, L*hidden), syn (H_win, W_win, 3), rows (H_win,) and
// cols (W_win,) int32 indices into z's rows/columns,
// out (B, H_win, W_win, 3).
int launch_decode_window_fwd(const void* z, const void* syn,
                             const void* rows, const void* cols,
                             const void* w0, const void* b0, const void* wcat,
                             const void* bcat, const void* wl, const void* bl,
                             void* out, int batch, int h_in, int w_in,
                             int h_win, int w_win, int hidden, int n_layers,
                             void* stream) {
  return decoder_fused::launch<true>(
      static_cast<const float*>(z), static_cast<const float*>(syn),
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(wcat), static_cast<const float*>(bcat),
      static_cast<const float*>(wl), static_cast<const float*>(bl),
      static_cast<float*>(out), batch, h_in, w_in, h_win, w_win, 1, 1, hidden,
      n_layers, static_cast<cudaStream_t>(stream));
}

const char* decoder_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
