// Fused DIINN mode-3 decoder backward for Hopper (sm_90a), fp32.
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
// What bounds it on this card: the FP32 FFMA rate. Per query the backward
// recomputes the forward (789,504 FLOP at hidden 256, L = 4) and then runs
// two products per layer of the same size (dq through [Wkq | Wq]^T and the
// weight gradient), 2,366,976 FLOP in all, against 12 B of g read and 4 KB
// of dz shared by the s_h * s_w queries of an LR pixel. What the design
// does about it, and what it does not yet: the chain pass keeps its tile's
// k/q chain in shared memory and registers as the forward does; the
// activations the reductions need go through device memory (about 20 KB
// per query at hidden 256) because the weight gradients are reduced over
// every query of the call, which no CTA owns. The Pallas kernels carry
// those sums across the TPU's sequential grid; here each split of 4096
// queries writes its own partial and a last pass adds the splits in a
// fixed order, so the result is deterministic and uses no atomics.
// fp32 IEEE FFMA throughout; tensor cores (wgmma) are later work.
//
// Interface: plain C, loaded with ctypes, like decoder_fused.cu. Each
// launcher runs on the caller's current device and stream, allocates
// nothing (the caller passes a scratch buffer of
// decoder_bwd_scratch_floats(...) floats) and returns the first CUDA error
// of its launches (0 = launched).

#include <cuda_runtime.h>

#include "decoder_bwd.cuh"

namespace decoder_bwd {

struct CudaLaunch {
  cudaStream_t stream;

  template <class... KArgs, class... Args>
  int operator()(void (*kernel)(KArgs...), dim3 grid, dim3 block, int smem,
                 Args... args) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, block, smem, stream>>>(args...);
    return cudaGetLastError();
  }
};

template <bool kWindow>
static int launch(const float* z, const float* syn, const int* rows,
                  const int* cols, const float* w0, const float* b0,
                  const float* wcat, const float* bcat, const float* wl,
                  const float* wcat_t, const float* g, float* dz,
                  float* grads, float* scratch, int batch, int h_in,
                  int w_in, int h_out, int w_out, int s_h, int s_w,
                  int hidden, int n_layers, cudaStream_t stream) {
  CudaLaunch launcher{stream};
#define DECODER_BWD_CASE(NC)                                                \
  case NC:                                                                  \
    return run_bwd<NC, kWindow>(launcher, z, syn, rows, cols, w0, b0, wcat, \
                                bcat, wl, wcat_t, g, dz, grads, scratch,    \
                                batch, h_in, w_in, h_out, w_out, s_h, s_w,  \
                                n_layers);
  switch (hidden % 32 == 0 ? hidden / 32 : 0) {
    DECODER_BWD_CASE(1)
    DECODER_BWD_CASE(2)
    DECODER_BWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODER_BWD_CASE
}

}  // namespace decoder_bwd

extern "C" {

// Floats of scratch one backward call needs for `n_query` HR queries.
long long decoder_bwd_scratch_floats(long long n_query, int hidden,
                                     int n_layers) {
  return decoder_bwd::Plan(n_query, hidden, n_layers).s_total;
}

// z (B, H_in, W_in, L*hidden), syn (s_h*H_in, s_w*W_in, 3), the packed
// weights of decoder_fused.cu, wcat_t (L-1, 2*hidden, hidden), g (B,
// s_h*H_in, s_w*W_in, 3) -> dz (B, H_in, W_in, L*hidden) and the flat
// weight gradients (decoder_bwd::Plan); all fp32, contiguous.
int launch_decode_int_bwd(const void* z, const void* syn, const void* w0,
                          const void* b0, const void* wcat, const void* bcat,
                          const void* wl, const void* wcat_t, const void* g,
                          void* dz, void* grads, void* scratch, int batch,
                          int h_in, int w_in, int s_h, int s_w, int hidden,
                          int n_layers, void* stream) {
  return decoder_bwd::launch<false>(
      static_cast<const float*>(z), static_cast<const float*>(syn), nullptr,
      nullptr, static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(wcat), static_cast<const float*>(bcat),
      static_cast<const float*>(wl), static_cast<const float*>(wcat_t),
      static_cast<const float*>(g), static_cast<float*>(dz),
      static_cast<float*>(grads), static_cast<float*>(scratch), batch, h_in,
      w_in, s_h * h_in, s_w * w_in, s_h, s_w, hidden, n_layers,
      static_cast<cudaStream_t>(stream));
}

// As launch_decode_int_bwd for the window whose queries read LR rows
// rows (H_win,) and LR columns cols (W_win,), int32 and non-decreasing;
// syn (H_win, W_win, 3), g (B, H_win, W_win, 3).
int launch_decode_window_bwd(const void* z, const void* syn,
                             const void* rows, const void* cols,
                             const void* w0, const void* b0, const void* wcat,
                             const void* bcat, const void* wl,
                             const void* wcat_t, const void* g, void* dz,
                             void* grads, void* scratch, int batch, int h_in,
                             int w_in, int h_win, int w_win, int hidden,
                             int n_layers, void* stream) {
  return decoder_bwd::launch<true>(
      static_cast<const float*>(z), static_cast<const float*>(syn),
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(wcat), static_cast<const float*>(bcat),
      static_cast<const float*>(wl), static_cast<const float*>(wcat_t),
      static_cast<const float*>(g), static_cast<float*>(dz),
      static_cast<float*>(grads), static_cast<float*>(scratch), batch, h_in,
      w_in, h_win, w_win, 1, 1, hidden, n_layers,
      static_cast<cudaStream_t>(stream));
}

const char* decoder_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
