// LIIF's query MLP for Hopper (sm_90a): the C interface of
// liif_decoder.cuh's kernel (the design and what bounds it are there). It
// replaces no TPU kernel: the JAX package runs LIIF's per-query products as
// XLA dense ops.
//
// Interface: plain C, loaded with ctypes. The launcher runs on the
// caller's current device, launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

#include "liif_decoder.cuh"

extern "C" {

// One column chunk of a LIIF decode: z (batch, h_in, w_in, 256) float32;
// corners[4 k + 0..3] corner k's row indices (h_c), row rels (h_c
// float32), column indices (w_c) and column rels (w_c float32), the
// indices int64 where idx64 else int32;
// cell (2,); small and wslab the wrapper's small_operands and
// weight_slabs; query (b, y, x) of the chunk writes its 3 channels at out
// + b * out_sb + y * out_sy + 3 x.
int launch_liif_decoder(const float* z, int batch, int h_in, int w_in,
                        const void* const* corners, int idx64, int h_c,
                        int w_c, const float* cell, const float* small,
                        const float* wslab, float* out, long long out_sb,
                        long long out_sy, cudaStream_t stream) {
  liif_decoder::Params p{};
  p.z = z;
  for (int k = 0; k < liif_decoder::kCorners; ++k) {
    p.iy[k] = corners[4 * k];
    p.ry[k] = static_cast<const float*>(corners[4 * k + 1]);
    p.ix[k] = corners[4 * k + 2];
    p.rx[k] = static_cast<const float*>(corners[4 * k + 3]);
  }
  p.cell = cell;
  p.small = small;
  p.wslab = wslab;
  p.out = out;
  p.out_sb = out_sb;
  p.out_sy = out_sy;
  p.batch = batch;
  p.h_in = h_in;
  p.w_in = w_in;
  p.h_c = h_c;
  p.w_c = w_c;
  p.idx64 = idx64;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  hopper_chain::CudaLaunch launcher{stream};
  return liif_decoder::run_decode(launcher, p, n_sm);
}

const char* liif_decoder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
