// The fp32 inference encoder's convolution for Hopper (sm_90a): the C
// interface of encoder_conv.cuh's implicit-GEMM kernel (the design and
// what bounds it are there). It replaces no TPU kernel: on the TPU these
// convs were XLA convs.
//
// Interface: plain C, loaded with ctypes. The launcher builds the input
// slab's 4-D tensor map (cuTensorMapEncodeTiled, found through the
// runtime's driver entry point, so the library links no libcuda), runs on
// the caller's current device, launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() (0 = launched), or kErrTensorMap
// when the tensor map cannot be made.

#include <cuda.h>
#include <cuda_runtime.h>

#include "encoder_conv.cuh"

namespace {

constexpr int kErrTensorMap = 100001;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of channels [0, cin) of the (batch, height, width, x_cs) slab
// at x, boxes of Tiling<kKs>'s activation box, 128-byte swizzle, zero
// fill out of bounds.
template <int kKs>
int make_map(CUtensorMap* map, const float* x, int cin, long long x_cs,
             int batch, int height, int width) {
  using T = encoder_conv::Tiling<kKs>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrTensorMap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(height),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(x_cs) * 4;
  const cuuint64_t strides[3] = {row, row * width, row * width * height};
  const cuuint32_t box[4] = {encoder_conv::kKc, T::kBoxW, T::kBoxH, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int kKs>
int launch(const float* x, int cin, long long x_cs,
           const encoder_conv::Params& p, cudaStream_t stream) {
  CUtensorMap map;
  int err = make_map<kKs>(&map, x, cin, x_cs, p.batch, p.height, p.width);
  if (err != 0) return err;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  hopper_chain::CudaLaunch launcher{stream};
  return encoder_conv::run_conv<kKs>(launcher, map, p, n_sm);
}

}  // namespace

extern "C" {

// out[..., 0:cout] (channel stride out_cs) = conv(x[..., 0:cin]) + bias,
// then ReLU (relu != 0), then + res[..., 0:cout] (res_cs; res may be
// null); the same values into out2 (out2_cs) unless it is null. x is the
// (batch, height, width) slab of channel stride x_cs (a multiple of 4,
// x 16-byte aligned); wslab the wrapper's weight_slabs of the (cout, cin,
// ks, ks) weight; ks 1 or 3.
int launch_encoder_conv(const float* x, int cin, long long x_cs, int batch,
                        int height, int width, int ks, const float* wslab,
                        const float* bias, int cout, float* out,
                        long long out_cs, const float* res, long long res_cs,
                        float* out2, long long out2_cs, int relu,
                        cudaStream_t stream) {
  encoder_conv::Params p;
  p.wslab = wslab;
  p.bias = bias;
  p.out = out;
  p.res = res;
  p.out2 = out2;
  p.out_cs = out_cs;
  p.res_cs = res_cs;
  p.out2_cs = out2_cs;
  p.batch = batch;
  p.height = height;
  p.width = width;
  p.cout = cout;
  p.n_chunks = (cin + encoder_conv::kKc - 1) / encoder_conv::kKc;
  p.relu = relu;
  if (ks == 3) return launch<3>(x, cin, x_cs, p, stream);
  if (ks == 1) return launch<1>(x, cin, x_cs, p, stream);
  return cudaErrorInvalidValue;
}

const char* encoder_conv_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled failed (or was not found)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
