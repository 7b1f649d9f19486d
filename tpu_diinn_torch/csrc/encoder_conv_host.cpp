// Host emulation of the encoder's implicit-GEMM conv (encoder_conv.cuh)
// for tests on a machine without a card: g++ runs its launch with one
// std::thread per CUDA thread (hopper_host.h), the TMA box loads emulated
// here with their out-of-bounds zero fill and 128-byte swizzle, held
// against the plain PyTorch version by tests/test_torch_encoder_conv.py.
//
//   g++ -std=c++20 -O1 -pthread -I tpu_diinn_torch/csrc
//       tpu_diinn_torch/csrc/encoder_conv_host.cpp -o encoder_conv_host
//   encoder_conv_host DIR B H W CIN X_CS KS COUT OUT_CS RES_CS RELU MAX_CTAS
//                     IN_PLACE
//
// DIR holds the raw little-endian float32 inputs x (B, H, W, X_CS), wslab
// (the wrapper's weight_slabs), bias (COUT,), out (B, H, W, OUT_CS: the
// output slab's prior content; the conv writes channels 0..COUT-1) and,
// with RES_CS > 0, res (B, H, W, RES_CS); the program writes out_out, the
// output slab after the launch, and x_out, the input slab after it. The
// grid has at most MAX_CTAS CTAs. With IN_PLACE 1 (a residual dense
// block's local fusion) the conv writes channels 0..COUT-1 of the input
// slab itself, its residual is those same channels (RES_CS is ignored),
// and the out slab is its second output.

#include "hopper_host.h"

#include "encoder_conv.cuh"

namespace encoder_conv {

alignas(1024) unsigned char smem_raw[kHostSmem];

// The box at (c0, c1, c2, c3) in the map's dense box order, zero past the
// tensor's bounds, each byte offset o of it stored at o with bits 4..6
// xor bits 7..9 (the 128-byte swizzle; dst is 1024-aligned).
void host_tma_load_4d(void* dst, const TensorMap* m, int c0, int c1, int c2,
                      int c3, uint32_t bytes, uint64_t* bar) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  if (reinterpret_cast<uintptr_t>(d) % 1024 != 0) abort();
  size_t o = 0;
  for (int i3 = 0; i3 < m->box[3]; ++i3)
    for (int i2 = 0; i2 < m->box[2]; ++i2)
      for (int i1 = 0; i1 < m->box[1]; ++i1)
        for (int i0 = 0; i0 < m->box[0]; ++i0, o += 4) {
          const long long x[4] = {c0 + i0, c1 + i1, c2 + i2, c3 + i3};
          bool in = true;
          for (int k = 0; k < 4; ++k)
            in = in && x[k] >= 0 && x[k] < m->dims[k];
          float v = 0.f;
          if (in)
            memcpy(&v,
                   reinterpret_cast<const char*>(m->base) + x[0] * 4 +
                       x[1] * m->strides[0] + x[2] * m->strides[1] +
                       x[3] * m->strides[2],
                   4);
          memcpy(d + (o ^ (((o >> 7) & 7) << 4)), &v, 4);
        }
  if (o != bytes) abort();
  reinterpret_cast<std::atomic<uint64_t>*>(bar)->fetch_add(1);
}

}  // namespace encoder_conv

template <int kKs>
static int run(const encoder_conv::TensorMap& map,
               const encoder_conv::Params& p, int max_ctas) {
  using T = encoder_conv::Tiling<kKs>;
  encoder_conv::TensorMap m = map;
  m.box[0] = encoder_conv::kKc;
  m.box[1] = T::kBoxW;
  m.box[2] = T::kBoxH;
  m.box[3] = 1;
  HostLaunch launch{encoder_conv::smem_raw};
  return encoder_conv::run_conv<kKs>(launch, m, p, max_ctas);
}

int main(int argc, char** argv) {
  if (argc != 14) {
    fprintf(stderr,
            "usage: %s DIR B H W CIN X_CS KS COUT OUT_CS RES_CS RELU "
            "MAX_CTAS IN_PLACE\n",
            argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  int a[12];
  for (int i = 0; i < 12; ++i) a[i] = atoi(argv[2 + i]);
  const int batch = a[0], height = a[1], width = a[2], cin = a[3],
            x_cs = a[4], ks = a[5], cout = a[6], out_cs = a[7],
            res_cs = a[8], relu = a[9], max_ctas = a[10], in_place = a[11];
  auto in = [&](const char* name) { return slurp(dir + "/" + name); };
  const auto x = in("x"), wslab = in("wslab"), bias = in("bias"),
             out0 = in("out");
  std::vector<char> res;
  if (res_cs > 0 && !in_place) res = in("res");
  const size_t n_px = static_cast<size_t>(batch) * height * width;
  std::vector<float> xs(floats(x), floats(x) + n_px * x_cs);
  std::vector<float> out(floats(out0), floats(out0) + n_px * out_cs);

  encoder_conv::TensorMap map{};
  map.base = xs.data();
  map.dims[0] = cin;
  map.dims[1] = width;
  map.dims[2] = height;
  map.dims[3] = batch;
  map.strides[0] = 4LL * x_cs;
  map.strides[1] = 4LL * x_cs * width;
  map.strides[2] = 4LL * x_cs * width * height;
  encoder_conv::Params p{};
  p.wslab = floats(wslab);
  p.bias = floats(bias);
  if (in_place) {
    p.out = xs.data();
    p.res = xs.data();
    p.out2 = out.data();
    p.out_cs = p.res_cs = x_cs;
    p.out2_cs = out_cs;
  } else {
    p.out = out.data();
    p.res = res_cs > 0 ? floats(res) : nullptr;
    p.out2 = nullptr;
    p.out_cs = out_cs;
    p.res_cs = res_cs;
    p.out2_cs = 0;
  }
  p.batch = batch;
  p.height = height;
  p.width = width;
  p.cout = cout;
  p.n_chunks = (cin + encoder_conv::kKc - 1) / encoder_conv::kKc;
  p.relu = relu;
  int err = 1;
  if (ks == 3) err = run<3>(map, p, max_ctas);
  if (ks == 1) err = run<1>(map, p, max_ctas);
  if (err != 0) {
    fprintf(stderr, "launch failed: %d\n", err);
    return 1;
  }
  dump(dir + "/out_out", out);
  dump(dir + "/x_out", xs);
  return 0;
}
