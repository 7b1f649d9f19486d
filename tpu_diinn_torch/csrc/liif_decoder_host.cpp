// Host emulation of LIIF's query-MLP kernel (liif_decoder.cuh) for tests on
// a machine without a card: g++ runs its launch with one std::thread per
// CUDA thread (hopper_host.h), held against the torch path by
// tests/test_torch_liif_decoder.py.
//
//   g++ -std=c++20 -O1 -pthread -I tpu_diinn_torch/csrc
//       tpu_diinn_torch/csrc/liif_decoder_host.cpp -o liif_decoder_host
//   liif_decoder_host DIR B H_IN W_IN H_C W_C OUT_W COL0 MAX_CTAS IDX64
//
// DIR holds the raw little-endian inputs z (B, H_IN, W_IN, 256) float32;
// for each corner k, iy<k> (H_C), ry<k> (H_C float32), ix<k> (W_C), rx<k>
// (W_C float32), the indices int64 with IDX64 1, else int32; cell (2
// float32); small and wslab (the wrapper's small_operands and
// weight_slabs); and out (B, H_C, OUT_W, 3) float32, the output's prior
// content. The chunk writes columns COL0 ..
// COL0 + W_C - 1 of out; the program writes out_out, the output after the
// launch. The grid has at most MAX_CTAS CTAs.

#include "hopper_host.h"

#include "liif_decoder.cuh"

namespace liif_decoder {

alignas(1024) unsigned char smem_raw[kHostSmem];

void host_warp_sync() { (*g_warps)[t_thread / 32].bar->arrive_and_wait(); }

}  // namespace liif_decoder

int main(int argc, char** argv) {
  if (argc != 11) {
    fprintf(stderr,
            "usage: %s DIR B H_IN W_IN H_C W_C OUT_W COL0 MAX_CTAS IDX64\n",
            argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  int a[9];
  for (int i = 0; i < 9; ++i) a[i] = atoi(argv[2 + i]);
  const int batch = a[0], h_in = a[1], w_in = a[2], h_c = a[3], w_c = a[4],
            out_w = a[5], col0 = a[6], max_ctas = a[7], idx64 = a[8];
  auto in = [&](const std::string& name) { return slurp(dir + "/" + name); };
  const auto z = in("z"), cell = in("cell"), small = in("small"),
             wslab = in("wslab"), out0 = in("out");
  std::vector<std::vector<char>> corners;
  for (int k = 0; k < liif_decoder::kCorners; ++k)
    for (const char* name : {"iy", "ry", "ix", "rx"})
      corners.push_back(in(name + std::to_string(k)));
  const size_t n_out = static_cast<size_t>(batch) * h_c * out_w * 3;
  std::vector<float> out(floats(out0), floats(out0) + n_out);

  liif_decoder::Params p{};
  p.z = floats(z);
  for (int k = 0; k < liif_decoder::kCorners; ++k) {
    p.iy[k] = corners[4 * k].data();
    p.ry[k] = floats(corners[4 * k + 1]);
    p.ix[k] = corners[4 * k + 2].data();
    p.rx[k] = floats(corners[4 * k + 3]);
  }
  p.cell = floats(cell);
  p.small = floats(small);
  p.wslab = floats(wslab);
  p.out = out.data() + 3LL * col0;
  p.out_sy = 3LL * out_w;
  p.out_sb = 3LL * out_w * h_c;
  p.batch = batch;
  p.h_in = h_in;
  p.w_in = w_in;
  p.h_c = h_c;
  p.w_c = w_c;
  p.idx64 = idx64;
  HostLaunch launch{liif_decoder::smem_raw};
  const int err = liif_decoder::run_decode(launch, p, max_ctas);
  if (err != 0) {
    fprintf(stderr, "launch failed: %d\n", err);
    return 1;
  }
  dump(dir + "/out_out", out);
  return 0;
}
