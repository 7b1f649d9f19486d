// Host emulation of decoder_bwd.cuh for tests on a machine without a card:
// g++ runs run_bwd's whole launch sequence with one std::thread per CUDA
// thread (hopper_host.h), held against the plain PyTorch version by
// tests/test_torch_decoder_bwd_host.py.
//
//   g++ -std=c++20 -O1 -pthread -I tpu_diinn_torch/csrc
//       tpu_diinn_torch/csrc/decoder_bwd_host.cpp -o decoder_bwd_host
//   decoder_bwd_host DIR WINDOW B H_IN W_IN H_OUT W_OUT S_H S_W HIDDEN L
//
// DIR holds the raw little-endian inputs z, syn, w0, b0, wf, bcat, wl, wt,
// g (float32; wf and wt the wrapper's mma_b_slabs) and rows, cols (int32);
// the program writes dz_out and grads_out (the flat Plan layout) there.

#include "hopper_host.h"

#include "decoder_bwd.cuh"

namespace decoder_bwd {
alignas(16) unsigned char smem_raw[kHostSmem];
}  // namespace decoder_bwd

template <int kNC, bool kWindow>
static int run(const std::string& dir, const int* a) {
  auto in = [&](const char* name) { return slurp(dir + "/" + name); };
  const auto z = in("z"), syn = in("syn"), w0 = in("w0"), b0 = in("b0"),
             wf = in("wf"), bcat = in("bcat"), wl = in("wl"), wt = in("wt"),
             g = in("g"), rows = in("rows"), cols = in("cols");
  const int batch = a[0], h_in = a[1], w_in = a[2], h_out = a[3],
            w_out = a[4], s_h = a[5], s_w = a[6], hidden = a[7], L = a[8];
  const decoder_bwd::Plan plan(static_cast<long long>(batch) * h_out * w_out,
                               hidden, L);
  std::vector<float> scratch(plan.s_total, NAN);
  std::vector<float> dz(static_cast<size_t>(batch) * h_in * w_in * L * hidden,
                        NAN);
  std::vector<float> grads(plan.n_grad, NAN);
  HostLaunch launch{decoder_bwd::smem_raw};
  const int err = decoder_bwd::run_bwd<kNC, kWindow>(
      launch, floats(z), floats(syn), ints(rows), ints(cols), floats(w0),
      floats(b0), floats(wf), floats(bcat), floats(wl), floats(wt),
      floats(g), dz.data(), grads.data(), scratch.data(), batch, h_in, w_in,
      h_out, w_out, s_h, s_w, L);
  if (err) return err;
  dump(dir + "/dz_out", dz);
  dump(dir + "/grads_out", grads);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 12) {
    fprintf(stderr, "usage: %s DIR WINDOW B H_IN W_IN H_OUT W_OUT S_H S_W "
                    "HIDDEN L\n", argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  const bool window = atoi(argv[2]) != 0;
  int a[9];
  for (int i = 0; i < 9; ++i) a[i] = atoi(argv[3 + i]);
  switch (a[7]) {
    case 32: return window ? run<1, true>(dir, a) : run<1, false>(dir, a);
    case 64: return window ? run<2, true>(dir, a) : run<2, false>(dir, a);
    case 256: return window ? run<8, true>(dir, a) : run<8, false>(dir, a);
    default: return 2;
  }
}
