// Host emulation of decoder_bwd.cuh for tests on a machine without a card:
// g++ runs run_bwd's whole launch sequence with one std::thread per CUDA
// thread (hopper_host.h), held against the plain PyTorch version by
// tests/test_torch_decoder_bwd_host.py.
//
//   g++ -std=c++20 -O1 -pthread -I tpu_diinn_torch/csrc
//       tpu_diinn_torch/csrc/decoder_bwd_host.cpp -o decoder_bwd_host
//   decoder_bwd_host DIR WINDOW B H_IN W_IN H_OUT W_OUT S_H S_W HIDDEN L BF16
//                    [plan]
//
// DIR holds the raw little-endian inputs z, syn, w0, b0, wf, bcat, wl, wt,
// g (float32; with BF16 = 1 z, w0, wf, wl and wt are bf16 bits; wf and wt
// the wrapper's mma_b_slabs) and rows, cols (int32); the program writes
// dz_out (z's type) and grads_out (float32, the flat Plan layout) there,
// and prints the scratch it allocates: "scratch_bytes N activation_bytes
// A n_query Q" (decoder_bwd::scratch_bytes; A without the partial sums).
// With "plan" it prints that line for the shape and stops (DIR unread).

#include "hopper_host.h"

#include "decoder_bwd.cuh"

namespace decoder_bwd {
alignas(16) unsigned char smem_raw[kHostSmem];
}  // namespace decoder_bwd

template <class T>
static const T* data(const std::vector<char>& v) {
  return reinterpret_cast<const T*>(v.data());
}

template <int kNC, bool kWindow, class P>
static int run(const std::string& dir, const int* a, bool plan_only) {
  using Z = typename P::Z;
  using W = typename P::W;
  const int batch = a[0], h_in = a[1], w_in = a[2], h_out = a[3],
            w_out = a[4], s_h = a[5], s_w = a[6], hidden = a[7], L = a[8];
  const long long n_query = static_cast<long long>(batch) * h_out * w_out;
  const long long n_pix = static_cast<long long>(batch) * h_in * w_in;
  const int run = kWindow ? 0 : s_h * s_w;
  const long long bytes = decoder_bwd::scratch_bytes(
      n_query, n_pix, run, hidden, L, P::kBf16, false);
  printf("scratch_bytes %lld activation_bytes %lld n_query %lld\n", bytes,
         decoder_bwd::scratch_bytes(n_query, n_pix, run, hidden, L,
                                    P::kBf16, true),
         n_query);
  fflush(stdout);
  if (plan_only) return 0;
  auto in = [&](const char* name) { return slurp(dir + "/" + name); };
  const auto z = in("z"), syn = in("syn"), w0 = in("w0"), b0 = in("b0"),
             wf = in("wf"), bcat = in("bcat"), wl = in("wl"), wt = in("wt"),
             g = in("g"), rows = in("rows"), cols = in("cols");
  // all bits set: NaN as fp32 and as bf16, to catch reads of unwritten
  // scratch
  std::vector<float> scratch((bytes + 3) / 4);
  memset(scratch.data(), 0xff, scratch.size() * 4);
  std::vector<Z> dz(static_cast<size_t>(batch) * h_in * w_in * L * hidden,
                    Z(0x7fc0));
  std::vector<float> grads(decoder_bwd::Plan(n_query, hidden, L).n_grad,
                           NAN);
  HostLaunch launch{decoder_bwd::smem_raw};
  const int err = decoder_bwd::run_bwd<kNC, kWindow, P>(
      launch, data<Z>(z), floats(syn), ints(rows), ints(cols), data<W>(w0),
      floats(b0), data<W>(wf), floats(bcat), data<W>(wl), data<W>(wt),
      floats(g), dz.data(), grads.data(), scratch.data(), batch, h_in, w_in,
      h_out, w_out, s_h, s_w, L);
  if (err) return err;
  if constexpr (sizeof(Z) == 2)
    dump_halves(dir + "/dz_out", dz);
  else
    dump(dir + "/dz_out", dz);
  dump(dir + "/grads_out", grads);
  return 0;
}

template <class P>
static int dispatch(const std::string& dir, bool window, const int* a,
                    bool plan_only) {
  switch (a[7]) {
    case 32:
      return window ? run<1, true, P>(dir, a, plan_only)
                    : run<1, false, P>(dir, a, plan_only);
    case 64:
      return window ? run<2, true, P>(dir, a, plan_only)
                    : run<2, false, P>(dir, a, plan_only);
    case 256:
      return window ? run<8, true, P>(dir, a, plan_only)
                    : run<8, false, P>(dir, a, plan_only);
    default: return 2;
  }
}

int main(int argc, char** argv) {
  const bool plan_only = argc == 14 && std::string(argv[13]) == "plan";
  if (argc != 13 && !plan_only) {
    fprintf(stderr, "usage: %s DIR WINDOW B H_IN W_IN H_OUT W_OUT S_H S_W "
                    "HIDDEN L BF16 [plan]\n", argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  const bool window = atoi(argv[2]) != 0;
  int a[9];
  for (int i = 0; i < 9; ++i) a[i] = atoi(argv[3 + i]);
  return atoi(argv[12])
             ? dispatch<hopper_chain::Bf16>(dir, window, a, plan_only)
             : dispatch<hopper_chain::Tf32>(dir, window, a, plan_only);
}
