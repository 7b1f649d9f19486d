// Host emulation of the forward kernels (decoder_fused.cuh,
// decoder_fwd_bf16.cuh) for tests on a machine without a card: g++ runs
// their launches with one std::thread per CUDA thread (hopper_host.h),
// held against the plain PyTorch versions by
// tests/test_torch_decoder_fused_host.py.
//
//   g++ -std=c++20 -O1 -pthread -I tpu_diinn_torch/csrc
//       tpu_diinn_torch/csrc/decoder_fused_host.cpp -o decoder_fused_host
//   decoder_fused_host DIR WINDOW B H_IN W_IN H_OUT W_OUT S_H S_W HIDDEN L
//       BF16 [MAX_CTAS]
//
// BF16 picks the kernel: 0 the fp32 one (decode_fwd_kernel, Tf32); 1 the
// bf16 mode's kernel (decode_fwd_bf16_kernel, run_fwd_bf16, whose
// persistent grid has at most MAX_CTAS CTAs, default one a tile); 2
// decode_fwd_kernel in the Bf16 policy, the chain routine that the
// backward recomputes the forward with, which the bf16 kernel must match
// bit for bit. DIR holds the raw little-endian inputs z, syn, w0, b0, wf,
// bcat, wl, bl (float32; in bf16, z, w0, wf and wl are bf16 bits; wf the
// wrapper's mma_b_slabs of the forward operand) and rows, cols (int32);
// the program writes out_out (B, H_OUT, W_OUT, 3, float32) there.

#include "hopper_host.h"

#include "decoder_fused.cuh"
#include "decoder_fwd_bf16.cuh"

namespace decoder_fused {
alignas(128) unsigned char smem_raw[kHostSmem];
}  // namespace decoder_fused
namespace decoder_fwd_bf16 {
alignas(128) unsigned char smem_raw[kHostSmem];
}  // namespace decoder_fwd_bf16

template <class T>
static const T* data(const std::vector<char>& v) {
  return reinterpret_cast<const T*>(v.data());
}

// kernel 0: Tf32, 1: the bf16 kernel, 2: decode_fwd_kernel in Bf16
template <int kNC, bool kWindow, int kKernel>
static int run(const std::string& dir, const int* a, int max_ctas) {
  using P = std::conditional_t<kKernel == 0, hopper_chain::Tf32,
                               hopper_chain::Bf16>;
  using Z = typename P::Z;
  using W = typename P::W;
  auto in = [&](const char* name) { return slurp(dir + "/" + name); };
  const auto z = in("z"), syn = in("syn"), w0 = in("w0"), b0 = in("b0"),
             wf = in("wf"), bcat = in("bcat"), wl = in("wl"), bl = in("bl"),
             rows = in("rows"), cols = in("cols");
  const int batch = a[0], h_in = a[1], w_in = a[2], h_out = a[3],
            w_out = a[4], s_h = a[5], s_w = a[6], L = a[8];
  std::vector<float> out(static_cast<size_t>(batch) * h_out * w_out * 3, NAN);
  int err;
  if constexpr (kKernel == 1) {
    HostLaunch launch{decoder_fwd_bf16::smem_raw};
    err = decoder_fwd_bf16::run_fwd_bf16<kNC, kWindow>(
        launch, data<Z>(z), floats(syn), ints(rows), ints(cols), data<W>(w0),
        floats(b0), data<W>(wf), floats(bcat), data<W>(wl), floats(bl),
        out.data(), batch, h_in, w_in, h_out, w_out, s_h, s_w, L, max_ctas);
  } else {
    HostLaunch launch{decoder_fused::smem_raw};
    err = decoder_fused::run_fwd<kNC, kWindow, P>(
        launch, data<Z>(z), floats(syn), ints(rows), ints(cols), data<W>(w0),
        floats(b0), data<W>(wf), floats(bcat), data<W>(wl), floats(bl),
        out.data(), batch, h_in, w_in, h_out, w_out, s_h, s_w, L);
  }
  if (err) return err;
  dump(dir + "/out_out", out);
  return 0;
}

template <int kKernel>
static int dispatch(const std::string& dir, bool window, const int* a,
                    int max_ctas) {
  switch (a[7]) {
    case 32:
      return window ? run<1, true, kKernel>(dir, a, max_ctas)
                    : run<1, false, kKernel>(dir, a, max_ctas);
    case 64:
      return window ? run<2, true, kKernel>(dir, a, max_ctas)
                    : run<2, false, kKernel>(dir, a, max_ctas);
    case 256:
      return window ? run<8, true, kKernel>(dir, a, max_ctas)
                    : run<8, false, kKernel>(dir, a, max_ctas);
    default: return 2;
  }
}

int main(int argc, char** argv) {
  if (argc != 13 && argc != 14) {
    fprintf(stderr, "usage: %s DIR WINDOW B H_IN W_IN H_OUT W_OUT S_H S_W "
                    "HIDDEN L BF16 [MAX_CTAS]\n", argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  const bool window = atoi(argv[2]) != 0;
  int a[9];
  for (int i = 0; i < 9; ++i) a[i] = atoi(argv[3 + i]);
  const int max_ctas = argc == 14 ? atoi(argv[13]) : 1 << 30;
  switch (atoi(argv[12])) {
    case 0: return dispatch<0>(dir, window, a, max_ctas);
    case 1: return dispatch<1>(dir, window, a, max_ctas);
    case 2: return dispatch<2>(dir, window, a, max_ctas);
    default: return 2;
  }
}
