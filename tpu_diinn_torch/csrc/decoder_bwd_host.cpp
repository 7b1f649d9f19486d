// Host emulation of decoder_bwd.cuh for tests on a machine without a card:
// g++ runs run_bwd's whole launch sequence with one std::thread per CUDA
// thread, so the kernels' indexing, tiling, shared-memory layout, barrier
// protocol and 3xTF32 arithmetic can be checked against the plain PyTorch
// version (tests/test_torch_decoder_bwd_host.py). What it cannot check:
// the PTX itself (wgmma's descriptor bits, cp.async, TMA), and timing.
//
//   g++ -std=c++20 -O1 -pthread -I tpu_diinn_torch/csrc
//       tpu_diinn_torch/csrc/decoder_bwd_host.cpp -o decoder_bwd_host
//   decoder_bwd_host DIR WINDOW B H_IN W_IN H_OUT W_OUT S_H S_W HIDDEN L
//
// DIR holds the raw little-endian inputs z, syn, w0, b0, wf, bcat, wl, wt,
// g (float32; wf and wt the wrapper's mma_b_slabs) and rows, cols (int32);
// the program writes dz_out and grads_out (the flat Plan layout) there.
//
// Emulation: __syncthreads is a std::barrier over the CTA's threads; a
// warpgroup's wgmma exchanges the A fragments through a per-warpgroup slot
// and a 128-thread barrier, then each thread computes its accumulator
// elements from the PTX fragment layouts with the operands cut to TF32; a
// TMA bulk copy is a memcpy that completes an atomic phase counter kept in
// the mbarrier's 8 bytes; cp.async is a plain copy. Shared memory is
// filled with NaN before each CTA, so a read of a value no thread wrote
// shows up in the result.

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
thread_local dim3 threadIdx, blockIdx;
static dim3 blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__

static std::barrier<>* g_cta;
inline void __syncthreads() { g_cta->arrive_and_wait(); }
inline void __syncwarp() {}

thread_local int t_thread;
struct Warpgroup {
  uint32_t a[128][4];
  std::unique_ptr<std::barrier<>> bar;
};
static std::vector<Warpgroup>* g_groups;

namespace decoder_bwd {
void host_wgmma_tf32(float* d, int n, const uint32_t (&a)[4], const float* b,
                     bool accumulate);
void host_mbar_init(uint64_t* bar, int count);
void host_mbar_wait(uint64_t* bar, uint32_t parity);
void host_bulk_load(void* dst, const void* src, uint32_t bytes,
                    uint64_t* bar);
}  // namespace decoder_bwd

#include "decoder_bwd.cuh"

namespace decoder_bwd {

alignas(16) unsigned char smem_raw[232448];

static float tf32(uint32_t u) {
  u &= 0xffffe000u;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

static float tf32(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return tf32(u);
}

void host_wgmma_tf32(float* d, int n, const uint32_t (&a)[4], const float* b,
                     bool accumulate) {
  Warpgroup& g = (*g_groups)[t_thread / 128];
  const int t = t_thread % 128;
  for (int i = 0; i < 4; ++i) g.a[t][i] = a[i];
  g.bar->arrive_and_wait();
  const int w = t / 32, gid = (t % 32) >> 2, tig = t & 3;
  std::vector<float> out(n / 2);
  for (int i = 0; i < n / 8; ++i)
    for (int c = 0; c < 4; ++c) {
      const int row = 16 * w + gid + 8 * (c >> 1);
      const int col = 8 * i + 2 * tig + (c & 1);
      const int r16 = row % 16;
      float acc = accumulate ? d[4 * i + c] : 0.f;
      for (int k = 0; k < 8; ++k) {
        // A: lane 4 gid + tig of the row's warp; B: mma_b_slabs' layout
        const float av = tf32(
            g.a[(row / 16) * 32 + (r16 & 7) * 4 + (k & 3)][(r16 >= 8) +
                                                           2 * (k >= 4)]);
        const float bv =
            tf32(b[(col / 8) * 64 + (k / 4) * 32 + (col % 8) * 4 + (k & 3)]);
        acc += av * bv;
      }
      out[4 * i + c] = acc;
    }
  g.bar->arrive_and_wait();
  for (int i = 0; i < n / 2; ++i) d[i] = out[i];
}

void host_mbar_init(uint64_t* bar, int) { new (bar) std::atomic<uint64_t>(0); }

void host_mbar_wait(uint64_t* bar, uint32_t parity) {
  auto* phase = reinterpret_cast<std::atomic<uint64_t>*>(bar);
  while ((phase->load() & 1) == parity) std::this_thread::yield();
}

void host_bulk_load(void* dst, const void* src, uint32_t bytes,
                    uint64_t* bar) {
  memcpy(dst, src, bytes);
  reinterpret_cast<std::atomic<uint64_t>*>(bar)->fetch_add(1);
}

}  // namespace decoder_bwd

struct HostLaunch {
  template <class... KArgs, class... Args>
  int operator()(void (*kernel)(KArgs...), dim3 grid, dim3 block, int smem,
                 Args... args) {
    if (smem > static_cast<int>(sizeof(decoder_bwd::smem_raw))) return 1;
    const int n = block.x * block.y * block.z;
    blockDim = block;
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          memset(decoder_bwd::smem_raw, 0xff, sizeof(decoder_bwd::smem_raw));
          std::barrier<> cta(n);
          g_cta = &cta;
          std::vector<Warpgroup> groups((n + 127) / 128);
          for (auto& g : groups)
            g.bar = std::make_unique<std::barrier<>>(n < 128 ? n : 128);
          g_groups = &groups;
          std::vector<std::thread> threads;
          for (int t = 0; t < n; ++t)
            threads.emplace_back([&, t] {
              threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                               t / (block.x * block.y));
              blockIdx = dim3(bx, by, bz);
              t_thread = t;
              kernel(args...);
            });
          for (auto& th : threads) th.join();
        }
    return 0;
  }
};

static std::vector<char> slurp(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    perror(path.c_str());
    exit(2);
  }
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> v(n + 16);
  if (fread(v.data(), 1, n, f) != static_cast<size_t>(n)) exit(2);
  fclose(f);
  return v;
}

static void dump(const std::string& path, const std::vector<float>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

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
  HostLaunch launch;
  auto f = [](const std::vector<char>& v) {
    return reinterpret_cast<const float*>(v.data());
  };
  const int err = decoder_bwd::run_bwd<kNC, kWindow>(
      launch, f(z), f(syn), reinterpret_cast<const int*>(rows.data()),
      reinterpret_cast<const int*>(cols.data()), f(w0), f(b0), f(wf),
      f(bcat), f(wl), f(wt), f(g), dz.data(), grads.data(), scratch.data(),
      batch, h_in, w_in, h_out, w_out, s_h, s_w, L);
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
