// Host emulation of hopper_chain.cuh's device primitives, for tests on a
// machine without a card: g++ runs a kernel's launch sequence with one
// std::thread per CUDA thread, so the kernels' indexing, tiling,
// shared-memory layout, barrier protocol and 3xTF32 arithmetic can be
// checked against the plain PyTorch versions. What it cannot check: the
// PTX itself (wgmma's descriptor bits, cp.async, TMA), and timing. Used by
// decoder_fused_host.cpp and decoder_bwd_host.cpp, each included before
// the device header it runs.
//
// Emulation: __syncthreads is a std::barrier over the CTA's threads; a
// warpgroup's wgmma exchanges the A fragments through a per-warpgroup slot
// and a 128-thread barrier, then each thread computes its accumulator
// elements from the PTX fragment layouts with the operands cut to TF32, or
// (bf16 wgmma) from bf16 operands with fp32 sums; a warp shuffle
// exchanges through a per-warp slot and a 32-thread barrier; a
// TMA bulk copy is a memcpy that completes an atomic phase counter kept in
// the mbarrier's 8 bytes; cp.async is a plain copy. Shared memory is
// filled with NaN before each CTA, so a read of a value no thread wrote
// shows up in the result.

#pragma once

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
struct HostWarp {
  float v[32];
  std::unique_ptr<std::barrier<>> bar;
};
static std::vector<HostWarp>* g_warps;

// The warp's lanes all call it together, as on the card.
inline float __shfl_xor_sync(unsigned, float x, int lane_mask) {
  HostWarp& w = (*g_warps)[t_thread / 32];
  const int lane = t_thread % 32;
  w.v[lane] = x;
  w.bar->arrive_and_wait();
  const float out = w.v[lane ^ lane_mask];
  w.bar->arrive_and_wait();
  return out;
}

namespace hopper_chain {
void host_wgmma_tf32(float* d, int n, const uint32_t (&a)[4], const float* b,
                     bool accumulate);
void host_wgmma_bf16(float* d, int n, const uint32_t (&a)[4],
                     const uint16_t* b, bool accumulate);
void host_mbar_init(uint64_t* bar, int count);
void host_mbar_wait(uint64_t* bar, uint32_t parity);
void host_bulk_load(void* dst, const void* src, uint32_t bytes,
                    uint64_t* bar);

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

static float bf16_value(uint32_t h) {
  const uint32_t u = h << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// As host_wgmma_tf32 for one k16 step of bf16: A's fragment holds pairs of
// k (the lower k in the low half), B is mma_b_slabs' bf16 layout.
void host_wgmma_bf16(float* d, int n, const uint32_t (&a)[4],
                     const uint16_t* b, bool accumulate) {
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
      for (int k = 0; k < 16; ++k) {
        const uint32_t reg =
            g.a[(row / 16) * 32 + (r16 & 7) * 4 + ((k & 7) >> 1)]
               [(r16 >= 8) + 2 * (k >= 8)];
        const float av = bf16_value((k & 1) ? reg >> 16 : reg & 0xffffu);
        const float bv = bf16_value(
            b[(col / 8) * 128 + (k / 8) * 64 + (col % 8) * 8 + (k & 7)]);
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

}  // namespace hopper_chain

// The CTA's dynamic shared memory is the kernel namespace's smem_raw array
// (each harness defines it): HostLaunch runs the grid's CTAs one after
// another, each with its own threads, over that one array.
constexpr size_t kHostSmem = 232448;

struct HostLaunch {
  unsigned char* smem;

  template <class... KArgs, class... Args>
  int operator()(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                 int smem_bytes, Args... args) {
    if (smem_bytes > static_cast<int>(kHostSmem)) return 1;
    const int n = block.x * block.y * block.z;
    blockDim = block;
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          memset(smem, 0xff, kHostSmem);
          std::barrier<> cta(n);
          g_cta = &cta;
          std::vector<Warpgroup> groups((n + 127) / 128);
          for (auto& g : groups)
            g.bar = std::make_unique<std::barrier<>>(n < 128 ? n : 128);
          g_groups = &groups;
          std::vector<HostWarp> warps((n + 31) / 32);
          for (auto& w : warps)
            w.bar = std::make_unique<std::barrier<>>(n < 32 ? n : 32);
          g_warps = &warps;
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

// The raw little-endian bytes of a file (16 spare bytes at the end).
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

static const float* floats(const std::vector<char>& v) {
  return reinterpret_cast<const float*>(v.data());
}

static const uint16_t* halves(const std::vector<char>& v) {
  return reinterpret_cast<const uint16_t*>(v.data());
}

static void dump_halves(const std::string& path,
                        const std::vector<uint16_t>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), 2, v.size(), f);
  fclose(f);
}

static const int* ints(const std::vector<char>& v) {
  return reinterpret_cast<const int*>(v.data());
}
