// CPU emulation of the CUDA device code in this directory's parent, for the
// g++ harness of tests/test_torch_device_emu.py (no nvcc there). A block is
// one warp of 32 std::threads; __syncwarp and __syncthreads are a C++20
// std::barrier, and the shuffles pass values through an exchange array
// between two barrier phases. Every warp collective must be reached by all
// 32 threads, as on the card.
#pragma once

#include <math.h>

#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>

#define __device__
#define __global__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint32_t ex[32];
};
inline thread_local dim3 thread_idx, block_idx;
inline dim3 block_dim;
inline thread_local Warp* warp = nullptr;
}  // namespace emu

#define threadIdx (emu::thread_idx)
#define blockIdx (emu::block_idx)
#define blockDim (emu::block_dim)

inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp->bar.arrive_and_wait(); }
inline void __syncthreads() { __syncwarp(); }

// value of lane `src` (or the caller's own value where src is out of range)
template <class T>
inline T emu_shfl(T v, int src) {
  static_assert(sizeof(T) <= 4, "32-bit shuffles only");
  const int lane = threadIdx.x & 31;
  uint32_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu::warp->ex[lane] = bits;
  emu::warp->bar.arrive_and_wait();
  const uint32_t got = emu::warp->ex[(src >= 0 && src < 32) ? src : lane];
  emu::warp->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int = 32) { return emu_shfl(v, src); }
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d, int = 32) { return emu_shfl(v, (int)(threadIdx.x & 31) - (int)d); }

inline long long clock64() { return 0; }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_RELAXED);
}
