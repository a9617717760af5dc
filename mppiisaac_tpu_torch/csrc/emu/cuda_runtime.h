// CPU emulation of the CUDA device code in this directory's parent, for the
// g++ harness of tests/test_torch_device_emu*.py (no nvcc there). A block is
// one warp of 32 lanes, each a cooperative fiber (ucontext, its own stack)
// on ONE OS thread: launch.cpp's scheduler resumes lanes 0..31 in turn, and
// __syncwarp / __syncthreads hand control back to it. Once all 32 lanes have
// arrived, it resumes them again in lane order. The shuffles pass values
// through an exchange array between two such barriers. Every warp
// collective must be reached by all 32 lanes, as on the card: a lane that
// returns while others wait at a barrier is a fault, which the scheduler
// reports.
#pragma once

#include <math.h>

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

// Internal linkage throughout (the emulation is one translation unit,
// launch.cpp), so that two emulation libraries loaded into one process, the
// default and the ablation build, keep their own.
namespace emu {
struct Warp {
  uint32_t ex[32];
};
// set by the scheduler before it resumes a lane
static dim3 thread_idx, block_idx;
static dim3 block_dim;
static Warp* warp = nullptr;
// the running lane's arrival at a barrier (launch.cpp)
static void barrier();
}  // namespace emu

#define threadIdx (emu::thread_idx)
#define blockIdx (emu::block_idx)
#define blockDim (emu::block_dim)

inline void __syncwarp(unsigned = 0xffffffffu) { emu::barrier(); }
inline void __syncthreads() { emu::barrier(); }

// value of lane `src` (or the caller's own value where src is out of range)
template <class T>
inline T emu_shfl(T v, int src) {
  static_assert(sizeof(T) <= 4, "32-bit shuffles only");
  const int lane = threadIdx.x & 31;
  uint32_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu::warp->ex[lane] = bits;
  emu::barrier();
  const uint32_t got = emu::warp->ex[(src >= 0 && src < 32) ? src : lane];
  emu::barrier();
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int = 32) { return emu_shfl(v, src); }
// bit l set where lane l's predicate is nonzero
inline unsigned __ballot_sync(unsigned, int pred) {
  const int lane = threadIdx.x & 31;
  emu::warp->ex[lane] = pred != 0;
  emu::barrier();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l) bits |= (emu::warp->ex[l] & 1u) << l;
  emu::barrier();
  return bits;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d, int = 32) { return emu_shfl(v, (int)(threadIdx.x & 31) - (int)d); }

inline long long clock64() { return 0; }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_RELAXED);
}
