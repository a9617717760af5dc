// Launcher of the CPU emulation: the kernels of fused_rollout.cu run block by
// block, each block one warp of 32 std::threads (cuda_runtime.h here).
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -I. -o libfused_emu.so launch.cpp
// tests/test_torch_device_emu.py builds it and loads it with ctypes; the
// kernel wrappers never do.
#define FUSED_EMU

#include <cstdint>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

// one block's dynamic shared memory (the card gives a block at most 227 KB)
alignas(16) int smem[64 * 1024];

#include "../fused_rollout.cu"

template <class F>
static void run_block(int b, F&& body) {
  emu::Warp warp;
  std::vector<std::thread> lanes;
  for (int l = 0; l < 32; ++l)
    lanes.emplace_back([&, l] {
      emu::warp = &warp;
      emu::thread_idx.x = l;
      emu::block_idx.x = b;
      body();
    });
  for (auto& t : lanes) t.join();
}

extern "C" {

int emu_scene_tables_size() { return (int)sizeof(SceneTables); }

// K1 with one warp per block, block k running sample k
int emu_rollout(const void* tables, const float* rows, const uint16_t* V, const float* mass,
                const float* fric, float* costs, float* vis, int K, int H, int substeps,
                float dt_sub, int sweeps, int world, int warp_bytes) {
  if ((long)sizeof(SceneTables) + warp_bytes > (long)sizeof(smem)) return 1;
  emu::block_dim.x = 32;
  for (int k = 0; k < K; ++k)
    run_block(k, [&] {
      fused_rollout_kernel((const SceneTables*)tables, rows, (const __nv_bfloat16*)V, mass, fric,
                           costs, vis, K, H, substeps, dt_sub, sweeps, world);
    });
  return 0;
}

int emu_world_step(const void* tables, const float* rows, const float* tgt, const float* mass,
                   const float* fric, float* out, int substeps, float dt_sub, int sweeps,
                   int warp_bytes) {
  if ((long)sizeof(SceneTables) + warp_bytes > (long)sizeof(smem)) return 1;
  emu::block_dim.x = 32;
  run_block(0, [&] {
    fused_world_step_kernel((const SceneTables*)tables, rows, tgt, mass, fric, out, substeps,
                            dt_sub, sweeps, 1, 1);
  });
  return 0;
}

}  // extern "C"
