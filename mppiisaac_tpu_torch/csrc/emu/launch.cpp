// Launcher of the CPU emulation: the kernels of fused_rollout.cu run block by
// block, each block one warp of 32 cooperative fibers on the calling thread
// (cuda_runtime.h here).
//   g++ -std=c++20 -O1 -shared -fPIC -I. -o libfused_emu.so launch.cpp
// (add -DABLATE for the profiling ablations' instantiations, emu_*_ablate).
// tests/test_torch_device_emu*.py build it and load it with ctypes; the
// kernel wrappers never do.
//
// The scheduler: each lane is a ucontext with its own stack (LANE_STACK
// bytes, a PROT_NONE guard page below it, so an overflow faults instead of
// writing into the next lane's stack). A round resumes lanes 0..31 in order;
// each runs until it arrives at a barrier (__syncwarp, __syncthreads, a
// shuffle) or returns. When every lane waits, the next round begins; when
// every lane has returned, the block is done. Anything else means a
// collective that not all 32 lanes reached: the launch returns
// EMU_UNMATCHED and names the round on stderr. The stacks are painted with
// STACK_PAINT at first use; emu_stack_high_water() reports the deepest use of
// any lane since then (tests/test_torch_device_emu.py holds it below a
// quarter of LANE_STACK).
#define FUSED_EMU

#include <sys/mman.h>
#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

#include "cuda_runtime.h"

// one block's dynamic shared memory (the card gives a block at most 227 KB)
alignas(16) int smem[64 * 1024];

#include "../fused_rollout.cu"

namespace {

constexpr size_t LANE_STACK = size_t(256) << 10;   // 256 KiB per lane
constexpr size_t GUARD = 4096;
constexpr unsigned char STACK_PAINT = 0xA5;
constexpr int EMU_UNMATCHED = 3;
constexpr int EMU_NO_STACK = 4;
constexpr int EMU_NO_VARIANT = 5;

enum LaneState { RUNNING, WAITING, RETURNED };

struct Lane {
  ucontext_t ctx;
  LaneState state;
  unsigned char* stack;
};

Lane lanes[32];
ucontext_t scheduler;
int current = 0;
void (*block_body)(void*) = nullptr;
void* block_arg = nullptr;
unsigned char* stacks = nullptr;

bool map_stacks() {
  if (stacks != nullptr) return true;
  const size_t per = GUARD + LANE_STACK;
  void* p = mmap(nullptr, 32 * per, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return false;
  stacks = static_cast<unsigned char*>(p);
  for (int l = 0; l < 32; ++l) {
    unsigned char* base = stacks + l * per;
    if (mprotect(base, GUARD, PROT_NONE) != 0) return false;
    lanes[l].stack = base + GUARD;
    std::memset(lanes[l].stack, STACK_PAINT, LANE_STACK);
  }
  return true;
}

void lane_main() {
  block_body(block_arg);
  lanes[current].state = RETURNED;
  // uc_link resumes the scheduler
}

// run one block: 32 lanes of body(arg) with blockIdx.x = b
int run_block(int b, void (*body)(void*), void* arg) {
  if (!map_stacks()) return EMU_NO_STACK;
  emu::Warp warp{};
  block_body = body;
  block_arg = arg;
  for (int l = 0; l < 32; ++l) {
    Lane& ln = lanes[l];
    getcontext(&ln.ctx);
    ln.ctx.uc_stack.ss_sp = ln.stack;
    ln.ctx.uc_stack.ss_size = LANE_STACK;
    ln.ctx.uc_link = &scheduler;
    makecontext(&ln.ctx, lane_main, 0);
    ln.state = RUNNING;
  }
  for (long round = 0;; ++round) {
    for (int l = 0; l < 32; ++l) {
      current = l;
      emu::thread_idx.x = l;
      emu::block_idx.x = b;
      emu::warp = &warp;
      swapcontext(&scheduler, &lanes[l].ctx);
    }
    int waiting = 0, returned = 0;
    for (int l = 0; l < 32; ++l) {
      waiting += lanes[l].state == WAITING;
      returned += lanes[l].state == RETURNED;
    }
    if (returned == 32) return 0;
    if (waiting != 32) {
      std::fprintf(stderr,
                   "emu: block %d, barrier round %ld: %d lanes wait at a warp collective, "
                   "%d returned\n", b, round, waiting, returned);
      return EMU_UNMATCHED;
    }
    for (int l = 0; l < 32; ++l) lanes[l].state = RUNNING;
  }
}

}  // namespace

void emu::barrier() {
  lanes[current].state = WAITING;
  swapcontext(&lanes[current].ctx, &scheduler);
}

namespace {

struct RolloutArgs {
  const SceneTables* tables;
  const float *rows, *mass, *fric;
  const __nv_bfloat16* V;
  float *costs, *vis;
  int K, H, substeps, sweeps, world;
  float dt_sub;
};

struct WorldArgs {
  const SceneTables* tables;
  const float *rows, *tgt, *mass, *fric;
  float *out, *body;
  int N, substeps, sweeps;
  float dt_sub;
};

#ifdef ABLATE
// the instantiation of each mask of AB_K1_MASKS / AB_K2_MASKS (scene_tables.cuh)
template <int AB>
void rollout_t(void* p) {
  const RolloutArgs& a = *static_cast<RolloutArgs*>(p);
  fused_rollout_kernel<AB>(a.tables, a.rows, a.V, a.mass, a.fric, a.costs, a.vis, a.K, a.H,
                           a.substeps, a.dt_sub, a.sweeps, a.world);
}
template <int AB>
void world_t(void* p) {
  const WorldArgs& a = *static_cast<WorldArgs*>(p);
  fused_world_step_kernel<AB>(a.tables, a.rows, a.tgt, a.mass, a.fric, a.out, a.body, a.N,
                              a.substeps, a.dt_sub, a.sweeps, 1);
}
using Body = void (*)(void*);
Body rollout_body(int mask) {
#define AB_CASE(m) case (m): return rollout_t<(m)>;
  switch (mask) { AB_K1_MASKS(AB_CASE) }
#undef AB_CASE
  return nullptr;
}
Body world_body(int mask) {
#define AB_CASE(m) case (m): return world_t<(m)>;
  switch (mask) { AB_K2_MASKS(AB_CASE) }
#undef AB_CASE
  return nullptr;
}
#else
void rollout_k(void* p) {
  const RolloutArgs& a = *static_cast<RolloutArgs*>(p);
  fused_rollout_kernel(a.tables, a.rows, a.V, a.mass, a.fric, a.costs, a.vis, a.K, a.H,
                       a.substeps, a.dt_sub, a.sweeps, a.world);
}
void world_k(void* p) {
  const WorldArgs& a = *static_cast<WorldArgs*>(p);
  fused_world_step_kernel(a.tables, a.rows, a.tgt, a.mass, a.fric, a.out, a.body, a.N,
                          a.substeps, a.dt_sub, a.sweeps, 1);
}
using Body = void (*)(void*);
Body rollout_body(int mask) { return mask == 0 ? rollout_k : nullptr; }
Body world_body(int mask) { return mask == 0 ? world_k : nullptr; }
#endif

int rollout(int mask, const void* tables, const float* rows, const uint16_t* V, const float* mass,
            const float* fric, float* costs, float* vis, int K, int H, int substeps, float dt_sub,
            int sweeps, int world, int warp_bytes) {
  if ((long)sizeof(SceneTables) + warp_bytes > (long)sizeof(smem)) return 1;
  const Body body = rollout_body(mask);
  if (body == nullptr) return EMU_NO_VARIANT;
  emu::block_dim.x = 32;
  RolloutArgs a{(const SceneTables*)tables, rows, mass, fric, (const __nv_bfloat16*)V,
                costs, vis, K, H, substeps, sweeps, world, dt_sub};
  for (int k = 0; k < K; ++k)
    if (int rc = run_block(k, body, &a)) return rc;
  return 0;
}

int world_step(int mask, const void* tables, const float* rows, const float* tgt,
               const float* mass, const float* fric, float* out, float* body_out, int N,
               int substeps, float dt_sub, int sweeps, int warp_bytes) {
  if ((long)sizeof(SceneTables) + warp_bytes > (long)sizeof(smem)) return 1;
  const Body body = world_body(mask);
  if (body == nullptr) return EMU_NO_VARIANT;
  emu::block_dim.x = 32;
  WorldArgs a{(const SceneTables*)tables, rows, tgt, mass, fric, out, body_out, N, substeps,
              sweeps, dt_sub};
  for (int e = 0; e < N; ++e)
    if (int rc = run_block(e, body, &a)) return rc;
  return 0;
}

}  // namespace

extern "C" {

int emu_scene_tables_size() { return (int)sizeof(SceneTables); }

// the deepest any lane's stack has reached since the stacks were painted,
// in bytes, and the size of one lane's stack
long emu_stack_high_water() {
  if (stacks == nullptr) return 0;
  long most = 0;
  for (int l = 0; l < 32; ++l) {
    size_t i = 0;
    while (i < LANE_STACK && lanes[l].stack[i] == STACK_PAINT) ++i;
    if ((long)(LANE_STACK - i) > most) most = (long)(LANE_STACK - i);
  }
  return most;
}

long emu_lane_stack_size() { return (long)LANE_STACK; }

// K1's Ψ columns since the library was loaded: out[0] solved, out[1] held
void emu_psi_columns(unsigned long long* out) {
  out[0] = g_psi_columns[0];
  out[1] = g_psi_columns[1];
}

// K1 with one warp per block, block k running sample k
int emu_rollout(const void* tables, const float* rows, const uint16_t* V, const float* mass,
                const float* fric, float* costs, float* vis, int K, int H, int substeps,
                float dt_sub, int sweeps, int world, int warp_bytes) {
  return rollout(0, tables, rows, V, mass, fric, costs, vis, K, H, substeps, dt_sub, sweeps,
                 world, warp_bytes);
}

// K2 over N envs with one warp per block, block e running env e; body: the
// body caches' rows (13·B, N), or null for none
int emu_world_step(const void* tables, const float* rows, const float* tgt, const float* mass,
                   const float* fric, float* out, float* body, int N, int substeps,
                   float dt_sub, int sweeps, int warp_bytes) {
  return world_step(0, tables, rows, tgt, mass, fric, out, body, N, substeps, dt_sub, sweeps,
                    warp_bytes);
}

#ifdef ABLATE
// the same with an ablation mask (an instantiated one, else EMU_NO_VARIANT)
int emu_rollout_ablate(int mask, const void* tables, const float* rows, const uint16_t* V,
                       const float* mass, const float* fric, float* costs, float* vis, int K, int H,
                       int substeps, float dt_sub, int sweeps, int world, int warp_bytes) {
  return rollout(mask, tables, rows, V, mass, fric, costs, vis, K, H, substeps, dt_sub, sweeps,
                 world, warp_bytes);
}

int emu_world_step_ablate(int mask, const void* tables, const float* rows, const float* tgt,
                          const float* mass, const float* fric, float* out, float* body, int N,
                          int substeps, float dt_sub, int sweeps, int warp_bytes) {
  return world_step(mask, tables, rows, tgt, mass, fric, out, body, N, substeps, dt_sub, sweeps,
                    warp_bytes);
}
#endif

}  // extern "C"
