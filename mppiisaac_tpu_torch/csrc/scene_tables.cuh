// Scene tables, per-sample state and small vector math shared by the fused
// kernels (fused_rollout.cu, contacts.cuh, impulse.cuh).
#pragma once

#include <cuda_runtime.h>

#define MAX_ACTORS 8
#define MAX_BODIES 32
#define MAX_DOFS 16
#define MAX_NU 16
#define MAX_GEOMS 64
#define MAX_BLK 48     // pair blocks
#define MAX_CAND 160   // swept contact candidates (λ rows / 4)
#define MAX_SC 1024    // box-sample constants
#define MAX_PSI 16     // couple and stiction contact links (operational inverse inertia Ψ)
#define MAX_BIN 4      // binarized gripper dofs
#define MAX_S 26       // manifold samples per block (the full box–box manifold's 26)
#define MAX_V 24       // velocity coordinates of all articulated actors (base + dofs)
#define MAX_XY 4       // obstacles or robots of a cost hook
#define N_POSE 9       // pose constants of TASK_OMNI_PICK (7 arm + 2 finger)
#define MAX_HT 8       // height terms of TASK_ANYMAL

#define JOINT_FIXED 0
#define JOINT_REVOLUTE 1
#define JOINT_PRISMATIC 2
#define DRIVE_NONE 0
#define DRIVE_VELOCITY 1
#define DRIVE_POSITION 2
#define DRIVE_EFFORT 3
#define GEOM_SPHERE 0
#define GEOM_BOX 1
#define GEOM_CAPSULE 2
#define ACTOR_STATIC 0
#define ACTOR_ARTICULATED 1
#define ACTOR_FREE 2
#define TASK_PANDA_REACH 1
#define TASK_PANDA_PICK 2
#define TASK_MOBILE_REACH 3
#define TASK_MOBILE_PUSH 4
#define TASK_POINT_ROBOT 5
#define TASK_MULTI_ROBOT 6
#define TASK_STICK_PUSH 7
#define TASK_OMNI_PICK 8
#define TASK_ALBERT 9
#define TASK_ANYMAL 10

// pair-block kinds and flags (ops/fused_contacts.py KIND_*, F_*)
#define KIND_CP 0
#define KIND_BP 1
#define KIND_CB 2
#define KIND_BBC 3
#define KIND_CC 4
#define KIND_BBA 5     // the full box–box manifold: ga's 26 samples against box gb
#define KIND_BBB 6     // ... gb's samples against box ga, normal from b to a
#define F_HAS_B 1
#define F_EMIT_A 2
#define F_EMIT_B 4
#define F_SWEPT 8
#define F_A_FREE 16
#define F_B_FREE 32
#define F_A_ART 64
#define F_B_ART 128
#define F_SLAB 256
#define F_A_STA 512    // side a: a floating-base articulation's link against a static geom
#define F_B_STA 1024

// Field order and types must match _SceneTablesC in ops/fused_rollout.py;
// scene_tables_size() lets the wrapper check the size at load. Every field
// is 4 bytes wide, so the struct has no padding.
// Articulated actors are solved by velocity coordinate: an actor's actor_nv
// coordinates start at actor_v0 and are its actor_base (6 for a floating
// base, its root body's Plücker velocity (ω, v_O)) base coordinates, then one
// per dof.
struct SceneTables {
  int nactor, nbody, ndof, ngeom, nu, nblk, n_fc, nbin, nv;
  int task, ee_body, goal_actor, vis_body, block_actor, force_body0, force_nbody;
  int force2_body0, force2_nbody, force_dims, xy_actor, xy_dof, n_xy, dof0, n_ht;
  int xy_actors[MAX_XY], xy_dofs[MAX_XY];
  float gravity_z, eps_v, max_depth, max_root_linvel, max_root_angvel, grip_force_gate;
  float mu_spindle;  // effort-finger spindle stiction (physics/stacked.py)
  float w_dist, w_ori, w_block, w_force, w_align, w_vel, goal_x, goal_y, goal_yaw;
  float w_pair, min_sep, w_height, height_floor, w_base_vel, w_arm_vel, w_pose, w_grip;
  float xy_gx[MAX_XY], xy_gy[MAX_XY], pose_c[N_POSE];
  int ht_body[MAX_HT];
  float ht_z[MAX_HT], ht_w[MAX_HT];
  int actor_body0[MAX_ACTORS], actor_nbody[MAX_ACTORS];
  int actor_dof0[MAX_ACTORS], actor_ndof[MAX_ACTORS];
  int actor_dynamic[MAX_ACTORS], actor_gravity[MAX_ACTORS];
  int actor_base[MAX_ACTORS], actor_v0[MAX_ACTORS], actor_nv[MAX_ACTORS];
  float actor_invm[MAX_ACTORS], actor_iinv[MAX_ACTORS * 9];
  int body_parent[MAX_BODIES], body_actor[MAX_BODIES];
  int body_jtype[MAX_BODIES], body_dof[MAX_BODIES];
  int body_vmask[MAX_BODIES], body_psi[MAX_BODIES];
  float body_jpos[MAX_BODIES * 3], body_jquat[MAX_BODIES * 4];
  float body_jaxis[MAX_BODIES * 3], body_mass[MAX_BODIES];
  float body_com[MAX_BODIES * 3], body_inertia[MAX_BODIES * 9];
  int v_body[MAX_V], v_anc[MAX_V * MAX_V];
  int dof_mode[MAX_DOFS], dof_motor[MAX_DOFS], dof_gate_body[MAX_DOFS];
  float dof_kp[MAX_DOFS], dof_kd[MAX_DOFS], dof_effort[MAX_DOFS];
  float dof_maxvel[MAX_DOFS], dof_damping[MAX_DOFS], dof_friction[MAX_DOFS];
  float dof_armature[MAX_DOFS], dof_lower[MAX_DOFS], dof_upper[MAX_DOFS];
  float cmd_W[MAX_DOFS * MAX_NU];
  int bin_dof[MAX_BIN], bin_src[MAX_BIN];
  float bin_lo[MAX_BIN], bin_hi[MAX_BIN], bin_th[MAX_BIN], bin_band[MAX_BIN];
  float bin_uhi[MAX_BIN], bin_ulo[MAX_BIN], bin_qopen[MAX_BIN];
  int geom_body[MAX_GEOMS], geom_type[MAX_GEOMS];
  float geom_pos[MAX_GEOMS * 3], geom_quat[MAX_GEOMS * 4], geom_size[MAX_GEOMS * 3];
  int blk_kind[MAX_BLK], blk_ga[MAX_BLK], blk_gb[MAX_BLK], blk_ba[MAX_BLK], blk_bb[MAX_BLK];
  int blk_S[MAX_BLK], blk_sc[MAX_BLK], blk_c0[MAX_BLK], blk_flags[MAX_BLK], blk_ob[MAX_BLK];
  float blk_thr[MAX_BLK], blk_kn[MAX_BLK], blk_kn_a[MAX_BLK], blk_kn_b[MAX_BLK];
  float blk_mu0[MAX_BLK], blk_m_oth[MAX_BLK], blk_npts[MAX_BLK];
  float sconst[MAX_SC];
};

static_assert(sizeof(SceneTables) % 4 == 0, "SceneTables is copied as 32-bit words");
static_assert(sizeof(SceneTables) <= 48 * 1024, "SceneTables must fit one block's shared memory");

// Per-sample integrated state (registers / local memory): roots, dofs, the
// last substep's reported net contact force, and the λ rows.
struct Sample {
  float root[MAX_ACTORS][13];
  float q[MAX_DOFS], qd[MAX_DOFS];
  float ncf[MAX_BODIES][3];
  float lam[MAX_CAND][4];
};

// Per-body kinematics of one substep.
struct Kin {
  float pos[MAX_BODIES][3], quat[MAX_BODIES][4];
  float linv[MAX_BODIES][3], angv[MAX_BODIES][3], axw[MAX_BODIES][3];
};

// Swept blocks' contact geometry of one substep, by candidate (zero where
// the block's gate is off), and each block's gate.
struct Swept {
  float pt[MAX_CAND][3], nrm[MAX_CAND][3], depth[MAX_CAND];
  bool live[MAX_BLK];
};

// ---------------------------------------------------------------------------
// small vector math (quaternions xyzw)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  float t[3], c[3];
  cross3(q, v, t);
  t[0] *= 2.f; t[1] *= 2.f; t[2] *= 2.f;
  cross3(q, t, c);
  o[0] = v[0] + q[3] * t[0] + c[0];
  o[1] = v[1] + q[3] * t[1] + c[1];
  o[2] = v[2] + q[3] * t[2] + c[2];
}

__device__ __forceinline__ void qrot_inv(const float* q, const float* v, float* o) {
  const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  qrot(qc, v, o);
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  float x = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  float y = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  float z = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  float w = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
  o[0] = x; o[1] = y; o[2] = z; o[3] = w;
}

// exponential-map integration by a world angular velocity (lanes qintegrate)
__device__ __forceinline__ void qintegrate(const float* q, const float* w, float dt, float* o) {
  const float angle = sqrtf(dot3(w, w) + 1e-9f);
  const float inv = 1.f / fmaxf(angle, 1e-9f);
  const float half = angle * dt * 0.5f;
  const float s = sinf(half);
  const float dq[4] = {w[0] * inv * s, w[1] * inv * s, w[2] * inv * s, cosf(half)};
  float p[4];
  qmul(dq, q, p);
  const float in = 1.f / sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + p[3] * p[3] + 1e-12f);
  for (int i = 0; i < 4; ++i) o[i] = p[i] * in;
}

__device__ __forceinline__ void q_to_R(const float* q, float R[3][3]) {
  float x = q[0], y = q[1], z = q[2], w = q[3];
  float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - wz); R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz); R[1][1] = 1.f - 2.f * (xx + zz); R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy); R[2][1] = 2.f * (yz + wx); R[2][2] = 1.f - 2.f * (xx + yy);
}

// motion cross product v ×m m, 6-vectors [ω; v_O]
__device__ __forceinline__ void crm6(const float* v, const float* m, float* o) {
  float a[3], b[3], c[3];
  cross3(v, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m, c);
  o[0] = a[0]; o[1] = a[1]; o[2] = a[2];
  o[3] = b[0] + c[0]; o[4] = b[1] + c[1]; o[5] = b[2] + c[2];
}

// force cross product v ×f f
__device__ __forceinline__ void crf6(const float* v, const float* f, float* o) {
  float a[3], b[3], c[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f + 3, c);
  o[0] = a[0] + b[0]; o[1] = a[1] + b[1]; o[2] = a[2] + b[2];
  o[3] = c[0]; o[4] = c[1]; o[5] = c[2];
}

__device__ __forceinline__ void mat6vec(const float* M, const float* v, float* o) {
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
    for (int j = 0; j < 6; ++j) s += M[i * 6 + j] * v[j];
    o[i] = s;
  }
}

// Cholesky factor of the n×n block of M at (o, o) (row stride ld) into the
// same block of L, pivots clamped to 1e-9 (lanes cholesky_factor). L may be
// M: each entry of M's lower triangle is read before its factor entry is
// written, and the upper triangle is left alone.
__device__ void chol_factor(const float* M, float* L, int o, int n, int ld) {
  for (int j = 0; j < n; ++j) {
    float d = M[(o + j) * ld + o + j];
    for (int q = 0; q < j; ++q) d -= L[(o + j) * ld + o + q] * L[(o + j) * ld + o + q];
    const float ljj = sqrtf(fmaxf(d, 1e-9f));
    L[(o + j) * ld + o + j] = ljj;
    const float inv = 1.f / ljj;
    for (int i = j + 1; i < n; ++i) {
      float v = M[(o + i) * ld + o + j];
      for (int q = 0; q < j; ++q) v -= L[(o + i) * ld + o + q] * L[(o + j) * ld + o + q];
      L[(o + i) * ld + o + j] = v * inv;
    }
  }
}

// forward + back substitution with the factor block at (o, o); x may alias b
__device__ void chol_solve(const float* L, int o, int n, int ld, const float* b, float* x) {
  float y[MAX_V];
  for (int i = 0; i < n; ++i) {
    float v = b[i];
    for (int q = 0; q < i; ++q) v -= L[(o + i) * ld + o + q] * y[q];
    y[i] = v / L[(o + i) * ld + o + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float v = y[i];
    for (int q = i + 1; q < n; ++q) v -= L[(o + q) * ld + o + i] * x[q];
    x[i] = v / L[(o + i) * ld + o + i];
  }
}
