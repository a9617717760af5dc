// Scene tables, the per-sample state in a warp's region of shared memory, the
// warp collectives and small vector math shared by the fused kernels
// (fused_rollout.cu, contacts.cuh, impulse.cuh).
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
#define MAX_CHUNKS 48  // 32-lane chunks of whole pair blocks (a block never spans two)
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


// Per-warp layout: offsets (in 4-byte words) of the arrays of one sample's
// region of dynamic shared memory, in this order (ops/fused_rollout.py
// LAYOUT). ops/fused_rollout.pack_tables sizes each to the scene's own
// counts. The first five are the state rows in row order, so a sample's
// rows load and store as one contiguous copy. The DYN_* arrays (the
// velocity solves) and the IMP_* arrays (the impulse pass) share one area.
enum Layout {
  L_ROOT, L_Q, L_QD, L_NCF, L_LAM,                       // state rows
  L_POS, L_QUAT, L_LINV, L_ANGV, L_AXW,                  // Kin
  L_PLKN, L_PLKF,                                        // Plücker contact loads
  L_PT, L_NRM, L_DEPTH, L_LIVE,                          // Swept (L_LIVE: int per block)
  L_S, L_L, L_U, L_PSI, L_FV, L_DEF,                     // Ctx (L_DEF: int per actor)
  L_TGT, L_TG, L_UCMD, L_NEWQ, L_NEWQD, L_BSUM, L_FVS,   // per-step and per-substep
  L_IC, L_VB, L_ASP, L_FSUB, L_RHS, L_C, L_DIMP, L_UU, L_COEF, L_COL,        // DYN_*
  L_INVM, L_INVIW, L_CNTB, L_CNTA, L_ACT, L_MUB, L_KC, L_KNC, L_FLOOR, L_NEFF,  // IMP_*
  L_DP, L_DT, L_Y, L_V6, L_SA, L_SB, L_USED, L_SSUM,
  N_LAY
};

// Field order and types must match _SceneTablesC in ops/fused_rollout.py;
// scene_tables_size() lets the wrapper check the size at load. Every field
// is 4 bytes wide (the byte tables come in multiples of 4), so the struct
// has no padding.
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
  // lane orders (pack_tables): bodies by tree level; the contact chunks
  // (emitting or swept blocks) and the swept chunks, each 32 lanes of whole
  // blocks, as the block of every lane (255: idle) and each block's first
  // lane; the block of every swept candidate; the body of every Ψ slot
  int n_lvl, n_ck, n_sw, n_psi;
  int lvl_start[MAX_BODIES + 1], lvl_body[MAX_BODIES];
  unsigned char ck_blk[MAX_CHUNKS * 32], sw_blk[MAX_CHUNKS * 32];
  int blk_lane0[MAX_BLK], blk_swlane0[MAX_BLK];
  int cand_blk[MAX_CAND], psi_body[MAX_PSI];
  // the sides of blocks that act on each body (emitting sides: contacts),
  // free actor (swept free sides) and Ψ slot (swept articulated sides), in
  // block order, as lists of 2·block + side (side 1: b) from *_start
  int cb_start[MAX_BODIES + 1], cb_ent[2 * MAX_BLK];
  int ab_start[MAX_ACTORS + 1], ab_ent[2 * MAX_BLK];
  int pb_start[MAX_PSI + 1], pb_ent[MAX_BLK];
  // the per-warp region: offsets and its size in words
  int lay[N_LAY];
  int warp_words;
};

static_assert(sizeof(SceneTables) % 4 == 0, "SceneTables is copied as 32-bit words");
static_assert(sizeof(SceneTables) <= 48 * 1024, "SceneTables must fit one block's shared memory");

// Per-section cycle counters (scripts/profile_torch_step.py --sections builds
// with -DSECTION_CLOCKS into its own library): cycles of lane 0 of each
// sample's warp, summed over the samples of every launch, per kernel (0: K1,
// 1: K2) and section.
#define SEC_FK 0
#define SEC_CONTACTS 1
#define SEC_SOLVES 2      // velocity solves: free bodies and integration
#define SEC_INVMASS 3     // impulse pass: counts, friction, per-candidate inverse masses
#define SEC_WARM 4
#define SEC_SWEEPS 5
#define SEC_SNAP 6
#define SEC_COST 7        // command map, binarize, post-step FK, cost, vis
#define SEC_TREE 8        // velocity solves: inertias, subspaces, RNEA bias, composite sums
#define SEC_CRBA 9        // velocity solves: CRBA and drives
#define SEC_COUPLE 10     // velocity solves: couple terms
#define SEC_CHOL 11       // velocity solves: Cholesky factor and solve
#define SEC_PSI 12        // velocity solves: Ψ
#define N_SEC 13
#ifdef SECTION_CLOCKS
__device__ unsigned long long g_sections[2 * N_SEC];
#define SEC_BEGIN long long _sec_t = clock64()
#define SEC_RESET _sec_t = clock64()
#define SEC_MARK(kid, id)                                                                \
  do {                                                                                   \
    const long long _sec_n = clock64();                                                  \
    if ((threadIdx.x & 31) == 0)                                                         \
      atomicAdd(&g_sections[(kid) * N_SEC + (id)], (unsigned long long)(_sec_n - _sec_t)); \
    _sec_t = _sec_n;                                                                     \
  } while (0)
#else
#define SEC_BEGIN do {} while (0)
#define SEC_RESET do {} while (0)
#define SEC_MARK(kid, id) do {} while (0)
#endif

// Profiling ablations, the counterparts of the JAX package's FusedRollout
// profile flags and its TWO_WAY_SWEEPS / BROADPHASE_GATE switches. Timing
// only: all but AB_NO_GATE give physically wrong states on purpose. They
// exist only in the library built with -DABLATE (ops/native.py VARIANT
// "ablate", its own directory under _build/): there the kernels and the
// device functions that branch on them are templates on the mask AB, and the
// launchers instantiate the masks of AB_K1_MASKS / AB_K2_MASKS. In the
// default build nothing is a template and every macro below leaves the
// source as it is without the ablations (the compiler sees the same tokens,
// so the default kernels compile to the same code): AB_UNLESS(bit, x) is x,
// AB_OR(bit, x) is x, and the ablations' own blocks sit in #ifdef ABLATE.
#define AB_SKIP_CONTACTS 1    // no contacts: zero Plücker forces and net forces, no swept block
#define AB_SKIP_DYNAMICS 2    // no velocity solve: free roots drift ballistically
#define AB_ZERO_COST 4        // no post-step FK or cost: the cost is q[0] (root x of actor 0),
                              // vis the sum of the actors' root positions
#define AB_ONE_WAY_SWEEPS 8   // the sweeps leave the articulated side out (TWO_WAY_SWEEPS off)
#define AB_NO_GATE 16         // every block live (BROADPHASE_GATE off): no numerics change
#define AB_K1_MASKS(X) X(AB_ZERO_COST) X(AB_SKIP_CONTACTS) \
  X(AB_SKIP_CONTACTS | AB_SKIP_DYNAMICS | AB_ZERO_COST) X(AB_ONE_WAY_SWEEPS) X(AB_NO_GATE)
#define AB_K2_MASKS(X) X(AB_ONE_WAY_SWEEPS) X(AB_NO_GATE)
#ifdef ABLATE
#define AB_TEMPLATE template <int AB>
#define AB_ARG <AB>
#define AB_ON(bit) ((AB & (bit)) != 0)
#define AB_UNLESS(bit, x) ((x) && !AB_ON(bit))
#define AB_OR(bit, x) (AB_ON(bit) || (x))
#else
#define AB_TEMPLATE
#define AB_ARG
#define AB_UNLESS(bit, x) x
#define AB_OR(bit, x) x
#endif

// ---------------------------------------------------------------------------
// one sample's state and temporaries: views into its warp's region
// ---------------------------------------------------------------------------

// integrated state: roots, dofs, the last substep's reported net contact
// force, and the λ rows
struct Sample {
  float (*root)[13];
  float *q, *qd;
  float (*ncf)[3];
  float (*lam)[4];
};

// per-body kinematics of one substep
struct Kin {
  float (*pos)[3], (*quat)[4], (*linv)[3], (*angv)[3], (*axw)[3];
};

// swept blocks' contact geometry of one substep, by candidate (zero where
// the block's gate is off), and every block's gate
struct Swept {
  float (*pt)[3], (*nrm)[3], *depth;
  int* live;
};

// solve context of one substep, by velocity coordinate / Ψ slot / actor
struct Ctx {
  float (*S)[6];      // world motion subspace of every coordinate
  float* L;           // velocity-solve matrices (actor blocks, row stride nv), factored in place
  float* u;           // articulated actors' generalized velocity
  float (*psi)[36];   // Ψ per couple or stiction contact link
  float (*fv)[6];     // free bodies: linvel, angvel
  int* deferred;      // articulated actor in the impulse pass
  int kid;            // kernel id of the section counters
};

struct Warp {
  float* w;           // the region
  int lane;
  __device__ __forceinline__ float* f(const SceneTables& sc, int id) const { return w + sc.lay[id]; }
  __device__ __forceinline__ int* i(const SceneTables& sc, int id) const {
    return reinterpret_cast<int*>(w + sc.lay[id]);
  }
};

template <int N>
__device__ __forceinline__ float (*rows_of(float* p))[N] {
  return reinterpret_cast<float(*)[N]>(p);
}

__device__ __forceinline__ void bind(const SceneTables& sc, const Warp& W, Sample& s, Kin& k,
                                     Swept& sw, Ctx& c) {
  s.root = rows_of<13>(W.f(sc, L_ROOT));
  s.q = W.f(sc, L_Q);
  s.qd = W.f(sc, L_QD);
  s.ncf = rows_of<3>(W.f(sc, L_NCF));
  s.lam = rows_of<4>(W.f(sc, L_LAM));
  k.pos = rows_of<3>(W.f(sc, L_POS));
  k.quat = rows_of<4>(W.f(sc, L_QUAT));
  k.linv = rows_of<3>(W.f(sc, L_LINV));
  k.angv = rows_of<3>(W.f(sc, L_ANGV));
  k.axw = rows_of<3>(W.f(sc, L_AXW));
  sw.pt = rows_of<3>(W.f(sc, L_PT));
  sw.nrm = rows_of<3>(W.f(sc, L_NRM));
  sw.depth = W.f(sc, L_DEPTH);
  sw.live = W.i(sc, L_LIVE);
  c.S = rows_of<6>(W.f(sc, L_S));
  c.L = W.f(sc, L_L);
  c.u = W.f(sc, L_U);
  c.psi = rows_of<36>(W.f(sc, L_PSI));
  c.fv = rows_of<6>(W.f(sc, L_FV));
  c.deferred = W.i(sc, L_DEF);
}

// ---------------------------------------------------------------------------
// warp collectives (every lane of the warp reaches each call)
// ---------------------------------------------------------------------------

#define FULL_MASK 0xffffffffu

// inclusive segmented scan over the lanes: lane l ends with the sum of the
// values of lanes seg0..l, seg0 the first lane of its segment; a fixed tree,
// so the result repeats bit for bit
template <int N>
__device__ __forceinline__ void seg_scan(float* v, int lane, int seg0) {
  for (int d = 1; d < 32; d <<= 1) {
    const bool take = lane - d >= seg0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = __shfl_up_sync(FULL_MASK, v[i], d);
      if (take) v[i] += t;
    }
  }
}

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

// forward + back substitution with the factor block at (o, o), in x (which
// may alias b): each y_i and x_i overwrites b_i once it is no longer read
__device__ void chol_solve(const float* L, int o, int n, int ld, const float* b, float* x) {
  for (int i = 0; i < n; ++i) {
    float v = b[i];
    for (int q = 0; q < i; ++q) v -= L[(o + i) * ld + o + q] * x[q];
    x[i] = v / L[(o + i) * ld + o + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float v = x[i];
    for (int q = i + 1; q < n; ++q) v -= L[(o + q) * ld + o + i] * x[q];
    x[i] = v / L[(o + i) * ld + o + i];
  }
}

// The same factor by the warp: column by column, lanes over the rows below
// the diagonal, each entry's dot product in the serial order (n ≤ 32).
__device__ void chol_factor_warp(float* L, int o, int n, int ld, int lane) {
  for (int j = 0; j < n; ++j) {
    float d = L[(o + j) * ld + o + j];
    for (int q = 0; q < j; ++q) d -= L[(o + j) * ld + o + q] * L[(o + j) * ld + o + q];
    const float ljj = sqrtf(fmaxf(d, 1e-9f));
    const float inv = 1.f / ljj;
    float v = 0.f;
    const int i = lane;
    if (i > j && i < n) {
      v = L[(o + i) * ld + o + j];
      for (int q = 0; q < j; ++q) v -= L[(o + i) * ld + o + q] * L[(o + j) * ld + o + q];
    }
    __syncwarp();
    if (i == j) L[(o + j) * ld + o + j] = ljj;
    if (i > j && i < n) L[(o + i) * ld + o + j] = v * inv;
    __syncwarp();
  }
}

// forward + back substitution by the warp with the factor block at (o, o):
// lane i holds b_i and ends with x_i (n ≤ 32); the operations of
// chol_solve, the forward pass in its order and the back pass's sums in the
// reverse order
__device__ float chol_solve_warp(const float* L, int o, int n, int ld, float b, int lane) {
  const bool mine = lane < n;
  float v = b;
  for (int q = 0; q < n; ++q) {
    float yq = mine && lane == q ? v / L[(o + q) * ld + o + q] : 0.f;
    yq = __shfl_sync(FULL_MASK, yq, q);
    if (lane == q) v = yq;
    else if (mine && lane > q) v -= L[(o + lane) * ld + o + q] * yq;
  }
  for (int q = n - 1; q >= 0; --q) {
    float xq = mine && lane == q ? v / L[(o + q) * ld + o + q] : 0.f;
    xq = __shfl_sync(FULL_MASK, xq, q);
    if (lane == q) v = xq;
    else if (mine && lane < q) v -= L[(o + q) * ld + o + lane] * xq;
  }
  return v;
}
