// Fused MPPI rollout (K1) and fused world step (K2) for NVIDIA Hopper.
//
// Build (ops/native.py does this at first use, keyed by a hash of the
// sources in this directory):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_rollout.so fused_rollout.cu
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and returns cudaGetLastError().
//
// Both kernels run the same device code, one physics substep:
//   fk()         forward kinematics: revolute, prismatic and fixed joints
//                (replaces fused_physics.fk_lanes)
//   contacts()   broadphase gate, narrowphase of the cp, bp, cb and bbc
//                pair blocks, side-asymmetric penalty law, reported net
//                contact force, swept geometry (contacts.cuh)
//   dynamics()   velocity solve of every fixed-base articulation (spatial and
//                composite inertias, RNEA bias, CRBA, force-limited implicit
//                drives, joint damping, Coulomb friction, joint-limit
//                penalty, implicit couple terms, Cholesky) and of every free
//                single body; the impulse pass (impulse.cuh); clamped,
//                deferred integration (replaces dynamics_lanes)
// and the task cost hook task_cost() (replaces the objective kernel_cost
// functions; panda reach and panda pick are ported).
//
// The TPU kernels unrolled each scene into straight-line code with the scene
// constants baked in. These kernels are TABLE-DRIVEN instead: the scene is one
// SceneTables struct (ops/fused_rollout.py packs it, field for field, from
// ops/fused_physics.KernelScene), copied into dynamic shared memory by every
// block. One build serves every scene within the MAX_* bounds of
// scene_tables.cuh; the wrapper checks the bounds before it launches.
//
// State is structure-of-arrays: row r of sample k is rows[r * K + k], so
// neighbouring threads read neighbouring addresses. Rows per sample:
// 13 per actor (pos, quat xyzw, linvel, angvel), q[D], qd[D], net force[3B],
// then 4 λ rows [λ_n, λ_t·3] per swept contact candidate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "scene_tables.cuh"
#include "contacts.cuh"
#include "impulse.cuh"

// ---------------------------------------------------------------------------
// forward kinematics (fk_lanes)
// ---------------------------------------------------------------------------

__device__ void fk(const SceneTables& sc, const Sample& s, Kin& k) {
  for (int g = 0; g < sc.nbody; ++g) {
    const int p = sc.body_parent[g];
    if (p < 0) {
      const float* r = s.root[sc.body_actor[g]];
      for (int i = 0; i < 3; ++i) {
        k.pos[g][i] = r[i]; k.linv[g][i] = r[7 + i]; k.angv[g][i] = r[10 + i];
      }
      for (int i = 0; i < 4; ++i) k.quat[g][i] = r[3 + i];
      k.axw[g][0] = 1.f; k.axw[g][1] = 0.f; k.axw[g][2] = 0.f;
      continue;
    }
    const float* ax = &sc.body_jaxis[3 * g];
    float fpos[3], fq[4], vf[3], d[3], c[3];
    qrot(k.quat[p], &sc.body_jpos[3 * g], fpos);
    for (int i = 0; i < 3; ++i) fpos[i] += k.pos[p][i];
    qmul(k.quat[p], &sc.body_jquat[4 * g], fq);
    for (int i = 0; i < 3; ++i) d[i] = fpos[i] - k.pos[p][i];
    cross3(k.angv[p], d, c);
    for (int i = 0; i < 3; ++i) vf[i] = k.linv[p][i] + c[i];
    const int jt = sc.body_jtype[g];
    const int dof = sc.body_dof[g];
    if (jt == JOINT_REVOLUTE) {
      float half = s.q[dof] * 0.5f;
      float sn = sinf(half), cs = cosf(half);
      float rotq[4] = {ax[0] * sn, ax[1] * sn, ax[2] * sn, cs};
      float aw[3];
      qrot(fq, ax, aw);
      qmul(fq, rotq, k.quat[g]);
      for (int i = 0; i < 3; ++i) {
        k.pos[g][i] = fpos[i];
        k.angv[g][i] = k.angv[p][i] + aw[i] * s.qd[dof];
        k.linv[g][i] = vf[i];
        k.axw[g][i] = aw[i];
      }
    } else if (jt == JOINT_PRISMATIC) {
      float aw[3], bp[3], e[3];
      qrot(fq, ax, aw);
      for (int i = 0; i < 3; ++i) bp[i] = fpos[i] + aw[i] * s.q[dof];
      for (int i = 0; i < 3; ++i) d[i] = bp[i] - fpos[i];
      cross3(k.angv[p], d, e);
      for (int i = 0; i < 4; ++i) k.quat[g][i] = fq[i];
      for (int i = 0; i < 3; ++i) {
        k.pos[g][i] = bp[i];
        k.angv[g][i] = k.angv[p][i];
        k.linv[g][i] = vf[i] + e[i] + aw[i] * s.qd[dof];
        k.axw[g][i] = aw[i];
      }
    } else {
      for (int i = 0; i < 4; ++i) k.quat[g][i] = fq[i];
      for (int i = 0; i < 3; ++i) {
        k.pos[g][i] = fpos[i];
        k.angv[g][i] = k.angv[p][i];
        k.linv[g][i] = vf[i];
      }
      k.axw[g][0] = 1.f; k.axw[g][1] = 0.f; k.axw[g][2] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// velocity solves, impulse pass and integration (dynamics_lanes)
// mass: this sample's body mass scales, stride K
// ---------------------------------------------------------------------------

__device__ void spatial_inertia(const SceneTables& sc, int g, const float* pos, const float* quat,
                                float ms, float* M6) {
  float R[3][3], com_w[3];
  q_to_R(quat, R);
  qrot(quat, &sc.body_com[3 * g], com_w);
  for (int i = 0; i < 3; ++i) com_w[i] += pos[i];
  const float* I = &sc.body_inertia[9 * g];
  const float m = sc.body_mass[g] * ms;
  float RI[3][3], Iw[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      RI[i][j] = R[i][0] * I[0 * 3 + j] + R[i][1] * I[1 * 3 + j] + R[i][2] * I[2 * 3 + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Iw[i][j] = (RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2]) * ms;
  const float cx = com_w[0], cy = com_w[1], cz = com_w[2];
  const float C[3][3] = {{0.f, -cz, cy}, {cz, 0.f, -cx}, {-cy, cx, 0.f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float cct = C[i][0] * C[j][0] + C[i][1] * C[j][1] + C[i][2] * C[j][2];
      M6[i * 6 + j] = Iw[i][j] + m * cct;
      M6[i * 6 + 3 + j] = m * C[i][j];
      M6[(3 + i) * 6 + j] = m * C[j][i];
      M6[(3 + i) * 6 + 3 + j] = i == j ? m : 0.f;
    }
}

// free single body: the 6-dof velocity solve of dynamics_lanes (base = 6,
// nv = 6) → c.fv[a] = (clamped root linvel, angvel)
__device__ void free_velocity(const SceneTables& sc, const Sample& s, const Kin& k, int a,
                              const float plk_n[][3], const float plk_f[][3], const float* mass,
                              int K, float dt, Ctx& c) {
  const int g = sc.actor_body0[a];
  float I6[36], vb[6], Ia[6], Iv[6], cf[6], f[6], Mm[36], Lm[36], rhs[6], u[6], cr[3];
  spatial_inertia(sc, g, k.pos[g], k.quat[g], mass[g * K], I6);
  cross3(k.angv[g], k.pos[g], cr);
  for (int r = 0; r < 3; ++r) { vb[r] = k.angv[g][r]; vb[3 + r] = k.linv[g][r] - cr[r]; }
  const float a0[6] = {0.f, 0.f, 0.f, 0.f, 0.f, sc.actor_gravity[a] ? sc.gravity_z : 0.f};
  mat6vec(I6, a0, Ia);
  mat6vec(I6, vb, Iv);
  crf6(vb, Iv, cf);
  for (int r = 0; r < 3; ++r) {
    f[r] = Ia[r] + cf[r] - plk_n[g][r];
    f[3 + r] = Ia[3 + r] + cf[3 + r] - plk_f[g][r];
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) Mm[i * 6 + j] = i <= j ? I6[i * 6 + j] : I6[j * 6 + i];
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
    for (int j = 0; j < 6; ++j) acc += Mm[i * 6 + j] * vb[j];
    rhs[i] = acc + dt * (0.f - f[i]);
  }
  for (int i = 0; i < 6; ++i) Mm[i * 6 + i] += 1e-8f;
  chol_factor(Mm, Lm, 0, 6, 6);
  chol_solve(Lm, 0, 6, 6, rhs, u);
  const float* pr = s.root[a];
  cross3(u, pr, cr);
  const float wcap = sc.max_root_angvel, vcap = sc.max_root_linvel;
  for (int i = 0; i < 3; ++i) {
    c.fv[a][i] = fminf(fmaxf(u[3 + i] + cr[i], -vcap), vcap);
    c.fv[a][3 + i] = fminf(fmaxf(u[i], -wcap), wcap);
  }
}

__device__ void integrate_dofs(const SceneTables& sc, const Sample& s, int a, const float* u,
                               float dt, float* new_q, float* new_qd) {
  const int dof0 = sc.actor_dof0[a], nd = sc.actor_ndof[a];
  for (int i = 0; i < nd; ++i) {
    const int dg = dof0 + i;
    const float mv = sc.dof_maxvel[dg];
    const float qd_k = fminf(fmaxf(u[i], -mv), mv);
    float qk = s.q[dg] + dt * qd_k;
    qk = fminf(fmaxf(qk, sc.dof_lower[dg] - 1e-3f), sc.dof_upper[dg] + 1e-3f);
    new_q[dg] = qk;
    new_qd[dg] = qd_k;
  }
}

// Velocity solves of every dynamic actor, the impulse pass, and the
// integration (dynamics_lanes at world fidelity).
__device__ void dynamics(const SceneTables& sc, Sample& s, const Kin& k, const float plk_n[][3],
                         const float plk_f[][3], const float* tgt, const float* mass,
                         const float* fric, int K, float dt, const Swept& sw, int sweeps, Ctx& c) {
  float Ic[MAX_BODIES][36];
  float vb[MAX_BODIES][6], asp[MAX_BODIES][6], fsub[MAX_BODIES][6];
  float rhs[MAX_DOFS], x[MAX_DOFS];
  float new_q[MAX_DOFS], new_qd[MAX_DOFS];
  for (int d = 0; d < sc.ndof; ++d) { new_q[d] = s.q[d]; new_qd[d] = s.qd[d]; }
  bool any_free = false, any_deferred = false;

  for (int a = 0; a < sc.nactor; ++a) {
    c.deferred[a] = false;
    if (sc.actor_dynamic[a] == ACTOR_FREE) {
      free_velocity(sc, s, k, a, plk_n, plk_f, mass, K, dt, c);
      any_free = true;
      continue;
    }
    if (sc.actor_dynamic[a] != ACTOR_ARTICULATED) continue;
    const int bo = sc.actor_body0[a], nb = sc.actor_nbody[a];
    const int dof0 = sc.actor_dof0[a], nd = sc.actor_ndof[a];
    for (int i = 0; i < nb; ++i) {
      const int g = bo + i;
      spatial_inertia(sc, g, k.pos[g], k.quat[g], mass[g * K], Ic[i]);
      float cr[3];
      cross3(k.angv[g], k.pos[g], cr);
      for (int r = 0; r < 3; ++r) { vb[i][r] = k.angv[g][r]; vb[i][3 + r] = k.linv[g][r] - cr[r]; }
    }
    for (int j = 0; j < nd; ++j) {
      const int g = sc.dof_body[dof0 + j];
      const float* aw = k.axw[g];
      float* Sj = c.S[dof0 + j];
      if (sc.body_jtype[g] == JOINT_REVOLUTE) {
        float cr[3];
        cross3(k.pos[g], aw, cr);
        for (int r = 0; r < 3; ++r) { Sj[r] = aw[r]; Sj[3 + r] = cr[r]; }
      } else {
        for (int r = 0; r < 3; ++r) { Sj[r] = 0.f; Sj[3 + r] = aw[r]; }
      }
    }
    // bias forces: RNEA with qdd = 0, gravity as a base acceleration
    const float gz = sc.actor_gravity[a] ? sc.gravity_z : 0.f;
    for (int r = 0; r < 6; ++r) asp[0][r] = 0.f;
    asp[0][5] = gz;
    for (int i = 1; i < nb; ++i) {
      const int p = sc.body_parent[bo + i] - bo;
      for (int r = 0; r < 6; ++r) asp[i][r] = asp[p][r];
      const int dg = sc.body_dof[bo + i];
      if (dg >= 0) {
        float sq[6], c6[6];
        for (int r = 0; r < 6; ++r) sq[r] = c.S[dg][r] * s.qd[dg];
        crm6(vb[i], sq, c6);
        for (int r = 0; r < 6; ++r) asp[i][r] += c6[r];
      }
    }
    for (int i = 0; i < nb; ++i) {
      const int g = bo + i;
      float Ia[6], Iv[6], cf[6];
      mat6vec(Ic[i], asp[i], Ia);
      mat6vec(Ic[i], vb[i], Iv);
      crf6(vb[i], Iv, cf);
      for (int r = 0; r < 3; ++r) {
        fsub[i][r] = Ia[r] + cf[r] - plk_n[g][r];
        fsub[i][3 + r] = Ia[3 + r] + cf[3 + r] - plk_f[g][r];
      }
    }
    // composite inertias and subtree forces (children follow parents)
    for (int i = nb - 1; i > 0; --i) {
      const int p = sc.body_parent[bo + i] - bo;
      for (int r = 0; r < 36; ++r) Ic[p][r] += Ic[i][r];
      for (int r = 0; r < 6; ++r) fsub[p][r] += fsub[i][r];
    }
    float C[MAX_DOFS];
    for (int j = 0; j < nd; ++j) {
      const int bj = sc.dof_body[dof0 + j] - bo;
      float v = 0.f;
      for (int r = 0; r < 6; ++r) v += c.S[dof0 + j][r] * fsub[bj][r];
      C[j] = v;
    }
    // CRBA on ancestor pairs, into the actor's block of c.M
    float* M = c.M;
    for (int i = 0; i < nd; ++i)
      for (int j = 0; j < nd; ++j) M[(dof0 + i) * MAX_DOFS + dof0 + j] = 0.f;
    for (int j = 0; j < nd; ++j) {
      const int bj = sc.dof_body[dof0 + j] - bo;
      float F[6];
      mat6vec(Ic[bj], c.S[dof0 + j], F);
      for (int i = 0; i < nd; ++i) {
        if (!sc.dof_anc[(dof0 + i) * MAX_DOFS + dof0 + j]) continue;
        float v = 0.f;
        for (int r = 0; r < 6; ++r) v += c.S[dof0 + i][r] * F[r];
        M[(dof0 + i) * MAX_DOFS + dof0 + j] = v;
        M[(dof0 + j) * MAX_DOFS + dof0 + i] = v;
      }
    }
    // drives: rhs = M u + dt (tau − C), M_solve = M + diag(dt d_imp + 1e-8)
    float dimp[MAX_DOFS];
    for (int i = 0; i < nd; ++i) {
      const int dg = dof0 + i;
      const float qk = s.q[dg], qdk = s.qd[dg], tg = tgt[dg];
      const float effort = sc.dof_effort[dg];
      float tk = 0.f, dk = 0.f;
      if (sc.dof_mode[dg] == DRIVE_VELOCITY) {
        const float kd_eff = fminf(sc.dof_kd[dg], effort / fmaxf(fabsf(tg - qdk), 1e-6f));
        tk = kd_eff * tg;
        dk = kd_eff;
      } else if (sc.dof_mode[dg] == DRIVE_POSITION) {
        const float kp_eff = fminf(sc.dof_kp[dg], effort / fmaxf(fabsf(tg - qk), 1e-6f));
        tk = kp_eff * (tg - qk);
        dk = kp_eff * dt + sc.dof_kd[dg];
      }
      dk = dk + sc.dof_damping[dg];
      dk = dk + sc.dof_friction[dg] / (fabsf(qdk) + 0.02f);
      const float below = fmaxf(sc.dof_lower[dg] - qk, 0.f);
      const float above = fmaxf(qk - sc.dof_upper[dg], 0.f);
      const bool viol = (below > 0.f) || (above > 0.f);
      tk = tk + 1.0e3f * (below - above) - (viol ? 1.0e2f * qdk : 0.f);
      float acc = 0.f;
      for (int j = 0; j < nd; ++j) acc += M[(dof0 + i) * MAX_DOFS + dof0 + j] * s.qd[dof0 + j];
      rhs[i] = acc + dt * (tk - C[i]);
      dimp[i] = dk + sc.dof_armature[dg];
    }
    for (int i = 0; i < nd; ++i) M[(dof0 + i) * MAX_DOFS + dof0 + i] += dimp[i] * dt + 1e-8f;
    bool couple = false;
    for (int bi = 0; bi < sc.nblk; ++bi)
      couple |= is_couple(sc, bi) && sc.body_actor[art_body_of(sc, bi)] == a;
    if (couple) couple_terms(sc, k, sw, a, mass, K, dt, c, rhs);
    chol_factor(c.M, c.L, dof0, nd, MAX_DOFS);
    chol_solve(c.L, dof0, nd, MAX_DOFS, rhs, x);
    if (couple) {
      // the factor, the subspaces and Ψ stay live for the impulse sweeps;
      // the integration waits until after them
      for (int i = 0; i < nd; ++i) c.u[dof0 + i] = x[i];
      psi_blocks(sc, a, c);
      c.deferred[a] = true;
      any_deferred = true;
      continue;
    }
    integrate_dofs(sc, s, a, x, dt, new_q, new_qd);
  }

  bool any_swept = false;
  for (int bi = 0; bi < sc.nblk; ++bi) any_swept |= (sc.blk_flags[bi] & F_SWEPT) != 0;
  if (any_swept && sweeps > 0 && (any_free || any_deferred))
    impulse_pass(sc, s, k, mass, fric, K, dt, sw, sweeps, c);
  for (int a = 0; a < sc.nactor; ++a) {
    if (c.deferred[a]) integrate_dofs(sc, s, a, &c.u[sc.actor_dof0[a]], dt, new_q, new_qd);
    if (sc.actor_dynamic[a] == ACTOR_FREE) {
      float* r = s.root[a];
      float nq[4];
      qintegrate(&r[3], &c.fv[a][3], dt, nq);
      for (int i = 0; i < 3; ++i) {
        r[i] = r[i] + c.fv[a][i] * dt;
        r[7 + i] = c.fv[a][i];
        r[10 + i] = c.fv[a][3 + i];
      }
      for (int i = 0; i < 4; ++i) r[3 + i] = nq[i];
    }
  }
  for (int d = 0; d < sc.ndof; ++d) { s.q[d] = new_q[d]; s.qd[d] = new_qd[d]; }
}

// One substep at world fidelity: FK → contacts → velocity solves → impulse
// pass → integration. The per-substep temporaries live in `w`.
struct Work {
  Kin kin;
  Swept sw;
  Ctx ctx;
  float plk_n[MAX_BODIES][3], plk_f[MAX_BODIES][3];
};

__device__ void substep(const SceneTables& sc, Sample& s, Work& w, const float* tgt,
                        const float* mass, const float* fric, int K, float dt, int sweeps) {
  fk(sc, s, w.kin);
  contacts(sc, w.kin, fric, K, dt, w.plk_n, w.plk_f, s.ncf, w.sw);
  dynamics(sc, s, w.kin, w.plk_n, w.plk_f, tgt, mass, fric, K, dt, w.sw, sweeps, w.ctx);
}

// ---------------------------------------------------------------------------
// task cost hook (objective kernel_cost), on the post-step kinematics
// ---------------------------------------------------------------------------

__device__ float task_cost(const SceneTables& sc, const Sample& s, const Kin& k) {
  // TASK_PANDA_REACH: w_dist·‖ee − goal‖ + w_ori·‖(pitch, yaw)‖;
  // TASK_PANDA_PICK: w_dist·‖ee − block‖ + w_block·‖block − goal‖
  //   + w_force·|F_table|₁ + w_ori·‖(pitch, yaw)‖ (the wrapper admits no
  //   other id)
  const float* q = k.quat[sc.ee_body];
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float sp = fminf(fmaxf(2.f * (w * y - z * x), -1.f), 1.f);
  const float pitch = atan2f(sp, sqrtf(fmaxf(1.f - sp * sp, 1e-12f)));
  const float yaw = atan2f(2.f * (w * z + x * y), 1.f - 2.f * (y * y + z * z));
  const float ori = sqrtf(yaw * yaw + pitch * pitch + 1e-12f);
  const float* r = k.pos[sc.ee_body];
  const float* goal = s.root[sc.goal_actor];
  if (sc.task == TASK_PANDA_REACH) {
    const float dx = r[0] - goal[0], dy = r[1] - goal[1], dz = r[2] - goal[2];
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
    return sc.w_dist * dist + sc.w_ori * ori;
  }
  const float* block = s.root[sc.block_actor];
  float d1[3], d2[3], tf[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < 3; ++i) { d1[i] = r[i] - block[i]; d2[i] = block[i] - goal[i]; }
  for (int b = sc.force_body0; b < sc.force_body0 + sc.force_nbody; ++b)
    for (int i = 0; i < 3; ++i) tf[i] += s.ncf[b][i];
  const float d_rb = sqrtf(dot3(d1, d1) + 1e-12f);
  const float d_bg = sqrtf(dot3(d2, d2) + 1e-12f);
  const float forces = fabsf(tf[0]) + fabsf(tf[1]) + fabsf(tf[2]);
  return sc.w_dist * d_rb + sc.w_block * d_bg + sc.w_force * forces + sc.w_ori * ori;
}

// ---------------------------------------------------------------------------
// state rows <-> per-sample state (state rows, then 4 λ rows per candidate)
// ---------------------------------------------------------------------------

__device__ void load_sample(const SceneTables& sc, const float* rows, int K, int k, Sample& s) {
  int r = 0;
  for (int a = 0; a < sc.nactor; ++a)
    for (int i = 0; i < 13; ++i) s.root[a][i] = rows[(r++) * K + k];
  for (int d = 0; d < sc.ndof; ++d) s.q[d] = rows[(r++) * K + k];
  for (int d = 0; d < sc.ndof; ++d) s.qd[d] = rows[(r++) * K + k];
  for (int b = 0; b < sc.nbody; ++b)
    for (int i = 0; i < 3; ++i) s.ncf[b][i] = rows[(r++) * K + k];
  for (int c = 0; c < sc.n_fc; ++c)
    for (int i = 0; i < 4; ++i) s.lam[c][i] = rows[(r++) * K + k];
}

__device__ void store_sample(const SceneTables& sc, const Sample& s, float* rows, int K, int k) {
  int r = 0;
  for (int a = 0; a < sc.nactor; ++a)
    for (int i = 0; i < 13; ++i) rows[(r++) * K + k] = s.root[a][i];
  for (int d = 0; d < sc.ndof; ++d) rows[(r++) * K + k] = s.q[d];
  for (int d = 0; d < sc.ndof; ++d) rows[(r++) * K + k] = s.qd[d];
  for (int b = 0; b < sc.nbody; ++b)
    for (int i = 0; i < 3; ++i) rows[(r++) * K + k] = s.ncf[b][i];
  for (int c = 0; c < sc.n_fc; ++c)
    for (int i = 0; i < 4; ++i) rows[(r++) * K + k] = s.lam[c][i];
}

__device__ void load_tables(const SceneTables* src, SceneTables* dst) {
  const int* s = reinterpret_cast<const int*>(src);
  int* d = reinterpret_cast<int*>(dst);
  const int n = sizeof(SceneTables) / 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: the whole K-sample, H-step rollout in one launch.
//
// Replaces FusedRollout._kernel (ops/pallas/fused_rollout.py:250-342,
// launched by pallas_call at :367). One thread per sample walks the H steps
// and the substeps, with the λ rows carried across the whole trajectory;
// state and per-substep temporaries live in registers and local memory
// (tens of KB per thread, cached in L1/L2).
//
// What bounds it on the H100: latency of one thread's long serial chain of
// dependent FLOPs and local-memory accesses (contacts, articulated solve,
// couple terms, impulse sweeps per substep), not bytes — a command reads
// ~(NS + 4·n_fc)·K·4 bytes of state and writes K·H costs. At the pick config
// (K=1000) the mapping fills 8 blocks of 128 threads on 132 SMs, so most of
// the card idles; spreading one sample over a warp (blocks and candidates
// across lanes) is the later fix. The scene tables sit in shared memory (all
// threads read the same entries: broadcasts), and every global access is
// coalesced.
// ---------------------------------------------------------------------------

__global__ void fused_rollout_kernel(const SceneTables* __restrict__ tables,
                                     const float* __restrict__ rows,
                                     const __nv_bfloat16* __restrict__ V,
                                     const float* __restrict__ mass,
                                     const float* __restrict__ fric,
                                     float* __restrict__ costs, float* __restrict__ vis,
                                     int K, int H, int substeps, float dt_sub, int sweeps) {
  extern __shared__ int smem[];
  SceneTables& sc = *reinterpret_cast<SceneTables*>(smem);
  load_tables(tables, &sc);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  Sample s;
  Work w;
  float u[MAX_NU], tgt[MAX_DOFS];
  load_sample(sc, rows, K, k, s);
  for (int t = 0; t < H; ++t) {
    for (int j = 0; j < sc.nu; ++j) u[j] = __bfloat162float(V[(t * sc.nu + j) * K + k]);
    for (int d = 0; d < sc.ndof; ++d) {
      float acc = 0.f;
      for (int j = 0; j < sc.nu; ++j) {
        const float wj = sc.cmd_W[d * MAX_NU + j];
        if (wj != 0.f) acc += u[j] * wj;
      }
      tgt[d] = acc;
    }
    // gripper binarize, latching from the current finger q (CommandMap.apply)
    for (int i = 0; i < sc.nbin; ++i) {
      const int dof = sc.bin_dof[i];
      const float uc = u[sc.bin_src[i]], lo = sc.bin_lo[i], hi = sc.bin_hi[i];
      if (sc.bin_band[i] > 0.f) {
        const bool cur_open = s.q[dof] > sc.bin_qopen[i];
        tgt[dof] = uc > sc.bin_uhi[i] ? hi : (uc < sc.bin_ulo[i] ? lo : (cur_open ? hi : lo));
      } else {
        tgt[dof] = uc > sc.bin_th[i] ? hi : lo;
      }
    }
    for (int it = 0; it < substeps; ++it)
      substep(sc, s, w, tgt, mass + k, fric + k, K, dt_sub, sweeps);
    fk(sc, s, w.kin);
    costs[k * H + t] = task_cost(sc, s, w.kin);
    for (int i = 0; i < 3; ++i) {
      const float v = sc.vis_body >= 0 ? w.kin.pos[sc.vis_body][i] : 0.f;
      vis[(t * K + k) * 3 + i] = __bfloat162float(__float2bfloat16(v));
    }
  }
}

// ---------------------------------------------------------------------------
// K2: one env advanced one control dt (all substeps at world fidelity).
//
// Replaces FusedWorldStep._kernel (ops/pallas/fused_rollout.py:483-516,
// launched by pallas_call at :533). The same device code on one sample, run by
// thread 0 of a single block (the block's other threads only help load the
// tables), with `sweeps` (16) impulse sweeps per substep and the λ rows in
// and out. Bound by launch and serial latency of one thread.
// ---------------------------------------------------------------------------

__global__ void fused_world_step_kernel(const SceneTables* __restrict__ tables,
                                        const float* __restrict__ rows_in,
                                        const float* __restrict__ tgt_in,
                                        const float* __restrict__ mass,
                                        const float* __restrict__ fric,
                                        float* __restrict__ rows_out, int substeps, float dt_sub,
                                        int sweeps) {
  extern __shared__ int smem[];
  SceneTables& sc = *reinterpret_cast<SceneTables*>(smem);
  load_tables(tables, &sc);
  if (threadIdx.x != 0) return;
  Sample s;
  Work w;
  float tgt[MAX_DOFS];
  load_sample(sc, rows_in, 1, 0, s);
  for (int d = 0; d < sc.ndof; ++d) tgt[d] = tgt_in[d];
  for (int it = 0; it < substeps; ++it) substep(sc, s, w, tgt, mass, fric, 1, dt_sub, sweeps);
  store_sample(sc, s, rows_out, 1, 0);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

extern "C" {

int scene_tables_size() { return (int)sizeof(SceneTables); }

int max_bounds(int* out) {
  const int b[11] = {MAX_ACTORS, MAX_BODIES, MAX_DOFS, MAX_NU, MAX_GEOMS, MAX_BLK,
                     MAX_CAND, MAX_SC, MAX_PSI, MAX_BIN, MAX_S};
  for (int i = 0; i < 11; ++i) out[i] = b[i];
  return 0;
}

// the tables ride in dynamic shared memory (they outgrew the 16 KB a static
// array was held to); above 48 KB a kernel has to opt in
static int set_smem(const void* fn) {
  const int bytes = (int)sizeof(SceneTables);
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int fused_rollout_launch(const void* tables, const void* rows, const void* V, const void* mass,
                         const void* fric, void* costs, void* vis, int K, int H, int substeps,
                         float dt_sub, int sweeps, void* stream) {
  const int threads = 128;
  const int blocks = (K + threads - 1) / threads;
  int rc = set_smem((const void*)fused_rollout_kernel);
  if (rc != 0) return rc;
  fused_rollout_kernel<<<blocks, threads, sizeof(SceneTables), (cudaStream_t)stream>>>(
      (const SceneTables*)tables, (const float*)rows, (const __nv_bfloat16*)V,
      (const float*)mass, (const float*)fric, (float*)costs, (float*)vis, K, H, substeps, dt_sub,
      sweeps);
  return (int)cudaGetLastError();
}

int fused_world_step_launch(const void* tables, const void* rows, const void* tgt,
                            const void* mass, const void* fric, void* out, int substeps,
                            float dt_sub, int sweeps, void* stream) {
  int rc = set_smem((const void*)fused_world_step_kernel);
  if (rc != 0) return rc;
  fused_world_step_kernel<<<1, 32, sizeof(SceneTables), (cudaStream_t)stream>>>(
      (const SceneTables*)tables, (const float*)rows, (const float*)tgt, (const float*)mass,
      (const float*)fric, (float*)out, substeps, dt_sub, sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
