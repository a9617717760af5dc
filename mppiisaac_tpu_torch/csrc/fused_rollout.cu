// Fused MPPI rollout (K1) and fused world step (K2) for NVIDIA Hopper.
//
// Build (ops/native.py does this at first use, keyed by a hash of the
// sources in this directory):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_rollout.so fused_rollout.cu
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and returns cudaGetLastError(). With -DFUSED_EMU the C interface is
// left out and g++ compiles the device code against the CPU emulation in
// emu/ (tests/test_torch_device_emu.py). With -DABLATE (ops/native.py's
// ablation library, _build/ablate/) the kernels are templates on the
// profiling ablations' mask (AB_* in scene_tables.cuh), the launchers
// fused_rollout_launch_ablate / fused_world_step_launch_ablate take the mask
// first, and the default launchers are left out.
//
// Both kernels run the same device code, one physics substep, by ONE WARP
// PER SAMPLE:
//   fk()         forward kinematics from each actor's root rows, level by
//                level of the body trees, lanes over a level's bodies:
//                revolute, prismatic and fixed joints (replaces
//                fused_physics.fk_lanes)
//   contacts()   broadphase gate, narrowphase of the cp, bp, cb, bbc, cc, bbA
//                and bbB pair blocks, side-asymmetric penalty law, reported net
//                contact force, swept geometry, lanes over the candidates
//                (contacts.cuh)
//   dynamics()   velocity solve of every articulation, fixed or floating
//                base, over its velocity coordinates (spatial and composite
//                inertias, RNEA bias, CRBA, force-limited implicit drives,
//                effort drives with the finger motor curve, the finger
//                force gate, joint damping, Coulomb friction, joint-limit penalty,
//                implicit couple terms, Cholesky) and of every free single
//                body; the impulse pass with the couple and stiction blocks
//                (impulse.cuh); clamped, deferred integration of dofs and
//                roots (replaces dynamics_lanes)
// and the task cost hook task_cost() (replaces the objective kernel_cost
// functions: panda reach, panda pick, mobile reach, mobile push, point
// robot, multi robot, stick push, omni pick, albert and anymal).
//
// The TPU kernels unrolled each scene into straight-line code with the scene
// constants baked in. These kernels are TABLE-DRIVEN instead: the scene is one
// SceneTables struct (ops/fused_rollout.py packs it, field for field, from
// ops/fused_physics.KernelScene, with the lane orders and the per-warp
// layout), copied into dynamic shared memory by every block. One build serves
// every scene within the MAX_* bounds of scene_tables.cuh; the wrapper checks
// the bounds before it launches.
//
// State in device memory is structure-of-arrays: row r of sample k is
// rows[r * K + k]. Rows per sample: 13 per actor (pos, quat xyzw, linvel,
// angvel), q[D], qd[D], net force[3B], then, at world fidelity, 4 λ rows
// [λ_n, λ_t·3] per swept contact candidate. A fast-fidelity rollout (K1
// only) carries no λ rows: its impulse sweeps start from zero in every
// substep, with no stiction snap. Inside a kernel each sample's rows, and
// every per-sample temporary, live in its warp's region of dynamic shared
// memory, laid out to the scene's own counts (SceneTables.lay).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "scene_tables.cuh"
#include "contacts.cuh"
#include "impulse.cuh"

// ---------------------------------------------------------------------------
// forward kinematics (fk_lanes), level by level, lanes over a level's bodies
// ---------------------------------------------------------------------------

__device__ void fk_body(const SceneTables& sc, const Sample& s, const Kin& k, int g) {
  const int p = sc.body_parent[g];
  if (p < 0) {
    const float* r = s.root[sc.body_actor[g]];
    for (int i = 0; i < 3; ++i) {
      k.pos[g][i] = r[i]; k.linv[g][i] = r[7 + i]; k.angv[g][i] = r[10 + i];
    }
    for (int i = 0; i < 4; ++i) k.quat[g][i] = r[3 + i];
    k.axw[g][0] = 1.f; k.axw[g][1] = 0.f; k.axw[g][2] = 0.f;
    return;
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

__device__ void fk(const SceneTables& sc, const Sample& s, const Kin& k, int lane) {
  for (int lv = 0; lv < sc.n_lvl; ++lv) {
    for (int i = sc.lvl_start[lv] + lane; i < sc.lvl_start[lv + 1]; i += 32)
      fk_body(sc, s, k, sc.lvl_body[i]);
    __syncwarp();
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
// nv = 6) → c.fv[a] = (clamped root linvel, angvel); scratch: 72 words
__device__ void free_velocity(const SceneTables& sc, const Sample& s, const Kin& k, int a,
                              const float (*plk_n)[3], const float (*plk_f)[3], const float* mass,
                              int K, float dt, Ctx& c, float* scratch) {
  const int g = sc.actor_body0[a];
  float* I6 = scratch;
  float* Mm = scratch + 36;
  float vb[6], Ia[6], Iv[6], cf[6], f[6], rhs[6], u[6], cr[3];
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
  chol_factor(Mm, Mm, 0, 6, 6);
  chol_solve(Mm, 0, 6, 6, rhs, u);
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

// root of a floating base from its Plücker velocity u = (ω, v_O):
// v_r = v_O + ω×p_root, both clamped, then position and orientation
__device__ void integrate_base(const SceneTables& sc, float* r, const float* u, float dt) {
  float cr[3], v[3], w[3], nq[4];
  cross3(u, r, cr);
  const float wcap = sc.max_root_angvel, vcap = sc.max_root_linvel;
  for (int i = 0; i < 3; ++i) {
    v[i] = fminf(fmaxf(u[3 + i] + cr[i], -vcap), vcap);
    w[i] = fminf(fmaxf(u[i], -wcap), wcap);
  }
  qintegrate(&r[3], w, dt, nq);
  for (int i = 0; i < 3; ++i) {
    r[i] = r[i] + v[i] * dt;
    r[7 + i] = v[i];
    r[10 + i] = w[i];
  }
  for (int i = 0; i < 4; ++i) r[3 + i] = nq[i];
}

// The velocity solves' per-actor arrays (DYN_* of the warp's region).
struct Dyn {
  float (*Ic)[36], (*vb)[6], (*asp)[6], (*fsub)[6];
  float *rhs, *C, *dimp, *uu, *coef, *col;
};

// Velocity solves of every dynamic actor, the impulse pass, and the
// integration (dynamics_lanes). An articulated actor is solved over its
// velocity coordinates: a floating base's 6 (unit Plücker subspaces, u from
// the root body's (ω, v_O), no drive), then its dofs. Lanes run over the
// free actors, over an articulation's bodies (inertias, bias forces), over
// the rows of each composite-inertia sum, over its coordinate pairs (CRBA),
// its coordinates (drives), the rows of each Cholesky column and the
// (link, column) pairs of Ψ's live links; each entry keeps the serial order
// of its sums.
// Without contacts (AB_SKIP_CONTACTS) there are no couple terms, no Ψ and no
// impulse pass, and the λ rows stay as they are.
AB_TEMPLATE __device__ void dynamics(const SceneTables& sc, Sample& s, const Kin& k,
                                     const float (*plk_n)[3], const float (*plk_f)[3],
                                     const float* tgt, const float* mass, const float* fric, int K,
                                     float dt, const Swept& sw, int sweeps, bool world, Ctx& c,
                                     const Warp& W) {
  const int lane = W.lane, ld = sc.nv;
  SEC_BEGIN;
  float* new_q = W.f(sc, L_NEWQ);
  float* new_qd = W.f(sc, L_NEWQD);
  Dyn d{rows_of<36>(W.f(sc, L_IC)), rows_of<6>(W.f(sc, L_VB)), rows_of<6>(W.f(sc, L_ASP)),
        rows_of<6>(W.f(sc, L_FSUB)), W.f(sc, L_RHS), W.f(sc, L_C), W.f(sc, L_DIMP),
        W.f(sc, L_UU), W.f(sc, L_COEF), W.f(sc, L_COL)};
  for (int i = lane; i < sc.ndof; i += 32) { new_q[i] = s.q[i]; new_qd[i] = s.qd[i]; }
  bool any_free = false, any_deferred = false;
  for (int a = 0; a < sc.nactor; ++a) any_free |= sc.actor_dynamic[a] == ACTOR_FREE;
  if (lane < sc.nactor) {
    c.deferred[lane] = 0;
    if (sc.actor_dynamic[lane] == ACTOR_FREE)
      free_velocity(sc, s, k, lane, plk_n, plk_f, mass, K, dt, c, W.f(sc, L_FVS) + 72 * lane);
  }
  __syncwarp();
  SEC_MARK(c.kid, SEC_SOLVES);

  for (int a = 0; a < sc.nactor; ++a) {
    if (sc.actor_dynamic[a] != ACTOR_ARTICULATED) continue;
    const int bo = sc.actor_body0[a], nb = sc.actor_nbody[a];
    const int dof0 = sc.actor_dof0[a];
    const int v0 = sc.actor_v0[a], nv = sc.actor_nv[a], base = sc.actor_base[a];
    for (int i = lane; i < nb; i += 32) {
      const int g = bo + i;
      spatial_inertia(sc, g, k.pos[g], k.quat[g], mass[g * K], d.Ic[i]);
      float cr[3];
      cross3(k.angv[g], k.pos[g], cr);
      for (int r = 0; r < 3; ++r) { d.vb[i][r] = k.angv[g][r]; d.vb[i][3 + r] = k.linv[g][r] - cr[r]; }
    }
    __syncwarp();
    for (int j = lane; j < nv; j += 32) {
      float* Sj = c.S[v0 + j];
      if (j < base) {
        for (int r = 0; r < 6; ++r) Sj[r] = r == j ? 1.f : 0.f;
        d.uu[j] = d.vb[0][j];
        continue;
      }
      const int g = sc.v_body[v0 + j];
      const float* aw = k.axw[g];
      if (sc.body_jtype[g] == JOINT_REVOLUTE) {
        float cr[3];
        cross3(k.pos[g], aw, cr);
        for (int r = 0; r < 3; ++r) { Sj[r] = aw[r]; Sj[3 + r] = cr[r]; }
      } else {
        for (int r = 0; r < 3; ++r) { Sj[r] = 0.f; Sj[3 + r] = aw[r]; }
      }
      d.uu[j] = s.qd[dof0 + j - base];
    }
    __syncwarp();
    // bias forces: RNEA with qdd = 0, gravity as a base acceleration; level
    // by level, lanes over the actor's bodies of a level
    if (lane == 0) {
      const float gz = sc.actor_gravity[a] ? sc.gravity_z : 0.f;
      for (int r = 0; r < 6; ++r) d.asp[0][r] = 0.f;
      d.asp[0][5] = gz;
    }
    __syncwarp();
    for (int lv = 1; lv < sc.n_lvl; ++lv) {
      for (int li = sc.lvl_start[lv] + lane; li < sc.lvl_start[lv + 1]; li += 32) {
        const int g = sc.lvl_body[li];
        if (sc.body_actor[g] != a) continue;
        const int i = g - bo, p = sc.body_parent[g] - bo;
        for (int r = 0; r < 6; ++r) d.asp[i][r] = d.asp[p][r];
        const int dg = sc.body_dof[g];
        if (dg >= 0) {
          float sq[6], c6[6];
          for (int r = 0; r < 6; ++r) sq[r] = c.S[v0 + base + dg - dof0][r] * s.qd[dg];
          crm6(d.vb[i], sq, c6);
          for (int r = 0; r < 6; ++r) d.asp[i][r] += c6[r];
        }
      }
      __syncwarp();
    }
    for (int i = lane; i < nb; i += 32) {
      const int g = bo + i;
      float Ia[6], Iv[6], cf[6];
      mat6vec(d.Ic[i], d.asp[i], Ia);
      mat6vec(d.Ic[i], d.vb[i], Iv);
      crf6(d.vb[i], Iv, cf);
      for (int r = 0; r < 3; ++r) {
        d.fsub[i][r] = Ia[r] + cf[r] - plk_n[g][r];
        d.fsub[i][3 + r] = Ia[3 + r] + cf[3 + r] - plk_f[g][r];
      }
    }
    __syncwarp();
    // composite inertias and subtree forces (children follow parents):
    // bodies in reverse order, lanes over the 42 entries
    for (int i = nb - 1; i > 0; --i) {
      const int p = sc.body_parent[bo + i] - bo;
      for (int r = lane; r < 42; r += 32) {
        if (r < 36) d.Ic[p][r] += d.Ic[i][r];
        else d.fsub[p][r - 36] += d.fsub[i][r - 36];
      }
      __syncwarp();
    }
    for (int j = lane; j < nv; j += 32) {
      const int bj = sc.v_body[v0 + j] - bo;
      float v = 0.f;
      for (int r = 0; r < 6; ++r) v += c.S[v0 + j][r] * d.fsub[bj][r];
      d.C[j] = v;
    }
    SEC_MARK(c.kid, SEC_TREE);
    // CRBA on ancestor pairs, into the actor's block of c.L: M_xy = S_x·Ic_y S_y
    // with y the descendant (the serial loop's last write to the pair)
    float* M = c.L;
    for (int e = lane; e < nv * nv; e += 32) {
      const int x = e / nv, y = e % nv;
      if (y < x) continue;
      int i = -1, j = -1;
      if (sc.v_anc[(v0 + x) * MAX_V + v0 + y]) { i = x; j = y; }
      else if (sc.v_anc[(v0 + y) * MAX_V + v0 + x]) { i = y; j = x; }
      float v = 0.f;
      if (i >= 0) {
        float F[6];
        mat6vec(d.Ic[sc.v_body[v0 + j] - bo], c.S[v0 + j], F);
        for (int r = 0; r < 6; ++r) v += c.S[v0 + i][r] * F[r];
      }
      M[(v0 + x) * ld + v0 + y] = v;
      M[(v0 + y) * ld + v0 + x] = v;
    }
    __syncwarp();
    // drives: rhs = M u + dt (tau − C), M_solve = M + diag(dt d_imp + 1e-8);
    // nothing drives the base coordinates
    for (int i = lane; i < nv; i += 32) {
      float tk = 0.f, dk = 0.f;
      if (i >= base) {
        const int dg = dof0 + i - base;
        const float qk = s.q[dg], qdk = s.qd[dg], tg = tgt[dg];
        const float effort = sc.dof_effort[dg];
        if (sc.dof_mode[dg] == DRIVE_EFFORT) {
          tk = fminf(fmaxf(tg, -effort), effort);
          dk = sc.dof_kd[dg];
          // the effort finger's motor curve |τ|/v_max and its
          // load-proportional spindle stiction, both implicit
          if (sc.dof_motor[dg])
            dk = dk + fabsf(tk) * (1.f / fmaxf(sc.dof_maxvel[dg], 1e-6f)
                                   + sc.mu_spindle / (fabsf(qdk) + 0.02f));
        } else if (sc.dof_mode[dg] == DRIVE_VELOCITY) {
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
        dk = dk + sc.dof_armature[dg];
      }
      float acc = 0.f;
      for (int j = 0; j < nv; ++j) acc += M[(v0 + i) * ld + v0 + j] * d.uu[j];
      d.rhs[i] = acc + dt * (tk - d.C[i]);
      d.dimp[i] = dk;
    }
    __syncwarp();
    for (int i = lane; i < nv; i += 32) M[(v0 + i) * ld + v0 + i] += d.dimp[i] * dt + 1e-8f;
    __syncwarp();
    SEC_MARK(c.kid, SEC_CRBA);
    // couple and stiction contacts keep the factor, the subspaces and Ψ live
    // for the impulse sweeps (the couple contacts also enter the solve
    // implicitly), and the integration waits until after them
    bool couple = false, deferred = false;
    for (int bi = 0; bi < sc.nblk; ++bi)
      couple |= is_couple(sc, bi) && sc.body_actor[art_body_of(sc, bi)] == a;
    for (int b = bo; b < bo + nb; ++b) deferred |= sc.body_psi[b] >= 0;
    if (AB_UNLESS(AB_SKIP_CONTACTS, couple))
      couple_terms(sc, k, sw, a, mass, K, dt, c, d.rhs, d.col, d.coef, lane);
    SEC_MARK(c.kid, SEC_COUPLE);
    chol_factor_warp(c.L, v0, nv, ld, lane);
    const float ui = chol_solve_warp(c.L, v0, nv, ld, lane < nv ? d.rhs[lane] : 0.f, lane);
    if (lane < nv) c.u[v0 + lane] = ui;
    __syncwarp();
    SEC_MARK(c.kid, SEC_CHOL);
    if (AB_UNLESS(AB_SKIP_CONTACTS, deferred)) {
      psi_blocks(sc, sw, a, c, d.col, lane);
      if (lane == 0) c.deferred[a] = 1;
      any_deferred = true;
    }
    SEC_MARK(c.kid, SEC_PSI);
  }
  __syncwarp();
  SEC_MARK(c.kid, SEC_SOLVES);

  bool any_swept = false;
  for (int bi = 0; bi < sc.nblk; ++bi) any_swept |= (sc.blk_flags[bi] & F_SWEPT) != 0;
  if (AB_UNLESS(AB_SKIP_CONTACTS, any_swept && sweeps > 0 && (any_free || any_deferred))) {
    Imp m{W.f(sc, L_INVM), rows_of<9>(W.f(sc, L_INVIW)), W.f(sc, L_CNTB), W.f(sc, L_CNTA),
          W.f(sc, L_ACT), W.f(sc, L_MUB), rows_of<6>(W.f(sc, L_KC)), W.f(sc, L_KNC),
          W.f(sc, L_FLOOR), W.f(sc, L_NEFF), rows_of<3>(W.f(sc, L_DP)), rows_of<3>(W.f(sc, L_DT)),
          rows_of<6>(W.f(sc, L_Y)), rows_of<6>(W.f(sc, L_V6)),
          rows_of<36>(W.f(sc, L_SA)), rows_of<6>(W.f(sc, L_SB)), W.i(sc, L_USED),
          rows_of<12>(W.f(sc, L_BSUM)), rows_of<27>(W.f(sc, L_SSUM))};
    impulse_pass AB_ARG(sc, s, k, mass, fric, K, dt, sw, sweeps, world, c, m, lane);
  }
  SEC_RESET;
  if (lane < sc.nactor) {
    const int a = lane;
    if (sc.actor_dynamic[a] == ACTOR_ARTICULATED) {
      const int v0 = sc.actor_v0[a], base = sc.actor_base[a];
      if (base) integrate_base(sc, s.root[a], &c.u[v0], dt);
      integrate_dofs(sc, s, a, &c.u[v0 + base], dt, new_q, new_qd);
    }
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
  __syncwarp();
  for (int i = lane; i < sc.ndof; i += 32) { s.q[i] = new_q[i]; s.qd[i] = new_qd[i]; }
  __syncwarp();
  SEC_MARK(c.kid, SEC_SOLVES);
}

// One substep: FK → contacts → velocity solves → impulse pass →
// integration, at world fidelity (world) or fast fidelity. The ablations
// AB_SKIP_CONTACTS and AB_SKIP_DYNAMICS leave out the contacts (zero forces,
// no swept block) and the velocity solves (every root drifts by its
// velocity; dofs, velocities and λ rows stay) as fused_physics.substep_lanes
// does.
AB_TEMPLATE __device__ void substep(const SceneTables& sc, Sample& s, const Kin& k, Swept& sw,
                                    Ctx& c, const Warp& W, const float* tgt, const float* mass,
                                    const float* fric, int K, float dt, int sweeps, bool world) {
  // the finger force gate: a velocity-driven finger stops closing once its
  // link's net contact force (the last substep's report, which contacts()
  // overwrites) exceeds grip_force_gate
  const int lane = W.lane;
  float* tg = W.f(sc, L_TG);
  for (int d = lane; d < sc.ndof; d += 32) {
    float t = tgt[d];
    const int b = sc.dof_gate_body[d];
    if (b >= 0 && t < 0.f && sqrtf(dot3(s.ncf[b], s.ncf[b])) > sc.grip_force_gate) t = 0.f;
    tg[d] = t;
  }
  SEC_BEGIN;
  fk(sc, s, k, lane);
  SEC_MARK(c.kid, SEC_FK);
  float (*plk_n)[3] = rows_of<3>(W.f(sc, L_PLKN));
  float (*plk_f)[3] = rows_of<3>(W.f(sc, L_PLKF));
#ifdef ABLATE
  if (AB_ON(AB_SKIP_CONTACTS)) {
    for (int b = lane; b < sc.nbody; b += 32)
      for (int i = 0; i < 3; ++i) { plk_n[b][i] = 0.f; plk_f[b][i] = 0.f; s.ncf[b][i] = 0.f; }
    __syncwarp();
  } else
#endif
  contacts AB_ARG(sc, k, fric, K, dt, plk_n, plk_f, s.ncf, sw, rows_of<12>(W.f(sc, L_BSUM)), lane);
  SEC_MARK(c.kid, SEC_CONTACTS);
#ifdef ABLATE
  if (AB_ON(AB_SKIP_DYNAMICS)) {
    if (lane < sc.nactor)
      for (int i = 0; i < 3; ++i) s.root[lane][i] = s.root[lane][i] + s.root[lane][7 + i] * dt;
    __syncwarp();
    return;
  }
#endif
  dynamics AB_ARG(sc, s, k, plk_n, plk_f, tg, mass, fric, K, dt, sw, sweeps, world, c, W);
}

// ---------------------------------------------------------------------------
// task cost hook (objective kernel_cost), on the post-step kinematics
// (lane 0 of the sample's warp)
// ---------------------------------------------------------------------------

// Σ over the force groups of |F_i|, i < force_dims, F the group's summed
// net contact force
__device__ float force_term(const SceneTables& sc, const Sample& s) {
  const int b0[2] = {sc.force_body0, sc.force2_body0}, nb[2] = {sc.force_nbody, sc.force2_nbody};
  float out = 0.f;
  for (int g = 0; g < 2; ++g) {
    if (nb[g] <= 0) continue;
    float f[3] = {0.f, 0.f, 0.f};
    for (int b = b0[g]; b < b0[g] + nb[g]; ++b)
      for (int i = 0; i < 3; ++i) f[i] += s.ncf[b][i];
    for (int i = 0; i < sc.force_dims; ++i) out += fabsf(f[i]);
  }
  return out;
}

__device__ float task_cost(const SceneTables& sc, const Sample& s, const Kin& k) {
  // the branches of ops/fused_physics.CostSpec (the wrapper admits no other
  // task id); F = force_term
  if (sc.task == TASK_MOBILE_REACH) {
    // w_dist·‖xy − goal‖ + w_force·F; xy of the root, or of two dofs
    const float* xy = sc.xy_dof >= 0 ? &s.q[sc.xy_dof] : s.root[sc.xy_actor];
    const float dx = xy[0] - sc.goal_x, dy = xy[1] - sc.goal_y;
    return sc.w_dist * sqrtf(dx * dx + dy * dy + 1e-12f) + sc.w_force * force_term(sc, s);
  }
  if (sc.task == TASK_MOBILE_PUSH) {
    // w_dist·‖ee − block‖ + w_block·‖goal − block‖ + w_ori·|yaw − goal_yaw|
    //   + w_align·(cos∠ + 1) + w_force·F + w_vel·‖v_block‖, in the xy plane
    const float* r = k.pos[sc.ee_body];
    const float* blk = s.root[sc.block_actor];
    const float rbx = r[0] - blk[0], rby = r[1] - blk[1];
    const float bgx = sc.goal_x - blk[0], bgy = sc.goal_y - blk[1];
    const float d_rb = sqrtf(rbx * rbx + rby * rby + 1e-12f);
    const float d_bg = sqrtf(bgx * bgx + bgy * bgy + 1e-12f);
    const float x = blk[3], y = blk[4], z = blk[5], w = blk[6];
    const float yaw = atan2f(2.f * (w * z + x * y), 1.f - 2.f * (y * y + z * z));
    const float align = (rbx * bgx + rby * bgy) / fmaxf(d_rb * d_bg, 1e-6f) + 1.f;
    const float vel = sqrtf(blk[7] * blk[7] + blk[8] * blk[8] + 1e-12f);
    return sc.w_dist * d_rb + sc.w_block * d_bg + sc.w_ori * fabsf(yaw - sc.goal_yaw)
           + sc.w_align * align + sc.w_force * force_term(sc, s) + sc.w_vel * vel;
  }
  if (sc.task == TASK_POINT_ROBOT) {
    // w_dist·‖xy − goal‖ + w_pair·Σ_obstacles 1 / max(‖xy − p_i‖, 1e-3)
    //   + w_force·F; xy = q[xy_dof : xy_dof + 2]
    const float x = s.q[sc.xy_dof], y = s.q[sc.xy_dof + 1];
    const float dx = x - sc.goal_x, dy = y - sc.goal_y;
    float cost = sc.w_dist * sqrtf(dx * dx + dy * dy + 1e-12f);
    for (int i = 0; i < sc.n_xy; ++i) {
      const float* o = s.root[sc.xy_actors[i]];
      const float ox = x - o[0], oy = y - o[1];
      cost += sc.w_pair / fmaxf(sqrtf(ox * ox + oy * oy + 1e-12f), 1e-3f);
    }
    return cost + sc.w_force * force_term(sc, s);
  }
  if (sc.task == TASK_MULTI_ROBOT) {
    // Σ_i w_dist·‖xy_i − goal_i‖ + Σ_{i<j} w_pair·max(min_sep − ‖xy_i − xy_j‖, 0);
    // xy_i from two dofs, or the root of an actor
    float xy[MAX_XY][2];
    float cost = 0.f;
    for (int i = 0; i < sc.n_xy; ++i) {
      const float* p = sc.xy_dofs[i] >= 0 ? &s.q[sc.xy_dofs[i]] : s.root[sc.xy_actors[i]];
      xy[i][0] = p[0];
      xy[i][1] = p[1];
      const float dx = p[0] - sc.xy_gx[i], dy = p[1] - sc.xy_gy[i];
      cost += sc.w_dist * sqrtf(dx * dx + dy * dy + 1e-12f);
    }
    for (int i = 0; i < sc.n_xy; ++i)
      for (int j = i + 1; j < sc.n_xy; ++j) {
        const float dx = xy[i][0] - xy[j][0], dy = xy[i][1] - xy[j][1];
        cost += sc.w_pair * fmaxf(sc.min_sep - sqrtf(dx * dx + dy * dy + 1e-12f), 0.f);
      }
    return cost;
  }
  // TASK_PANDA_REACH: w_dist·‖ee − goal‖ + w_ori·‖(pitch, yaw)‖;
  // TASK_PANDA_PICK: w_dist·‖ee − block‖ + w_block·‖block − goal‖
  //   + w_force·F + w_ori·‖(pitch, yaw)‖;
  // TASK_STICK_PUSH: the pick terms + w_height·|ee_z − block_z|
  //   + w_align·(cos∠_xy(ee − block, goal − block) + 1);
  // TASK_OMNI_PICK: the pick terms + w_base_vel·Σ_{i<3} qd_i²
  //   + w_arm_vel·Σ_{3≤i<10} qd_i² + w_pose·Σ_{i<7} (q_{3+i} − pose_i)²
  //   + w_grip·Σ_{i<2} (q_{10+i} − pose_{7+i})² + w_height·max(floor − ee_z, 0),
  //   dof i of the actor whose first dof is dof0
  // TASK_ALBERT: w_dist·‖ee − goal‖ + w_ori·‖(roll, pitch)‖;
  // TASK_ANYMAL: w_dist·‖ee − goal‖ + Σ_i ht_w_i·|z(ht_body_i) − ht_z_i|
  const float* q = k.quat[sc.ee_body];
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float sp = fminf(fmaxf(2.f * (w * y - z * x), -1.f), 1.f);
  const float pitch = atan2f(sp, sqrtf(fmaxf(1.f - sp * sp, 1e-12f)));
  const float yaw = atan2f(2.f * (w * z + x * y), 1.f - 2.f * (y * y + z * z));
  const float ori = sqrtf(yaw * yaw + pitch * pitch + 1e-12f);
  const float* r = k.pos[sc.ee_body];
  const float* goal = s.root[sc.goal_actor];
  if (sc.task == TASK_PANDA_REACH || sc.task == TASK_ALBERT || sc.task == TASK_ANYMAL) {
    const float dx = r[0] - goal[0], dy = r[1] - goal[1], dz = r[2] - goal[2];
    const float cost = sc.w_dist * sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
    if (sc.task == TASK_PANDA_REACH) return cost + sc.w_ori * ori;
    if (sc.task == TASK_ALBERT) {
      const float roll = atan2f(2.f * (w * x + y * z), 1.f - 2.f * (x * x + y * y));
      return cost + sc.w_ori * sqrtf(roll * roll + pitch * pitch + 1e-12f);
    }
    float acc = cost;
    for (int i = 0; i < sc.n_ht; ++i) acc += sc.ht_w[i] * fabsf(k.pos[sc.ht_body[i]][2] - sc.ht_z[i]);
    return acc;
  }
  const float* block = s.root[sc.block_actor];
  float d1[3], d2[3];
  for (int i = 0; i < 3; ++i) { d1[i] = r[i] - block[i]; d2[i] = block[i] - goal[i]; }
  const float d_rb = sqrtf(dot3(d1, d1) + 1e-12f);
  const float d_bg = sqrtf(dot3(d2, d2) + 1e-12f);
  float cost = sc.w_dist * d_rb + sc.w_block * d_bg + sc.w_force * force_term(sc, s) + sc.w_ori * ori;
  if (sc.task == TASK_STICK_PUSH) {
    const float rbx = r[0] - block[0], rby = r[1] - block[1];
    const float bgx = goal[0] - block[0], bgy = goal[1] - block[1];
    const float d2xy = sqrtf(rbx * rbx + rby * rby + 1e-12f) * sqrtf(bgx * bgx + bgy * bgy + 1e-12f);
    const float align = (rbx * bgx + rby * bgy) / fmaxf(d2xy, 1e-6f) + 1.f;
    return cost + sc.w_height * fabsf(r[2] - block[2]) + sc.w_align * align;
  }
  if (sc.task == TASK_OMNI_PICK) {
    const float* qa = &s.q[sc.dof0];
    const float* qda = &s.qd[sc.dof0];
    float base_vel = 0.f, arm_vel = 0.f, arm_pose = 0.f, grip = 0.f;
    for (int i = 0; i < 3; ++i) base_vel += qda[i] * qda[i];
    for (int i = 3; i < 10; ++i) arm_vel += qda[i] * qda[i];
    for (int i = 0; i < 7; ++i) arm_pose += (qa[3 + i] - sc.pose_c[i]) * (qa[3 + i] - sc.pose_c[i]);
    for (int i = 0; i < 2; ++i) grip += (qa[10 + i] - sc.pose_c[7 + i]) * (qa[10 + i] - sc.pose_c[7 + i]);
    return cost + sc.w_base_vel * base_vel + sc.w_arm_vel * arm_vel + sc.w_pose * arm_pose
           + sc.w_grip * grip + sc.w_height * fmaxf(sc.height_floor - r[2], 0.f);
  }
  return cost;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

__device__ void load_tables(const SceneTables* src, SceneTables* dst) {
  const int* s = reinterpret_cast<const int*>(src);
  int* d = reinterpret_cast<int*>(dst);
  const int n = sizeof(SceneTables) / 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  __syncthreads();
}

// state rows of one sample: 13 per actor, q, qd, 3 per body
__device__ __forceinline__ int state_rows(const SceneTables& sc) {
  return 13 * sc.nactor + 2 * sc.ndof + 3 * sc.nbody;
}

// ---------------------------------------------------------------------------
// K1: the whole K-sample, H-step rollout in one launch.
//
// Replaces FusedRollout._kernel (ops/pallas/fused_rollout.py:250-342,
// launched by pallas_call at :367). One warp per sample, W warps per block
// (W ≤ 8, as many as fit beside the tables in 227 KB of shared memory), so
// K=1000 fills ~125 of the 132 SMs; the warp walks the H steps and the
// substeps, with the λ rows carried across the whole trajectory at world
// fidelity (world != 0). Each sample's state and temporaries sit in its
// warp's region of shared memory, sized to the scene (SceneTables.lay), and
// every loop over bodies, blocks, candidates, coordinates or matrix entries
// runs across the warp's lanes; sums stay in a fixed order (segmented scans,
// butterflies, serial sums per entry), so a run repeats itself bit for bit.
//
// What bounds it on the H100: the latency of one sample's chain of small
// dependent float32 operations on 3-vectors, 6×6 and ≤24×24 matrices
// (contacts, articulated solve, couple terms, impulse sweeps per substep),
// not bytes: a command reads ~(NS + 4·n_fc)·K·4 bytes of state and writes
// K·H costs. Tensor cores (wgmma), TMA and clusters have nothing to work on
// here; the levers are the chain length per sample (lanes) and the SMs in
// use (a warp per sample).
// ---------------------------------------------------------------------------

AB_TEMPLATE __global__ void __launch_bounds__(256, 1)
fused_rollout_kernel(const SceneTables* __restrict__ tables, const float* __restrict__ rows,
                     const __nv_bfloat16* __restrict__ V, const float* __restrict__ mass,
                     const float* __restrict__ fric, float* __restrict__ costs,
                     float* __restrict__ vis, int K, int H, int substeps, float dt_sub, int sweeps,
                     int world) {
  extern __shared__ int smem[];
  SceneTables& sc = *reinterpret_cast<SceneTables*>(smem);
  load_tables(tables, &sc);
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int k = blockIdx.x * (blockDim.x >> 5) + wi;
  if (k >= K) return;  // the whole warp
  const Warp W{reinterpret_cast<float*>(smem) + sizeof(SceneTables) / 4 + wi * sc.warp_words, lane};
  Sample s;
  Kin kin;
  Swept sw;
  Ctx c;
  bind(sc, W, s, kin, sw, c);
  c.kid = 0;
  const int n_rows = state_rows(sc) + (world ? 4 * sc.n_fc : 0);
  for (int r = lane; r < n_rows; r += 32) W.w[r] = rows[r * K + k];
  float* u = W.f(sc, L_UCMD);
  float* tgt = W.f(sc, L_TGT);
  __syncwarp();
  for (int t = 0; t < H; ++t) {
    SEC_BEGIN;
    for (int j = lane; j < sc.nu; j += 32) u[j] = __bfloat162float(V[(t * sc.nu + j) * K + k]);
    __syncwarp();
    for (int d = lane; d < sc.ndof; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < sc.nu; ++j) {
        const float wj = sc.cmd_W[d * MAX_NU + j];
        if (wj != 0.f) acc += u[j] * wj;
      }
      tgt[d] = acc;
    }
    __syncwarp();
    // gripper binarize, latching from the current finger q (CommandMap.apply)
    for (int i = lane; i < sc.nbin; i += 32) {
      const int dof = sc.bin_dof[i];
      const float uc = u[sc.bin_src[i]], lo = sc.bin_lo[i], hi = sc.bin_hi[i];
      if (sc.bin_band[i] > 0.f) {
        const bool cur_open = s.q[dof] > sc.bin_qopen[i];
        tgt[dof] = uc > sc.bin_uhi[i] ? hi : (uc < sc.bin_ulo[i] ? lo : (cur_open ? hi : lo));
      } else {
        tgt[dof] = uc > sc.bin_th[i] ? hi : lo;
      }
    }
    __syncwarp();
    SEC_MARK(0, SEC_COST);
    for (int it = 0; it < substeps; ++it)
      substep AB_ARG(sc, s, kin, sw, c, W, tgt, mass + k, fric + k, K, dt_sub, sweeps, world != 0);
#ifdef ABLATE
    if (AB_ON(AB_ZERO_COST)) {
      // no post-step FK and no cost, but values that depend on the physics
      // (a constant would let the compiler drop the substeps): the cost is
      // q[0], and vis the sum of the actors' root positions, which every
      // substep's integration reaches
      if (lane == 0) {
        costs[k * H + t] = sc.ndof > 0 ? s.q[0] : s.root[0][0];
        for (int i = 0; i < 3; ++i) {
          float v = 0.f;
          for (int a = 0; a < sc.nactor; ++a) v += s.root[a][i];
          vis[(t * K + k) * 3 + i] = v;
        }
      }
      __syncwarp();
      continue;
    }
#endif
    SEC_RESET;
    fk(sc, s, kin, lane);
    if (lane == 0) {
      costs[k * H + t] = task_cost(sc, s, kin);
      for (int i = 0; i < 3; ++i) {
        const float v = sc.vis_body >= 0 ? kin.pos[sc.vis_body][i] : 0.f;
        vis[(t * K + k) * 3 + i] = __bfloat162float(__float2bfloat16(v));
      }
    }
    __syncwarp();
    SEC_MARK(0, SEC_COST);
  }
  // the warp's Ψ columns: two adds a warp and launch
  if (lane == 0) {
    atomicAdd(&g_psi_columns[0], (unsigned long long)c.psi_solved);
    atomicAdd(&g_psi_columns[1], (unsigned long long)c.psi_held);
  }
}

// ---------------------------------------------------------------------------
// K2: N envs, each advanced one control dt (all substeps at world fidelity).
//
// Replaces FusedWorldStep._kernel (ops/pallas/fused_rollout.py:483-516,
// launched by pallas_call at :533), which steps one env; the JAX package
// steps a batch only through XLA's vmap of Engine.step. Here K1's device
// code runs one warp per env, W warps per block (as K1: W ≤ 8, chosen by
// the wrapper so that N envs spread over the SMs), with `sweeps` (16)
// impulse sweeps per substep and the λ rows in and out. Rows and targets are
// laid out env-fastest (rows[r·N + e], tgt[d·N + e]) and mass and fric with
// stride N, exactly as K1 reads its samples with stride K; the world flag
// (1) comes as an argument, as in K1, so that the compiler builds the same
// code for both. An env's warp does the same arithmetic at any N, so each
// env of a batch equals the one-env launch on its inputs bit for bit. Bound,
// like K1, by the latency of one env's chain; the warp's lanes shorten it.
//
// Epilogue: where body_out is not null, the body caches of the stepped state
// (physics/stacked.refresh_stacked's), from one more FK pass: 13·B rows per
// env, env-fastest like rows_out, in the scene's body order: positions
// [b·3 + i], then quaternions normalized [3B + b·4 + i], linear velocities of
// the body origins [7B + b·3 + i], angular velocities [10B + b·3 + i]. The
// refresh takes the velocities from the generalized coordinates alone, so a
// root without any (a static actor, a fixed base) moves with none here too.
// ---------------------------------------------------------------------------

__device__ void write_bodies(const SceneTables& sc, Sample& s, const Kin& k, float* body_out,
                             int N, int e, int lane) {
  __syncwarp();  // every lane has read the root rows into rows_out
  if (lane < sc.nactor && sc.actor_base[lane] == 0 && sc.actor_dynamic[lane] != ACTOR_FREE)
    for (int i = 7; i < 13; ++i) s.root[lane][i] = 0.f;
  __syncwarp();
  fk(sc, s, k, lane);
  const int B = sc.nbody;
  for (int g = lane; g < B; g += 32) {
    const float* q = k.quat[g];
    const float n = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-12f);
    for (int i = 0; i < 3; ++i) {
      body_out[(3 * g + i) * N + e] = k.pos[g][i];
      body_out[(7 * B + 3 * g + i) * N + e] = k.linv[g][i];
      body_out[(10 * B + 3 * g + i) * N + e] = k.angv[g][i];
    }
    for (int i = 0; i < 4; ++i) body_out[(3 * B + 4 * g + i) * N + e] = q[i] / n;
  }
}

AB_TEMPLATE __global__ void __launch_bounds__(256, 1)
fused_world_step_kernel(const SceneTables* __restrict__ tables, const float* __restrict__ rows_in,
                        const float* __restrict__ tgt_in, const float* __restrict__ mass,
                        const float* __restrict__ fric, float* __restrict__ rows_out,
                        float* __restrict__ body_out, int N, int substeps, float dt_sub,
                        int sweeps, int world) {
  extern __shared__ int smem[];
  SceneTables& sc = *reinterpret_cast<SceneTables*>(smem);
  load_tables(tables, &sc);
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int e = blockIdx.x * (blockDim.x >> 5) + wi;
  if (e >= N) return;  // the whole warp
  const Warp W{reinterpret_cast<float*>(smem) + sizeof(SceneTables) / 4 + wi * sc.warp_words, lane};
  Sample s;
  Kin kin;
  Swept sw;
  Ctx c;
  bind(sc, W, s, kin, sw, c);
  c.kid = 1;
  const int n_rows = state_rows(sc) + 4 * sc.n_fc;
  for (int r = lane; r < n_rows; r += 32) W.w[r] = rows_in[r * N + e];
  float* tgt = W.f(sc, L_TGT);
  for (int d = lane; d < sc.ndof; d += 32) tgt[d] = tgt_in[d * N + e];
  __syncwarp();
  for (int it = 0; it < substeps; ++it)
    substep AB_ARG(sc, s, kin, sw, c, W, tgt, mass + e, fric + e, N, dt_sub, sweeps, world != 0);
  for (int r = lane; r < n_rows; r += 32) rows_out[r * N + e] = W.w[r];
  if (body_out != nullptr) write_bodies(sc, s, kin, body_out, N, e, lane);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

#ifndef FUSED_EMU
extern "C" {

int scene_tables_size() { return (int)sizeof(SceneTables); }

int max_bounds(int* out) {
  const int b[14] = {MAX_ACTORS, MAX_BODIES, MAX_DOFS, MAX_NU, MAX_GEOMS, MAX_BLK,
                     MAX_CAND, MAX_SC, MAX_PSI, MAX_BIN, MAX_S, MAX_V, MAX_CHUNKS, N_LAY};
  for (int i = 0; i < 14; ++i) out[i] = b[i];
  return 0;
}

// the tables and the warps' regions ride in dynamic shared memory; above
// 48 KB a kernel has to opt in
static int set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// K1's Ψ columns since the library was loaded: out[0] solved, out[1] held
int psi_columns(unsigned long long* out) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(out, g_psi_columns, sizeof(g_psi_columns));
}

#ifdef SECTION_CLOCKS
static int rollout_threads = 0;

// the control: K1 at another block size (threads, a multiple of 32; 0: the
// wrapper's)
int set_rollout_threads(int n) { rollout_threads = n; return 0; }

// the section counters (N_SEC per kernel) since the last call, then zeroed
int read_sections(unsigned long long* out) {
  cudaDeviceSynchronize();
  int rc = (int)cudaMemcpyFromSymbol(out, g_sections, sizeof(g_sections));
  if (rc) return rc;
  unsigned long long zero[2 * N_SEC] = {};
  return (int)cudaMemcpyToSymbol(g_sections, zero, sizeof(zero));
}
#endif

#ifndef ABLATE
// warps: samples per block; warp_bytes: one sample's region
int fused_rollout_launch(const void* tables, const void* rows, const void* V, const void* mass,
                         const void* fric, void* costs, void* vis, int K, int H, int substeps,
                         float dt_sub, int sweeps, int world, int warps, int warp_bytes,
                         void* stream) {
#ifdef SECTION_CLOCKS
  if (rollout_threads > 0 && rollout_threads / 32 < warps) warps = rollout_threads / 32;
#endif
  const int blocks = (K + warps - 1) / warps;
  const int smem = (int)sizeof(SceneTables) + warps * warp_bytes;
  int rc = set_smem((const void*)fused_rollout_kernel, smem);
  if (rc != 0) return rc;
  fused_rollout_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const SceneTables*)tables, (const float*)rows, (const __nv_bfloat16*)V,
      (const float*)mass, (const float*)fric, (float*)costs, (float*)vis, K, H, substeps, dt_sub,
      sweeps, world);
  return (int)cudaGetLastError();
}

// N envs; warps: envs per block; warp_bytes: one env's region
// body: the body caches' rows (13·B, N), or null for none
int fused_world_step_launch(const void* tables, const void* rows, const void* tgt,
                            const void* mass, const void* fric, void* out, void* body, int N,
                            int substeps, float dt_sub, int sweeps, int warps, int warp_bytes,
                            void* stream) {
  const int blocks = (N + warps - 1) / warps;
  const int smem = (int)sizeof(SceneTables) + warps * warp_bytes;
  int rc = set_smem((const void*)fused_world_step_kernel, smem);
  if (rc != 0) return rc;
  fused_world_step_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const SceneTables*)tables, (const float*)rows, (const float*)tgt, (const float*)mass,
      (const float*)fric, (float*)out, (float*)body, N, substeps, dt_sub, sweeps, 1);
  return (int)cudaGetLastError();
}
#endif  // !ABLATE

}  // extern "C"

#ifdef ABLATE
// The ablation library: the launchers take the mask first and pick its
// instantiation; a mask that is not instantiated returns AB_NO_VARIANT.
#define AB_NO_VARIANT 1000

template <int AB>
static int rollout_launch(const void* tables, const void* rows, const void* V, const void* mass,
                          const void* fric, void* costs, void* vis, int K, int H, int substeps,
                          float dt_sub, int sweeps, int world, int warps, int warp_bytes,
                          void* stream) {
  const int blocks = (K + warps - 1) / warps;
  const int smem = (int)sizeof(SceneTables) + warps * warp_bytes;
  int rc = set_smem((const void*)fused_rollout_kernel<AB>, smem);
  if (rc != 0) return rc;
  fused_rollout_kernel<AB><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const SceneTables*)tables, (const float*)rows, (const __nv_bfloat16*)V,
      (const float*)mass, (const float*)fric, (float*)costs, (float*)vis, K, H, substeps, dt_sub,
      sweeps, world);
  return (int)cudaGetLastError();
}

template <int AB>
static int world_step_launch(const void* tables, const void* rows, const void* tgt,
                             const void* mass, const void* fric, void* out, void* body, int N,
                             int substeps, float dt_sub, int sweeps, int warps, int warp_bytes,
                             void* stream) {
  const int blocks = (N + warps - 1) / warps;
  const int smem = (int)sizeof(SceneTables) + warps * warp_bytes;
  int rc = set_smem((const void*)fused_world_step_kernel<AB>, smem);
  if (rc != 0) return rc;
  fused_world_step_kernel<AB><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const SceneTables*)tables, (const float*)rows, (const float*)tgt, (const float*)mass,
      (const float*)fric, (float*)out, (float*)body, N, substeps, dt_sub, sweeps, 1);
  return (int)cudaGetLastError();
}

extern "C" {

int fused_rollout_launch_ablate(int mask, const void* tables, const void* rows, const void* V,
                                const void* mass, const void* fric, void* costs, void* vis, int K,
                                int H, int substeps, float dt_sub, int sweeps, int world,
                                int warps, int warp_bytes, void* stream) {
#define AB_CASE(m)                                                                             \
  case (m):                                                                                    \
    return rollout_launch<(m)>(tables, rows, V, mass, fric, costs, vis, K, H, substeps, dt_sub, \
                               sweeps, world, warps, warp_bytes, stream);
  switch (mask) { AB_K1_MASKS(AB_CASE) }
#undef AB_CASE
  return AB_NO_VARIANT;
}

int fused_world_step_launch_ablate(int mask, const void* tables, const void* rows, const void* tgt,
                                   const void* mass, const void* fric, void* out, void* body,
                                   int N, int substeps, float dt_sub, int sweeps, int warps,
                                   int warp_bytes, void* stream) {
#define AB_CASE(m)                                                                             \
  case (m):                                                                                    \
    return world_step_launch<(m)>(tables, rows, tgt, mass, fric, out, body, N, substeps, dt_sub, \
                                  sweeps, warps, warp_bytes, stream);
  switch (mask) { AB_K2_MASKS(AB_CASE) }
#undef AB_CASE
  return AB_NO_VARIANT;
}

}  // extern "C"
#endif  // ABLATE
#endif  // FUSED_EMU
