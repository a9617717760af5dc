// Couple terms, operational inverse inertias, impulse sweeps and the
// stiction snap of the fused physics substep, per sample (one warp).
//
// Replaces the second half of dynamics_lanes in
// mppiisaac_tpu/ops/pallas/fused_physics.py: the implicit couple terms
// (910-969), Ψ per contact link of a couple or stiction block (971-995), the
// mass-splitting Jacobi impulse sweeps with their inverse-mass cache, warm
// start and vector friction cone (1027-1442) — stiction blocks (a floating
// base's link against a static geom) are friction-only there — and the
// stiction snap of the couple contacts (1443-1535), at world and at fast
// fidelity. The sweeps stay Jacobi: every candidate reads one frozen
// velocity snapshot, so the lanes of a sweep (one swept candidate each, in
// 32-lane chunks of whole blocks) are independent; each block's summed
// impulses are segmented scans over its lanes, applied at the end of the
// sweep. The articulated side is indexed by velocity coordinate
// (scene_tables.cuh). Plain twin: ops/fused_impulse.py.
#pragma once

#include "contacts.cuh"

#define DAMP_CAP_BETA 4.f
#define SW_BETA 0.2f
#define SW_SLOP 2e-3f
#define SW_RELAX 0.9f
#define SNAP_CLIP 0.05f

// the articulated body of a couple or stiction block
__device__ __forceinline__ int art_body_of(const SceneTables& sc, int bi) {
  return (sc.blk_flags[bi] & (F_A_ART | F_A_STA)) ? sc.blk_ba[bi] : sc.blk_bb[bi];
}

__device__ __forceinline__ bool is_couple(const SceneTables& sc, int bi) {
  return (sc.blk_flags[bi] & F_SWEPT) && (sc.blk_flags[bi] & (F_A_ART | F_B_ART));
}

// couple or stiction block: its articulated side takes part in the sweeps
__device__ __forceinline__ bool is_two_way(const SceneTables& sc, int bi) {
  return (sc.blk_flags[bi] & F_SWEPT) && (sc.blk_flags[bi] & (F_A_ART | F_B_ART | F_A_STA | F_B_STA));
}

__device__ __forceinline__ float kd_couple(const SceneTables& sc, int bi, const float* mass, int K,
                                           float dt, float tau_c) {
  const float cap = DAMP_CAP_BETA * sc.blk_m_oth[bi] * mass[sc.blk_ob[bi] * K] / (dt * sc.blk_npts[bi]);
  return fminf(2.f * sc.blk_kn[bi] / tau_c, cap);
}

// a live couple block of actor a
__device__ __forceinline__ bool couple_of(const SceneTables& sc, const Swept& sw, int bi, int a) {
  return is_couple(sc, bi) && sw.live[bi] && sc.body_actor[art_body_of(sc, bi)] == a;
}

// M += dt(kd+κ)·JᵀJ, rhs += dt·Jᵀ(e·kn·d⁺ + (kd+κ)·v_oth_n) for actor a's
// couple blocks; J_j = X·S_j, X = (p×n, n). Chunk by chunk of the swept
// blocks: lanes over the chunk's couple samples fill J (J[lane][j], row
// stride nv) and the two coefficients; then lanes over the entries of M and
// rhs, each summed block by block in block order, over a block's samples in
// order.
__device__ void couple_terms(const SceneTables& sc, const Kin& k, const Swept& sw, int a,
                             const float* mass, int K, float dt, Ctx& c, float* rhs, float* J,
                             float* coef, int lane) {
  const int v0 = sc.actor_v0[a], nv = sc.actor_nv[a], ld = sc.nv;
  const float tau_c = fmaxf(2.f * dt, 1e-3f);
  float* coefM = coef;
  float* coefR = coef + 32;
  for (int ch = 0; ch < sc.n_sw; ++ch) {
    const unsigned char* cb = &sc.sw_blk[ch * 32];
    bool any = false;
    for (int l = 0; l < 32 && cb[l] != 255; l += sc.blk_S[cb[l]]) any |= couple_of(sc, sw, cb[l], a);
    if (!any) continue;
    const int bi = cb[lane];
    if (bi != 255 && couple_of(sc, sw, bi, a)) {
      const int ci = sc.blk_c0[bi] + lane - sc.blk_swlane0[bi];
      const int mask = sc.body_vmask[art_body_of(sc, bi)];
      const float e = (sc.blk_flags[bi] & F_A_ART) ? 1.f : -1.f;
      const float kn_c = sc.blk_kn[bi] / (tau_c * tau_c);
      const float kd_c = kd_couple(sc, bi, mass, K, dt, tau_c);
      const float kap = dt * kn_c;
      const float* pt = sw.pt[ci];
      const float* n = sw.nrm[ci];
      const float depth_c = fminf(sw.depth[ci], sc.max_depth);
      const float act = depth_c > 0.f ? 1.f : 0.f;
      float X6[6], v_oth[3];
      cross3(pt, n, X6);
      X6[3] = n[0]; X6[4] = n[1]; X6[5] = n[2];
      for (int j = 0; j < nv; ++j) {
        if (!((mask >> (v0 + j)) & 1)) continue;
        float v = 0.f;
        for (int r = 0; r < 6; ++r) v += X6[r] * c.S[v0 + j][r];
        J[lane * nv + j] = v;
      }
      point_vel(k, sc.blk_ob[bi], pt, v_oth);
      const float v_oth_n = dot3(v_oth, n);
      coefM[lane] = dt * (kd_c + kap) * act;
      coefR[lane] = dt * (e * kn_c * fmaxf(depth_c, 0.f) + (kd_c + kap) * v_oth_n) * act;
    }
    __syncwarp();
    for (int e2 = lane; e2 < nv * (nv + 1); e2 += 32) {
      // e2 < nv: rhs entry i; else M entry (i, j), j ≥ i
      const bool is_rhs = e2 < nv;
      const int i = is_rhs ? e2 : (e2 - nv) / nv, j = is_rhs ? e2 : (e2 - nv) % nv;
      if (j < i) continue;
      for (int l = 0; l < 32 && cb[l] != 255; l += sc.blk_S[cb[l]]) {
        const int b2 = cb[l];
        if (!couple_of(sc, sw, b2, a)) continue;
        const int mask = sc.body_vmask[art_body_of(sc, b2)];
        if (!((mask >> (v0 + i)) & 1) || !((mask >> (v0 + j)) & 1)) continue;
        float m = 0.f;
        if (is_rhs) {
          for (int q = l; q < l + sc.blk_S[b2]; ++q) m += coefR[q] * J[q * nv + i];
          rhs[i] += m;
        } else {
          for (int q = l; q < l + sc.blk_S[b2]; ++q) m += coefM[q] * J[q * nv + i] * J[q * nv + j];
          c.L[(v0 + i) * ld + v0 + j] += m;
          if (j != i) c.L[(v0 + j) * ld + v0 + i] += m;
        }
      }
    }
    __syncwarp();
  }
}

// Ψ_b = Φ_b M⁻¹ Φ_bᵀ for actor a's couple and stiction contact links, from
// its factor: lanes over (link, column) pairs, each solving its column in
// col (nv words per lane)
__device__ void psi_blocks(const SceneTables& sc, int a, Ctx& c, float* col_all, int lane) {
  const int v0 = sc.actor_v0[a], nv = sc.actor_nv[a], ld = sc.nv;
  float* col = col_all + lane * sc.nv;
  for (int job = lane; job < sc.n_psi * 6; job += 32) {
    const int slot = job / 6, c6 = job % 6;
    const int b = sc.psi_body[slot];
    if (sc.body_actor[b] != a) continue;
    const int mask = sc.body_vmask[b];
    for (int j = 0; j < nv; ++j) col[j] = ((mask >> (v0 + j)) & 1) ? c.S[v0 + j][c6] : 0.f;
    chol_solve(c.L, v0, nv, ld, col, col);
    for (int r = 0; r < 6; ++r) {
      float v = 0.f;
      for (int j = 0; j < nv; ++j)
        if ((mask >> (v0 + j)) & 1) v += c.S[v0 + j][r] * col[j];
      c.psi[slot][r * 6 + c6] = v;
    }
  }
  __syncwarp();
}

// spatial velocity (ω, v_O) of every couple or stiction contact link from
// its actor's generalized velocity: lanes over the links
__device__ void link_velocities(const SceneTables& sc, const Ctx& c, float (*v6)[6], int lane) {
  for (int slot = lane; slot < sc.n_psi; slot += 32) {
    const int b = sc.psi_body[slot];
    const int a = sc.body_actor[b], v0 = sc.actor_v0[a], nv = sc.actor_nv[a];
    const int mask = sc.body_vmask[b];
    for (int r = 0; r < 6; ++r) v6[slot][r] = 0.f;
    for (int j = 0; j < nv; ++j) {
      if (!((mask >> (v0 + j)) & 1)) continue;
      for (int r = 0; r < 6; ++r) v6[slot][r] += c.S[v0 + j][r] * c.u[v0 + j];
    }
  }
  __syncwarp();
}

__device__ __forceinline__ float quad(const float* Kc, float floor, const float* d) {
  const float q = d[0] * d[0] * Kc[0] + d[1] * d[1] * Kc[3] + d[2] * d[2] * Kc[5]
                  + 2.f * (d[0] * d[1] * Kc[1] + d[0] * d[2] * Kc[2] + d[1] * d[2] * Kc[4]);
  return fmaxf(q, floor);
}

// The impulse pass's per-substep arrays (IMP_* of the warp's region).
struct Imp {
  float *inv_m, (*invIw)[9], *cnt_body, *cnt_act, *act, *mu_b, (*Kc)[6], *kn_c, *floor_b, *neff_b;
  float (*dP)[3], (*dT)[3], (*Y)[6], (*v6)[6], (*A)[36], (*bs)[6];
  int* used;
  float (*bsum)[12];
  float (*ssum)[27];  // the snap's per-block sums (lower triangle of A, then b)
};

// One candidate's share of its block's impulse sums: the impulse, its
// torque about each free side's root, and about the origin (the
// articulated side's Plücker impulse); zeros where a side does not apply.
__device__ __forceinline__ void contrib(const SceneTables& sc, const Sample& s0, int bi,
                                        const float* pt, const float* imp, float* v) {
  const int fl = sc.blk_flags[bi];
  for (int i = 0; i < 3; ++i) v[i] = imp[i];
  for (int side = 0; side < 2; ++side) {
    float* t = v + 3 + 3 * side;
    if (fl & (side == 0 ? F_A_FREE : F_B_FREE)) {
      const int a = sc.body_actor[side == 0 ? sc.blk_ba[bi] : sc.blk_bb[bi]];
      float r[3];
      for (int i = 0; i < 3; ++i) r[i] = pt[i] - s0.root[a][i];
      cross3(r, imp, t);
    } else {
      t[0] = t[1] = t[2] = 0.f;
    }
  }
  if (fl & (F_A_ART | F_B_ART | F_A_STA | F_B_STA)) cross3(pt, imp, v + 9);
  else v[9] = v[10] = v[11] = 0.f;
}

// The blocks' summed contributions (bsum, 12 per block, from the segmented
// scans) into the pass's accumulators, each over its own blocks in block
// order: lanes 0-7 over the free actors' impulse and angular impulse
// (ab_start), lanes 8-23 over the Ψ slots' Plücker impulses (pb_start).
// Blocks with `only_live` set and a gate off add nothing. With the sweeps
// one-way (AB_ONE_WAY_SWEEPS) no Plücker impulse reaches the Ψ slots.
AB_TEMPLATE __device__ void accumulate(const SceneTables& sc, const Swept& sw, Imp& m, bool only_live,
                                       int lane) {
  if (lane < sc.nactor) {
    const int a = lane;
    float p[3] = {0.f, 0.f, 0.f}, t[3] = {0.f, 0.f, 0.f};
    for (int e = sc.ab_start[a]; e < sc.ab_start[a + 1]; ++e) {
      const int bi = sc.ab_ent[e] >> 1;
      if (only_live && !sw.live[bi]) continue;
      const float* b = m.bsum[bi];
      if (!(sc.ab_ent[e] & 1))
        for (int i = 0; i < 3; ++i) { p[i] += b[i]; t[i] += b[3 + i]; }
      else
        for (int i = 0; i < 3; ++i) { p[i] -= b[i]; t[i] -= b[6 + i]; }
    }
    for (int i = 0; i < 3; ++i) { m.dP[a][i] = p[i]; m.dT[a][i] = t[i]; }
  } else if (lane >= MAX_ACTORS && lane - MAX_ACTORS < sc.n_psi) {
    const int slot = lane - MAX_ACTORS;
    float y[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e = sc.pb_start[slot]; AB_UNLESS(AB_ONE_WAY_SWEEPS, e < sc.pb_start[slot + 1]); ++e) {
      const int bi = sc.pb_ent[e] >> 1;
      if (only_live && !sw.live[bi]) continue;
      const float* b = m.bsum[bi];
      if (!(sc.pb_ent[e] & 1))
        for (int i = 0; i < 3; ++i) { y[i] += b[9 + i]; y[3 + i] += b[i]; }
      else
        for (int i = 0; i < 3; ++i) { y[i] -= b[9 + i]; y[3 + i] -= b[i]; }
    }
    for (int i = 0; i < 6; ++i) m.Y[slot][i] = y[i];
  }
  __syncwarp();
}

// Jacobi end-of-pass apply: free-body velocities (lanes over the actors),
// and the exact fold-back ΔU = M⁻¹ΦᵀY per articulated actor in the pass
// (lanes over its coordinates)
__device__ void commit(const SceneTables& sc, const Imp& m, Ctx& c, int lane) {
  if (lane < sc.nactor && sc.actor_dynamic[lane] == ACTOR_FREE) {
    const int a = lane;
    for (int i = 0; i < 3; ++i) {
      c.fv[a][i] += m.dP[a][i] * m.inv_m[a];
      c.fv[a][3 + i] += m.invIw[a][3 * i] * m.dT[a][0] + m.invIw[a][3 * i + 1] * m.dT[a][1]
                        + m.invIw[a][3 * i + 2] * m.dT[a][2];
    }
  }
  for (int a = 0; a < sc.nactor; ++a) {
    if (sc.actor_dynamic[a] != ACTOR_ARTICULATED || !c.deferred[a]) continue;
    const int v0 = sc.actor_v0[a], nv = sc.actor_nv[a];
    float r = 0.f;
    if (lane < nv) {
      const int j = lane;
      for (int b = 0; b < sc.nbody; ++b) {
        const int slot = sc.body_psi[b];
        if (slot < 0 || sc.body_actor[b] != a) continue;
        if (!((sc.body_vmask[b] >> (v0 + j)) & 1)) continue;
        float v = 0.f;
        for (int q = 0; q < 6; ++q) v += c.S[v0 + j][q] * m.Y[slot][q];
        r += v;
      }
    }
    r = chol_solve_warp(c.L, v0, nv, sc.nv, r, lane);
    if (lane < nv) c.u[v0 + lane] += r;
  }
  __syncwarp();
}

// velocity of body b at point p inside a sweep (frozen snapshot)
__device__ __forceinline__ void vel_at(const SceneTables& sc, const Sample& s0, const Kin& k,
                                       const Ctx& c, const float (*v6)[6], int b, const float* p,
                                       float* v) {
  const int a = sc.body_actor[b];
  float d[3], cr[3];
  if (sc.actor_dynamic[a] == ACTOR_FREE) {
    for (int i = 0; i < 3; ++i) d[i] = p[i] - s0.root[a][i];
    cross3(&c.fv[a][3], d, cr);
    for (int i = 0; i < 3; ++i) v[i] = c.fv[a][i] + cr[i];
    return;
  }
  const int slot = sc.body_psi[b];
  if (slot >= 0) {
    cross3(v6[slot], p, cr);
    for (int i = 0; i < 3; ++i) v[i] = v6[slot][3 + i] + cr[i];
    return;
  }
  point_vel(k, b, p, v);
}

// The impulse pass of one substep: warm start from the λ rows, `sweeps`
// Jacobi sweeps, the stiction snap. Updates c.fv, c.u and s.lam. At fast
// fidelity (world == false) the sweeps start from zero λ and there is no
// snap (fused_physics.py:1395-1443).
AB_TEMPLATE __device__ void impulse_pass(const SceneTables& sc, Sample& s, const Kin& k,
                                         const float* mass, const float* fric, int K, float dt,
                                         const Swept& sw, int sweeps, bool world, Ctx& c, Imp& m,
                                         int lane) {
  SEC_BEGIN;
  const float dcap = sc.max_depth;
  const float tau_c = fmaxf(2.f * dt, 1e-3f);
  if (lane < sc.nactor) {
    const int a = lane;
    m.cnt_body[a] = 0.f;
    m.cnt_act[a] = 0.f;
    if (sc.actor_dynamic[a] == ACTOR_FREE) {
      const float ms = fmaxf(mass[sc.actor_body0[a] * K], 1e-6f);
      m.inv_m[a] = sc.actor_invm[a] / ms;
      float R[3][3], RI[3][3];
      q_to_R(&s.root[a][3], R);
      const float* Ii = &sc.actor_iinv[9 * a];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) RI[i][j] = R[i][0] * Ii[j] + R[i][1] * Ii[3 + j] + R[i][2] * Ii[6 + j];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          m.invIw[a][3 * i + j] = (RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2]) / ms;
    }
  }
  // per-substep invariants: activity, friction, active-contact counts
  for (int ci = lane; ci < sc.n_fc; ci += 32)
    m.act[ci] = fminf(sw.depth[ci], dcap) > 0.f ? 1.f : 0.f;
  for (int bi = lane; bi < sc.nblk; bi += 32) {
    const int fl = sc.blk_flags[bi];
    if (!(fl & F_SWEPT)) continue;
    const float fa = fric[sc.blk_ga[bi] * K];
    const float fb = (fl & F_HAS_B) ? fric[sc.blk_gb[bi] * K] : fa;
    m.mu_b[bi] = sc.blk_mu0[bi] * 0.5f * (fa + fb);
  }
  __syncwarp();
  if (lane < sc.nactor) {
    const int a = lane;
    for (int bi = 0; bi < sc.nblk; ++bi) {
      const int fl = sc.blk_flags[bi];
      if (!(fl & F_SWEPT)) continue;
      const bool on_a = (fl & F_A_FREE) && sc.body_actor[sc.blk_ba[bi]] == a;
      const bool on_b = (fl & F_B_FREE) && sc.body_actor[sc.blk_bb[bi]] == a;
      const bool on_art = is_two_way(sc, bi) && sc.body_actor[art_body_of(sc, bi)] == a;
      if (!(on_a || on_b || on_art)) continue;
      const int S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
      float sum = 0.f;
      for (int q = 0; q < S; ++q) sum += m.act[c0 + q];
      if (on_a) m.cnt_body[a] += sum;
      if (on_b) m.cnt_body[a] += sum;
      if (on_art) m.cnt_act[a] += sum;
    }
  }
  __syncwarp();
  for (int bi = lane; bi < sc.nblk; bi += 32) {
    const int fl = sc.blk_flags[bi];
    if (!(fl & F_SWEPT)) continue;
    float ne = 0.f;
    if (fl & F_A_FREE) ne += m.cnt_body[sc.body_actor[sc.blk_ba[bi]]];
    if (fl & F_B_FREE) ne += m.cnt_body[sc.body_actor[sc.blk_bb[bi]]];
    if (is_two_way(sc, bi)) ne += m.cnt_act[sc.body_actor[art_body_of(sc, bi)]];
    m.neff_b[bi] = fmaxf(ne, 1.f);
    float floor = 1e-9f;
    if (sw.live[bi]) {
      if (fl & F_A_FREE) floor += m.inv_m[sc.body_actor[sc.blk_ba[bi]]];
      if (fl & F_B_FREE) floor += m.inv_m[sc.body_actor[sc.blk_bb[bi]]];
    } else {
      floor = 1.f;
    }
    m.floor_b[bi] = floor;
  }
  __syncwarp();

  // contact-space inverse mass per candidate, fixed within the substep
  for (int ci = lane; ci < sc.n_fc; ci += 32) {
    const int bi = sc.cand_blk[ci];
    const int fl = sc.blk_flags[bi];
    float* kc = m.Kc[ci];
    if (!sw.live[bi]) {
      for (int i = 0; i < 6; ++i) kc[i] = 0.f;
      m.kn_c[ci] = 1.f;
      continue;
    }
    const float* pt = sw.pt[ci];
    float Km[3][3] = {{1e-9f, 0.f, 0.f}, {0.f, 1e-9f, 0.f}, {0.f, 0.f, 1e-9f}};
    for (int side = 0; side < 2; ++side) {
      if (!(fl & (side == 0 ? F_A_FREE : F_B_FREE))) continue;
      const int a = sc.body_actor[side == 0 ? sc.blk_ba[bi] : sc.blk_bb[bi]];
      const float r0 = pt[0] - s.root[a][0], r1 = pt[1] - s.root[a][1], r2 = pt[2] - s.root[a][2];
      const float sk[3][3] = {{0.f, -r2, r1}, {r2, 0.f, -r0}, {-r1, r0, 0.f}};
      const float* I2 = m.invIw[a];
      float T[3][3];
      for (int i = 0; i < 3; ++i) {
        T[i][0] = I2[3 * i + 1] * sk[1][0] + I2[3 * i + 2] * sk[2][0];
        T[i][1] = I2[3 * i + 0] * sk[0][1] + I2[3 * i + 2] * sk[2][1];
        T[i][2] = I2[3 * i + 0] * sk[0][2] + I2[3 * i + 1] * sk[1][2];
      }
      for (int x = 0; x < 3; ++x) {
        Km[x][x] += m.inv_m[a];
        const int i1 = x == 0 ? 1 : 0, i2 = x == 2 ? 1 : 2;
        for (int y = x; y < 3; ++y) Km[x][y] += sk[i1][x] * T[i1][y] + sk[i2][x] * T[i2][y];
      }
    }
    if (AB_UNLESS(AB_ONE_WAY_SWEEPS, is_two_way(sc, bi))) {
      const float* P_ = c.psi[sc.body_psi[art_body_of(sc, bi)]];
      const float P[3][3] = {{0.f, -pt[2], pt[1]}, {pt[2], 0.f, -pt[0]}, {-pt[1], pt[0], 0.f}};
      float V[6][3];
      for (int r = 0; r < 6; ++r) {
        V[r][0] = P_[r * 6 + 1] * P[1][0] + P_[r * 6 + 2] * P[2][0] + P_[r * 6 + 3];
        V[r][1] = P_[r * 6 + 0] * P[0][1] + P_[r * 6 + 2] * P[2][1] + P_[r * 6 + 4];
        V[r][2] = P_[r * 6 + 0] * P[0][2] + P_[r * 6 + 1] * P[1][2] + P_[r * 6 + 5];
      }
      for (int x = 0; x < 3; ++x) {
        const int i1 = x == 0 ? 1 : 0, i2 = x == 2 ? 1 : 2;
        for (int y = x; y < 3; ++y) Km[x][y] += P[i1][x] * V[i1][y] + P[i2][x] * V[i2][y] + V[3 + x][y];
      }
    }
    kc[0] = Km[0][0]; kc[1] = Km[0][1]; kc[2] = Km[0][2];
    kc[3] = Km[1][1]; kc[4] = Km[1][2]; kc[5] = Km[2][2];
    m.kn_c[ci] = quad(kc, m.floor_b[bi], sw.nrm[ci]);
  }
  __syncwarp();
  SEC_MARK(c.kid, SEC_INVMASS);

  // warm start: re-apply the carried impulses on currently active samples
  for (int ch = 0; ch < sc.n_sw; ++ch) {
    const int bi = sc.sw_blk[ch * 32 + lane];
    float v[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = 0.f;
    int seg0 = lane, q = -1;
    if (bi != 255) {
      seg0 = sc.blk_swlane0[bi];
      q = lane - seg0;
      const int ci = sc.blk_c0[bi] + q;
      float* l = s.lam[ci];
      if (!sw.live[bi] || !world) {
        l[0] = l[1] = l[2] = l[3] = 0.f;
      } else {
        const float a_ = m.act[ci];
        l[0] *= a_; l[1] *= a_; l[2] *= a_; l[3] *= a_;
        float imp[3];
        for (int i = 0; i < 3; ++i) imp[i] = sw.nrm[ci][i] * l[0] + l[1 + i];
        contrib(sc, s, bi, sw.pt[ci], imp, v);
      }
    }
    seg_scan<12>(v, lane, seg0);
    if (bi != 255 && q == sc.blk_S[bi] - 1)
      for (int i = 0; i < 12; ++i) m.bsum[bi][i] = v[i];
  }
  __syncwarp();
  if (world) {
    accumulate AB_ARG(sc, sw, m, true, lane);
    commit(sc, m, c, lane);
  }
  SEC_MARK(c.kid, SEC_WARM);

  for (int it = 0; it < sweeps; ++it) {
    link_velocities(sc, c, m.v6, lane);
    for (int ch = 0; ch < sc.n_sw; ++ch) {
      const int bi = sc.sw_blk[ch * 32 + lane];
      float v[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) v[i] = 0.f;
      int seg0 = lane, q = -1;
      if (bi != 255) {
        seg0 = sc.blk_swlane0[bi];
        q = lane - seg0;
      }
      if (bi != 255 && sw.live[bi]) {
        const int fl = sc.blk_flags[bi];
        const float ne = m.neff_b[bi];
        const int ci = sc.blk_c0[bi] + q;
        const float* pt = sw.pt[ci];
        const float* n = sw.nrm[ci];
        float* l = s.lam[ci];
        const float depth = fminf(sw.depth[ci], dcap);
        const bool active = m.act[ci] > 0.f;
        const float target = fminf(SW_BETA * fmaxf(depth - SW_SLOP, 0.f) / dt, 0.5f);
        float v_rel[3], vb[3];
        vel_at(sc, s, k, c, m.v6, sc.blk_ba[bi], pt, v_rel);
        if (fl & F_HAS_B) {
          vel_at(sc, s, k, c, m.v6, sc.blk_bb[bi], pt, vb);
          for (int i = 0; i < 3; ++i) v_rel[i] -= vb[i];
        }
        const float vn = dot3(v_rel, n);
        const bool sta = fl & (F_A_STA | F_B_STA);
        const float ln0 = l[0];
        // stiction blocks are friction-only: the stiff penalty carries the
        // normal force, and λ_n is carried unchanged
        const float d_lam = active && !sta ? -(vn - target) / (m.kn_c[ci] * ne) * SW_RELAX : 0.f;
        const float new_lam = sta ? ln0 : fmaxf(ln0 + d_lam, 0.f);
        float vt[3], t_dir[3], lt_new[3], imp[3];
        for (int i = 0; i < 3; ++i) vt[i] = v_rel[i] - n[i] * vn;
        const float vt_n = sqrtf(dot3(vt, vt) + 1e-9f);
        const float inv_vt = 1.f / vt_n;
        for (int i = 0; i < 3; ++i) t_dir[i] = vt[i] * inv_vt;
        const float k_t = quad(m.Kc[ci], m.floor_b[bi], t_dir);
        // friction-cone seed from the normal force the velocity solve applied
        float seed = 0.f;
        if (sta) {
          const float knc = sc.blk_kn[bi] / (tau_c * tau_c);
          seed = fmaxf(knc * fmaxf(depth, 0.f) - (2.f * sc.blk_kn[bi] / tau_c) * vn, 0.f);
        } else if (AB_UNLESS(AB_ONE_WAY_SWEEPS, fl & (F_A_ART | F_B_ART))) {
          const float knc = sc.blk_kn[bi] / (tau_c * tau_c);
          const float kdc = kd_couple(sc, bi, mass, K, dt, tau_c);
          seed = fmaxf(knc * fmaxf(depth, 0.f) - (kdc + dt * knc) * vn, 0.f);
        } else if ((fl & F_HAS_B) && ((fl & F_A_FREE) != 0) != ((fl & F_B_FREE) != 0)) {
          seed = (sc.blk_kn[bi] / (tau_c * tau_c)) * fmaxf(depth, 0.f);
        }
        const float cap = m.mu_b[bi] * (new_lam + seed * dt);
        for (int i = 0; i < 3; ++i) lt_new[i] = l[1 + i] + (active ? -vt[i] / (k_t * ne) : 0.f);
        const float ltn = sqrtf(dot3(lt_new, lt_new) + 1e-9f);
        const float scl = fminf(1.f, cap / ltn);
        for (int i = 0; i < 3; ++i) {
          const float lp = lt_new[i] * scl;
          imp[i] = n[i] * (new_lam - ln0) + (lp - l[1 + i]);
          l[1 + i] = lp;
        }
        l[0] = new_lam;
        contrib(sc, s, bi, pt, imp, v);
      }
      seg_scan<12>(v, lane, seg0);
      if (bi != 255 && q == sc.blk_S[bi] - 1)
        for (int i = 0; i < 12; ++i) m.bsum[bi][i] = v[i];
    }
    __syncwarp();
    accumulate AB_ARG(sc, sw, m, true, lane);
    commit(sc, m, c, lane);
  }
  SEC_MARK(c.kid, SEC_SWEEPS);

  // stiction snap: one regularised 6×6 least-squares solve per free body
  // matching its rigid motion to the articulated side at every sticking
  // couple sample, clipped to ±SNAP_CLIP. Lanes over the swept chunks'
  // couple samples; each block's 27 sums (ssum: A's lower triangle, then b)
  // are segmented scans, added to its free actor's system in block order by
  // lanes over (actor, entry).
  if (sc.n_psi == 0 || !world) return;
  link_velocities(sc, c, m.v6, lane);
  for (int ch = 0; ch < sc.n_sw; ++ch) {
    const int bi = sc.sw_blk[ch * 32 + lane];
    float v[27];
#pragma unroll
    for (int i = 0; i < 27; ++i) v[i] = 0.f;
    int seg0 = lane, q = -1;
    if (bi != 255) {
      seg0 = sc.blk_swlane0[bi];
      q = lane - seg0;
    }
    if (bi != 255 && is_couple(sc, bi) && sw.live[bi]) {
      const int fl = sc.blk_flags[bi];
      const bool a_art = fl & F_A_ART;
      const int af = sc.body_actor[a_art ? sc.blk_bb[bi] : sc.blk_ba[bi]];
      const int slot = sc.body_psi[art_body_of(sc, bi)];
      const float e_snap = a_art ? -1.f : 1.f;
      const float knc = sc.blk_kn[bi] / (tau_c * tau_c);
      const float kdc = kd_couple(sc, bi, mass, K, dt, tau_c);
      const int ci = sc.blk_c0[bi] + q;
      const float* pt = sw.pt[ci];
      const float* n = sw.nrm[ci];
      float r[3], cr[3], v_free[3], v_art[3], v_rel[3];
      for (int i = 0; i < 3; ++i) r[i] = pt[i] - s.root[af][i];
      cross3(&c.fv[af][3], r, cr);
      for (int i = 0; i < 3; ++i) v_free[i] = c.fv[af][i] + cr[i];
      cross3(m.v6[slot], pt, cr);
      for (int i = 0; i < 3; ++i) v_art[i] = m.v6[slot][3 + i] + cr[i];
      for (int i = 0; i < 3; ++i) v_rel[i] = a_art ? v_art[i] - v_free[i] : v_free[i] - v_art[i];
      const float vn_f = dot3(v_rel, n);
      const float fn_imp = fmaxf(knc * fmaxf(fminf(sw.depth[ci], dcap), 0.f) - (kdc + dt * knc) * vn_f, 0.f);
      const float cap_f = m.mu_b[bi] * (s.lam[ci][0] + fn_imp * dt);
      const float* lt = &s.lam[ci][1];
      const float lt_n = sqrtf(dot3(lt, lt));
      const float w_st = m.act[ci] * (lt_n < 0.98f * cap_f ? 1.f : 0.f);
      // X (3×6): point-velocity map of the free body, ξ = (Δω, Δv)
      const float X[3][6] = {{0.f, r[2], -r[1], 1.f, 0.f, 0.f},
                             {-r[2], 0.f, r[0], 0.f, 1.f, 0.f},
                             {r[1], -r[0], 0.f, 0.f, 0.f, 1.f}};
      float P[3][3], PX[3][6], Pv[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) P[i][j] = (i == j ? 1.f : 0.f) - n[i] * n[j];
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 6; ++j) PX[i][j] = P[i][0] * X[0][j] + P[i][1] * X[1][j] + P[i][2] * X[2][j];
        Pv[i] = P[i][0] * (e_snap * v_rel[0]) + P[i][1] * (e_snap * v_rel[1]) + P[i][2] * (e_snap * v_rel[2]);
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        v[21 + i] = w_st * (X[0][i] * Pv[0] + X[1][i] * Pv[1] + X[2][i] * Pv[2]);
#pragma unroll
        for (int j = 0; j <= i; ++j)
          v[i * (i + 1) / 2 + j] = w_st * (X[0][i] * PX[0][j] + X[1][i] * PX[1][j] + X[2][i] * PX[2][j]);
      }
    }
    seg_scan<27>(v, lane, seg0);
    if (bi != 255 && q == sc.blk_S[bi] - 1 && is_couple(sc, bi))
      for (int i = 0; i < 27; ++i) m.ssum[bi][i] = v[i];
  }
  __syncwarp();
  // the systems: A's lower triangle and b, each entry over the actor's live
  // couple blocks in block order
  for (int j = lane; j < sc.nactor * 27; j += 32) {
    const int a = j / 27, e = j % 27;
    float acc = 0.f;
    int used = 0;
    for (int t = sc.ab_start[a]; t < sc.ab_start[a + 1]; ++t) {
      const int bi = sc.ab_ent[t] >> 1;
      if (!is_couple(sc, bi)) continue;
      used = 1;
      if (sw.live[bi]) acc += e < 21 ? m.ssum[bi][e] : -m.ssum[bi][e];
    }
    if (e < 21) {
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      m.A[a][i * 6 + (e - i * (i + 1) / 2)] = acc;
    } else {
      m.bs[a][e - 21] = acc;
    }
    if (e == 0) m.used[a] = used;
  }
  __syncwarp();
  if (lane < sc.nactor && m.used[lane]) {
    const int a = lane;
    float xi[6];
    for (int i = 0; i < 36; i += 7) m.A[a][i] += 1e-4f;
    chol_factor(m.A[a], m.A[a], 0, 6, 6);
    chol_solve(m.A[a], 0, 6, 6, m.bs[a], xi);
    for (int i = 0; i < 3; ++i) {
      c.fv[a][3 + i] += fminf(fmaxf(xi[i], -SNAP_CLIP), SNAP_CLIP);
      c.fv[a][i] += fminf(fmaxf(xi[3 + i], -SNAP_CLIP), SNAP_CLIP);
    }
  }
  __syncwarp();
  SEC_MARK(c.kid, SEC_SNAP);
}
