// Couple terms, operational inverse inertias, impulse sweeps and the
// stiction snap of the fused physics substep, per sample (one thread).
//
// Replaces the second half of dynamics_lanes in
// mppiisaac_tpu/ops/pallas/fused_physics.py: the implicit couple terms
// (910-969), Ψ per contact link of a couple or stiction block (971-995), the
// mass-splitting Jacobi impulse sweeps with their inverse-mass cache, warm
// start and vector friction cone (1027-1442) — stiction blocks (a floating
// base's link against a static geom) are friction-only there — and the
// stiction snap of the couple contacts (1443-1535), at world and at fast
// fidelity. The sweeps stay Jacobi:
// every block reads one frozen velocity snapshot, and the summed impulses
// are applied at the end of the sweep. The articulated side is indexed by
// velocity coordinate (scene_tables.cuh). Plain twin: ops/fused_impulse.py.
#pragma once

#include "contacts.cuh"

#define DAMP_CAP_BETA 4.f
#define SW_BETA 0.2f
#define SW_SLOP 2e-3f
#define SW_RELAX 0.9f
#define SNAP_CLIP 0.05f

// Solve context of one substep, by velocity coordinate / body slot / actor.
struct Ctx {
  float S[MAX_V][6];                 // world motion subspace of every coordinate
  float L[MAX_V * MAX_V];            // velocity-solve matrices (actor blocks),
                                     // factored in place
  float u[MAX_V];                    // articulated actors' generalized velocity
  float psi[MAX_PSI][36];            // Ψ per couple or stiction contact link
  float fv[MAX_ACTORS][6];           // free bodies: linvel, angvel
  bool deferred[MAX_ACTORS];         // articulated actor in the impulse pass
};

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

// M += dt(kd+κ)·JᵀJ, rhs += dt·Jᵀ(e·kn·d⁺ + (kd+κ)·v_oth_n) for actor a's
// couple blocks; J_j = X·S_j, X = (p×n, n)
__device__ void couple_terms(const SceneTables& sc, const Kin& k, const Swept& sw, int a,
                             const float* mass, int K, float dt, Ctx& c, float* rhs) {
  const int v0 = sc.actor_v0[a], nv = sc.actor_nv[a];
  const float tau_c = fmaxf(2.f * dt, 1e-3f);
  float J[MAX_S][MAX_V], coefM[MAX_S], coefR[MAX_S];
  for (int bi = 0; bi < sc.nblk; ++bi) {
    if (!is_couple(sc, bi) || !sw.live[bi]) continue;
    const int art_b = art_body_of(sc, bi);
    if (sc.body_actor[art_b] != a) continue;
    const float e = (sc.blk_flags[bi] & F_A_ART) ? 1.f : -1.f;
    const int mask = sc.body_vmask[art_b], S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
    const int ob = sc.blk_ob[bi];
    const float kn_c = sc.blk_kn[bi] / (tau_c * tau_c);
    const float kd_c = kd_couple(sc, bi, mass, K, dt, tau_c);
    const float kap = dt * kn_c;
    for (int s = 0; s < S; ++s) {
      const float* pt = sw.pt[c0 + s];
      const float* n = sw.nrm[c0 + s];
      const float depth_c = fminf(sw.depth[c0 + s], sc.max_depth);
      const float act = depth_c > 0.f ? 1.f : 0.f;
      float X6[6], v_oth[3];
      cross3(pt, n, X6);
      X6[3] = n[0]; X6[4] = n[1]; X6[5] = n[2];
      for (int j = 0; j < nv; ++j) {
        if (!((mask >> (v0 + j)) & 1)) continue;
        float v = 0.f;
        for (int r = 0; r < 6; ++r) v += X6[r] * c.S[v0 + j][r];
        J[s][j] = v;
      }
      point_vel(k, ob, pt, v_oth);
      const float v_oth_n = dot3(v_oth, n);
      coefM[s] = dt * (kd_c + kap) * act;
      coefR[s] = dt * (e * kn_c * fmaxf(depth_c, 0.f) + (kd_c + kap) * v_oth_n) * act;
    }
    for (int i = 0; i < nv; ++i) {
      if (!((mask >> (v0 + i)) & 1)) continue;
      float r = 0.f;
      for (int s = 0; s < S; ++s) r += coefR[s] * J[s][i];
      rhs[i] += r;
      for (int j = i; j < nv; ++j) {
        if (!((mask >> (v0 + j)) & 1)) continue;
        float m = 0.f;
        for (int s = 0; s < S; ++s) m += coefM[s] * J[s][i] * J[s][j];
        c.L[(v0 + i) * MAX_V + v0 + j] += m;
        if (j != i) c.L[(v0 + j) * MAX_V + v0 + i] += m;
      }
    }
  }
}

// Ψ_b = Φ_b M⁻¹ Φ_bᵀ for actor a's couple and stiction contact links, from
// its factor
__device__ void psi_blocks(const SceneTables& sc, int a, Ctx& c) {
  const int v0 = sc.actor_v0[a], nv = sc.actor_nv[a];
  for (int b = 0; b < sc.nbody; ++b) {
    const int slot = sc.body_psi[b];
    if (slot < 0 || sc.body_actor[b] != a) continue;
    const int mask = sc.body_vmask[b];
    for (int c6 = 0; c6 < 6; ++c6) {
      float col[MAX_V];
      for (int j = 0; j < nv; ++j) col[j] = ((mask >> (v0 + j)) & 1) ? c.S[v0 + j][c6] : 0.f;
      chol_solve(c.L, v0, nv, MAX_V, col, col);
      for (int r = 0; r < 6; ++r) {
        float v = 0.f;
        for (int j = 0; j < nv; ++j)
          if ((mask >> (v0 + j)) & 1) v += c.S[v0 + j][r] * col[j];
        c.psi[slot][r * 6 + c6] = v;
      }
    }
  }
}

// spatial velocity (ω, v_O) of every couple or stiction contact link from
// its actor's generalized velocity
__device__ void link_velocities(const SceneTables& sc, const Ctx& c, float v6[][6]) {
  for (int b = 0; b < sc.nbody; ++b) {
    const int slot = sc.body_psi[b];
    if (slot < 0) continue;
    const int a = sc.body_actor[b], v0 = sc.actor_v0[a], nv = sc.actor_nv[a];
    const int mask = sc.body_vmask[b];
    for (int r = 0; r < 6; ++r) v6[slot][r] = 0.f;
    for (int j = 0; j < nv; ++j) {
      if (!((mask >> (v0 + j)) & 1)) continue;
      for (int r = 0; r < 6; ++r) v6[slot][r] += c.S[v0 + j][r] * c.u[v0 + j];
    }
  }
}

__device__ __forceinline__ float quad(const float* Kc, float floor, const float* d) {
  const float q = d[0] * d[0] * Kc[0] + d[1] * d[1] * Kc[3] + d[2] * d[2] * Kc[5]
                  + 2.f * (d[0] * d[1] * Kc[1] + d[0] * d[2] * Kc[2] + d[1] * d[2] * Kc[4]);
  return fmaxf(q, floor);
}

// Accumulators of one Jacobi pass: impulse and angular impulse per free
// actor, Plücker impulse Y per couple or stiction contact link.
struct Impulses {
  float dP[MAX_ACTORS][3], dT[MAX_ACTORS][3];
  float Y[MAX_PSI][6];
};

__device__ __forceinline__ void zero_impulses(Impulses& m) {
  for (int a = 0; a < MAX_ACTORS; ++a)
    for (int i = 0; i < 3; ++i) { m.dP[a][i] = 0.f; m.dT[a][i] = 0.f; }
  for (int p = 0; p < MAX_PSI; ++p)
    for (int i = 0; i < 6; ++i) m.Y[p][i] = 0.f;
}

// one block's summed contributions of per-sample impulses imp[s]
__device__ void block_contribs(const SceneTables& sc, const Sample& s0, const Swept& sw, int bi,
                               const float imp[][3], Impulses& m) {
  const int fl = sc.blk_flags[bi], S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
  for (int side = 0; side < 2; ++side) {
    if (!(fl & (side == 0 ? F_A_FREE : F_B_FREE))) continue;
    const int a = sc.body_actor[side == 0 ? sc.blk_ba[bi] : sc.blk_bb[bi]];
    const float sgn = side == 0 ? 1.f : -1.f;
    float p[3] = {0.f, 0.f, 0.f}, t[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      float si3[3], r[3], tq[3];
      for (int i = 0; i < 3; ++i) {
        si3[i] = imp[s][i] * sgn;
        r[i] = sw.pt[c0 + s][i] - s0.root[a][i];
      }
      cross3(r, si3, tq);
      for (int i = 0; i < 3; ++i) { p[i] += si3[i]; t[i] += tq[i]; }
    }
    for (int i = 0; i < 3; ++i) { m.dP[a][i] += p[i]; m.dT[a][i] += t[i]; }
  }
  if (fl & (F_A_ART | F_B_ART | F_A_STA | F_B_STA)) {
    const float sgn = (fl & (F_A_ART | F_A_STA)) ? 1.f : -1.f;
    float y[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      float si3[3], tq[3];
      for (int i = 0; i < 3; ++i) si3[i] = imp[s][i] * sgn;
      cross3(sw.pt[c0 + s], si3, tq);
      for (int i = 0; i < 3; ++i) { y[i] += tq[i]; y[3 + i] += si3[i]; }
    }
    float* Yb = m.Y[sc.body_psi[art_body_of(sc, bi)]];
    for (int i = 0; i < 6; ++i) Yb[i] += y[i];
  }
}

// Jacobi end-of-pass apply: free-body velocities, and the exact fold-back
// ΔU = M⁻¹ΦᵀY per articulated actor in the pass
__device__ void commit(const SceneTables& sc, const Impulses& m, const float* inv_m,
                       const float invIw[][9], Ctx& c) {
  for (int a = 0; a < sc.nactor; ++a) {
    if (sc.actor_dynamic[a] == ACTOR_FREE) {
      for (int i = 0; i < 3; ++i) {
        c.fv[a][i] += m.dP[a][i] * inv_m[a];
        c.fv[a][3 + i] += invIw[a][3 * i] * m.dT[a][0] + invIw[a][3 * i + 1] * m.dT[a][1]
                          + invIw[a][3 * i + 2] * m.dT[a][2];
      }
      continue;
    }
    if (!c.deferred[a]) continue;
    const int v0 = sc.actor_v0[a], nv = sc.actor_nv[a];
    float rhsY[MAX_V];
    for (int j = 0; j < nv; ++j) rhsY[j] = 0.f;
    for (int b = 0; b < sc.nbody; ++b) {
      const int slot = sc.body_psi[b];
      if (slot < 0 || sc.body_actor[b] != a) continue;
      const int mask = sc.body_vmask[b];
      for (int j = 0; j < nv; ++j) {
        if (!((mask >> (v0 + j)) & 1)) continue;
        float v = 0.f;
        for (int r = 0; r < 6; ++r) v += c.S[v0 + j][r] * m.Y[slot][r];
        rhsY[j] += v;
      }
    }
    chol_solve(c.L, v0, nv, MAX_V, rhsY, rhsY);
    for (int j = 0; j < nv; ++j) c.u[v0 + j] += rhsY[j];
  }
}

// velocity of body b at point p inside a sweep (frozen snapshot)
__device__ __forceinline__ void vel_at(const SceneTables& sc, const Sample& s0, const Kin& k,
                                       const Ctx& c, const float v6[][6], int b, const float* p,
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
__device__ void impulse_pass(const SceneTables& sc, Sample& s, const Kin& k, const float* mass,
                             const float* fric, int K, float dt, const Swept& sw, int sweeps,
                             bool world, Ctx& c) {
  const float dcap = sc.max_depth;
  const float tau_c = fmaxf(2.f * dt, 1e-3f);
  float inv_m[MAX_ACTORS], invIw[MAX_ACTORS][9];
  float cnt_body[MAX_ACTORS], cnt_act[MAX_ACTORS];
  for (int a = 0; a < sc.nactor; ++a) {
    cnt_body[a] = 0.f;
    cnt_act[a] = 0.f;
    if (sc.actor_dynamic[a] != ACTOR_FREE) continue;
    const float ms = fmaxf(mass[sc.actor_body0[a] * K], 1e-6f);
    inv_m[a] = sc.actor_invm[a] / ms;
    float R[3][3], RI[3][3];
    q_to_R(&s.root[a][3], R);
    const float* Ii = &sc.actor_iinv[9 * a];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) RI[i][j] = R[i][0] * Ii[j] + R[i][1] * Ii[3 + j] + R[i][2] * Ii[6 + j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        invIw[a][3 * i + j] = (RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2]) / ms;
  }

  // per-substep invariants: activity, friction, active-contact counts
  float act[MAX_CAND], mu_b[MAX_BLK];
  for (int bi = 0; bi < sc.nblk; ++bi) {
    const int fl = sc.blk_flags[bi];
    if (!(fl & F_SWEPT)) continue;
    const int S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
    const float fa = fric[sc.blk_ga[bi] * K];
    const float fb = (fl & F_HAS_B) ? fric[sc.blk_gb[bi] * K] : fa;
    mu_b[bi] = sc.blk_mu0[bi] * 0.5f * (fa + fb);
    float sum = 0.f;
    for (int q = 0; q < S; ++q) {
      act[c0 + q] = fminf(sw.depth[c0 + q], dcap) > 0.f ? 1.f : 0.f;
      sum += act[c0 + q];
    }
    if (fl & F_A_FREE) cnt_body[sc.body_actor[sc.blk_ba[bi]]] += sum;
    if (fl & F_B_FREE) cnt_body[sc.body_actor[sc.blk_bb[bi]]] += sum;
    if (is_two_way(sc, bi)) cnt_act[sc.body_actor[art_body_of(sc, bi)]] += sum;
  }

  // contact-space inverse mass per candidate, fixed within the substep
  float Kc[MAX_CAND][6], kn_c[MAX_CAND], floor_b[MAX_BLK], neff_b[MAX_BLK];
  for (int bi = 0; bi < sc.nblk; ++bi) {
    const int fl = sc.blk_flags[bi];
    if (!(fl & F_SWEPT)) continue;
    const int S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
    float ne = 0.f;
    if (fl & F_A_FREE) ne += cnt_body[sc.body_actor[sc.blk_ba[bi]]];
    if (fl & F_B_FREE) ne += cnt_body[sc.body_actor[sc.blk_bb[bi]]];
    if (is_two_way(sc, bi)) ne += cnt_act[sc.body_actor[art_body_of(sc, bi)]];
    neff_b[bi] = fmaxf(ne, 1.f);
    if (!sw.live[bi]) {
      floor_b[bi] = 1.f;
      for (int q = 0; q < S; ++q) {
        for (int i = 0; i < 6; ++i) Kc[c0 + q][i] = 0.f;
        kn_c[c0 + q] = 1.f;
      }
      continue;
    }
    float floor = 1e-9f;
    if (fl & F_A_FREE) floor += inv_m[sc.body_actor[sc.blk_ba[bi]]];
    if (fl & F_B_FREE) floor += inv_m[sc.body_actor[sc.blk_bb[bi]]];
    floor_b[bi] = floor;
    for (int q = 0; q < S; ++q) {
      const float* pt = sw.pt[c0 + q];
      float Km[3][3] = {{1e-9f, 0.f, 0.f}, {0.f, 1e-9f, 0.f}, {0.f, 0.f, 1e-9f}};
      for (int side = 0; side < 2; ++side) {
        if (!(fl & (side == 0 ? F_A_FREE : F_B_FREE))) continue;
        const int a = sc.body_actor[side == 0 ? sc.blk_ba[bi] : sc.blk_bb[bi]];
        const float r0 = pt[0] - s.root[a][0], r1 = pt[1] - s.root[a][1], r2 = pt[2] - s.root[a][2];
        const float sk[3][3] = {{0.f, -r2, r1}, {r2, 0.f, -r0}, {-r1, r0, 0.f}};
        const float* I2 = invIw[a];
        float T[3][3];
        for (int i = 0; i < 3; ++i) {
          T[i][0] = I2[3 * i + 1] * sk[1][0] + I2[3 * i + 2] * sk[2][0];
          T[i][1] = I2[3 * i + 0] * sk[0][1] + I2[3 * i + 2] * sk[2][1];
          T[i][2] = I2[3 * i + 0] * sk[0][2] + I2[3 * i + 1] * sk[1][2];
        }
        for (int x = 0; x < 3; ++x) {
          Km[x][x] += inv_m[a];
          const int i1 = x == 0 ? 1 : 0, i2 = x == 2 ? 1 : 2;
          for (int y = x; y < 3; ++y) Km[x][y] += sk[i1][x] * T[i1][y] + sk[i2][x] * T[i2][y];
        }
      }
      if (is_two_way(sc, bi)) {
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
      float* kc = Kc[c0 + q];
      kc[0] = Km[0][0]; kc[1] = Km[0][1]; kc[2] = Km[0][2];
      kc[3] = Km[1][1]; kc[4] = Km[1][2]; kc[5] = Km[2][2];
      kn_c[c0 + q] = quad(kc, floor, sw.nrm[c0 + q]);
    }
  }

  // warm start: re-apply the carried impulses on currently active samples
  Impulses m;
  zero_impulses(m);
  float imp[MAX_S][3];
  for (int bi = 0; bi < sc.nblk; ++bi) {
    if (!(sc.blk_flags[bi] & F_SWEPT)) continue;
    const int S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
    if (!sw.live[bi] || !world) {
      for (int q = 0; q < S; ++q)
        for (int i = 0; i < 4; ++i) s.lam[c0 + q][i] = 0.f;
      continue;
    }
    for (int q = 0; q < S; ++q) {
      float* l = s.lam[c0 + q];
      const float a_ = act[c0 + q];
      l[0] *= a_; l[1] *= a_; l[2] *= a_; l[3] *= a_;
      for (int i = 0; i < 3; ++i) imp[q][i] = sw.nrm[c0 + q][i] * l[0] + l[1 + i];
    }
    block_contribs(sc, s, sw, bi, imp, m);
  }
  if (world) commit(sc, m, inv_m, invIw, c);

  float v6[MAX_PSI][6];
  for (int it = 0; it < sweeps; ++it) {
    link_velocities(sc, c, v6);
    zero_impulses(m);
    for (int bi = 0; bi < sc.nblk; ++bi) {
      const int fl = sc.blk_flags[bi];
      if (!(fl & F_SWEPT) || !sw.live[bi]) continue;
      const int S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
      const float ne = neff_b[bi];
      for (int q = 0; q < S; ++q) {
        const int ci = c0 + q;
        const float* pt = sw.pt[ci];
        const float* n = sw.nrm[ci];
        float* l = s.lam[ci];
        const float depth = fminf(sw.depth[ci], dcap);
        const bool active = act[ci] > 0.f;
        const float target = fminf(SW_BETA * fmaxf(depth - SW_SLOP, 0.f) / dt, 0.5f);
        float v_rel[3], vb[3];
        vel_at(sc, s, k, c, v6, sc.blk_ba[bi], pt, v_rel);
        if (fl & F_HAS_B) {
          vel_at(sc, s, k, c, v6, sc.blk_bb[bi], pt, vb);
          for (int i = 0; i < 3; ++i) v_rel[i] -= vb[i];
        }
        const float vn = dot3(v_rel, n);
        const bool sta = fl & (F_A_STA | F_B_STA);
        const float ln0 = l[0];
        // stiction blocks are friction-only: the stiff penalty carries the
        // normal force, and λ_n is carried unchanged
        const float d_lam = active && !sta ? -(vn - target) / (kn_c[ci] * ne) * SW_RELAX : 0.f;
        const float new_lam = sta ? ln0 : fmaxf(ln0 + d_lam, 0.f);
        float vt[3], t_dir[3], lt_new[3];
        for (int i = 0; i < 3; ++i) vt[i] = v_rel[i] - n[i] * vn;
        const float vt_n = sqrtf(dot3(vt, vt) + 1e-9f);
        const float inv_vt = 1.f / vt_n;
        for (int i = 0; i < 3; ++i) t_dir[i] = vt[i] * inv_vt;
        const float k_t = quad(Kc[ci], floor_b[bi], t_dir);
        // friction-cone seed from the normal force the velocity solve applied
        float seed = 0.f;
        if (sta) {
          const float knc = sc.blk_kn[bi] / (tau_c * tau_c);
          seed = fmaxf(knc * fmaxf(depth, 0.f) - (2.f * sc.blk_kn[bi] / tau_c) * vn, 0.f);
        } else if (fl & (F_A_ART | F_B_ART)) {
          const float knc = sc.blk_kn[bi] / (tau_c * tau_c);
          const float kdc = kd_couple(sc, bi, mass, K, dt, tau_c);
          seed = fmaxf(knc * fmaxf(depth, 0.f) - (kdc + dt * knc) * vn, 0.f);
        } else if ((fl & F_HAS_B) && ((fl & F_A_FREE) != 0) != ((fl & F_B_FREE) != 0)) {
          seed = (sc.blk_kn[bi] / (tau_c * tau_c)) * fmaxf(depth, 0.f);
        }
        const float cap = mu_b[bi] * (new_lam + seed * dt);
        for (int i = 0; i < 3; ++i) lt_new[i] = l[1 + i] + (active ? -vt[i] / (k_t * ne) : 0.f);
        const float ltn = sqrtf(dot3(lt_new, lt_new) + 1e-9f);
        const float scl = fminf(1.f, cap / ltn);
        for (int i = 0; i < 3; ++i) {
          const float lp = lt_new[i] * scl;
          imp[q][i] = n[i] * (new_lam - ln0) + (lp - l[1 + i]);
          l[1 + i] = lp;
        }
        l[0] = new_lam;
      }
      block_contribs(sc, s, sw, bi, imp, m);
    }
    commit(sc, m, inv_m, invIw, c);
  }

  // stiction snap: one regularised 6×6 least-squares solve per free body
  // matching its rigid motion to the articulated side at every sticking
  // couple sample, clipped to ±SNAP_CLIP
  bool any_couple = false;
  for (int b = 0; b < sc.nbody; ++b) any_couple |= sc.body_psi[b] >= 0;
  if (!any_couple || !world) return;
  link_velocities(sc, c, v6);
  float A[MAX_ACTORS][36], bs[MAX_ACTORS][6];
  bool used[MAX_ACTORS];
  for (int a = 0; a < sc.nactor; ++a) {
    used[a] = false;
    for (int i = 0; i < 36; ++i) A[a][i] = 0.f;
    for (int i = 0; i < 6; ++i) bs[a][i] = 0.f;
  }
  for (int bi = 0; bi < sc.nblk; ++bi) {
    if (!is_couple(sc, bi)) continue;
    const int fl = sc.blk_flags[bi];
    const bool a_art = fl & F_A_ART;
    const int b_free = a_art ? sc.blk_bb[bi] : sc.blk_ba[bi];
    const int af = sc.body_actor[b_free];
    used[af] = true;
    if (!sw.live[bi]) continue;
    const int slot = sc.body_psi[art_body_of(sc, bi)];
    const float e_snap = a_art ? -1.f : 1.f;
    const float knc = sc.blk_kn[bi] / (tau_c * tau_c);
    const float kdc = kd_couple(sc, bi, mass, K, dt, tau_c);
    const int S = sc.blk_S[bi], c0 = sc.blk_c0[bi];
    float bA[36], bb6[6];
    for (int i = 0; i < 36; ++i) bA[i] = 0.f;
    for (int i = 0; i < 6; ++i) bb6[i] = 0.f;
    for (int q = 0; q < S; ++q) {
      const int ci = c0 + q;
      const float* pt = sw.pt[ci];
      const float* n = sw.nrm[ci];
      float r[3], cr[3], v_free[3], v_art[3], v_rel[3];
      for (int i = 0; i < 3; ++i) r[i] = pt[i] - s.root[af][i];
      cross3(&c.fv[af][3], r, cr);
      for (int i = 0; i < 3; ++i) v_free[i] = c.fv[af][i] + cr[i];
      cross3(v6[slot], pt, cr);
      for (int i = 0; i < 3; ++i) v_art[i] = v6[slot][3 + i] + cr[i];
      for (int i = 0; i < 3; ++i) v_rel[i] = a_art ? v_art[i] - v_free[i] : v_free[i] - v_art[i];
      const float vn_f = dot3(v_rel, n);
      const float fn_imp = fmaxf(knc * fmaxf(fminf(sw.depth[ci], dcap), 0.f) - (kdc + dt * knc) * vn_f, 0.f);
      const float cap_f = mu_b[bi] * (s.lam[ci][0] + fn_imp * dt);
      const float* lt = &s.lam[ci][1];
      const float lt_n = sqrtf(dot3(lt, lt));
      const float w_st = act[ci] * (lt_n < 0.98f * cap_f ? 1.f : 0.f);
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
      for (int i = 0; i < 6; ++i) {
        bb6[i] += w_st * (X[0][i] * Pv[0] + X[1][i] * Pv[1] + X[2][i] * Pv[2]);
        for (int j = 0; j < 6; ++j)
          bA[i * 6 + j] += w_st * (X[0][i] * PX[0][j] + X[1][i] * PX[1][j] + X[2][i] * PX[2][j]);
      }
    }
    for (int i = 0; i < 6; ++i) bs[af][i] += -bb6[i];
    for (int i = 0; i < 36; ++i) A[af][i] += bA[i];
  }
  for (int a = 0; a < sc.nactor; ++a) {
    if (!used[a]) continue;
    float Ar[36], Lr[36], xi[6];
    for (int i = 0; i < 36; ++i) Ar[i] = A[a][i] + (i % 7 == 0 ? 1e-4f : 0.f);
    chol_factor(Ar, Lr, 0, 6, 6);
    chol_solve(Lr, 0, 6, 6, bs[a], xi);
    for (int i = 0; i < 3; ++i) {
      c.fv[a][3 + i] += fminf(fmaxf(xi[i], -SNAP_CLIP), SNAP_CLIP);
      c.fv[a][i] += fminf(fmaxf(xi[3 + i], -SNAP_CLIP), SNAP_CLIP);
    }
  }
}
