// Contacts of the fused physics substep, per sample (one warp):
// broadphase gate, narrowphase of the cp, bp, cb, bbc, cc, bbA and bbB pair
// blocks, the side-asymmetric penalty law with the static side's soft
// report, and the hand-off of the swept blocks' point, normal and depth to
// the impulse pass.
//
// Replaces block_gate, block_geometry and contacts_lanes of
// mppiisaac_tpu/ops/pallas/fused_physics.py (82-118, 442-486, 498-617). The
// TPU kernel skipped a block when every lane of its tile was separated; here
// each sample skips its own separated blocks. Either way a gated-off block
// contributes exact zeros. The gate is written as !(separated), so a sample
// whose pose went NaN keeps its blocks live, as on the TPU.
// Plain twin: ops/fused_contacts.py.
#pragma once

#include "scene_tables.cuh"

__device__ __forceinline__ void geom_pose(const SceneTables& sc, const Kin& k, int g, float* gp,
                                          float* gq) {
  const int b = sc.geom_body[g];
  qrot(k.quat[b], &sc.geom_pos[3 * g], gp);
  for (int i = 0; i < 3; ++i) gp[i] += k.pos[b][i];
  qmul(k.quat[b], &sc.geom_quat[4 * g], gq);
}

// capsule (or sphere) axis end points; returns the radius
__device__ __forceinline__ float geom_segment(const SceneTables& sc, const Kin& k, int g, float* p0,
                                              float* p1) {
  float gp[3], gq[4], axis[3];
  const float ez[3] = {0.f, 0.f, 1.f};
  geom_pose(sc, k, g, gp, gq);
  qrot(gq, ez, axis);
  const float hl = sc.geom_type[g] == GEOM_CAPSULE ? sc.geom_size[3 * g + 1] : 0.f;
  for (int i = 0; i < 3; ++i) {
    p0[i] = gp[i] + axis[i] * (-hl);
    p1[i] = gp[i] + axis[i] * hl;
  }
  return sc.geom_size[3 * g];
}

// closest feature of a point against a box (lanes _point_to_box_lanes):
// world normal, depth (> 0 inside), world surface point
__device__ void point_to_box(const float* point, const float* bp, const float* bq,
                             const float* half, float* n_w, float* depth, float* surf) {
  float d[3], lp[3], cl[3], ov[3], fd[3], n_in[3], n_loc[3], s_loc[3], r[3];
  for (int i = 0; i < 3; ++i) d[i] = point[i] - bp[i];
  qrot_inv(bq, d, lp);
  for (int i = 0; i < 3; ++i) {
    cl[i] = fmaxf(fminf(lp[i], half[i]), -half[i]);
    ov[i] = lp[i] - cl[i];
    fd[i] = half[i] - fabsf(lp[i]);
  }
  const float od = sqrtf(dot3(ov, ov));
  const bool is_out = od > 1e-9f;
  const float dmin = fminf(fminf(fd[0], fd[1]), fd[2]);
  const bool sel0 = fd[0] <= fminf(fd[1], fd[2]);
  const bool sel1 = !sel0 && (fd[1] <= fd[2]);
  const bool sel2 = !(sel0 || sel1);
  const bool sel[3] = {sel0, sel1, sel2};
  const float inv_od = 1.f / fmaxf(od, 1e-9f);
  for (int i = 0; i < 3; ++i) {
    const float sg = lp[i] > 0.f ? 1.f : (lp[i] < 0.f ? -1.f : 0.f);
    n_in[i] = sel[i] ? sg : 0.f;
    n_loc[i] = is_out ? ov[i] * inv_od : n_in[i];
    s_loc[i] = is_out ? cl[i] : lp[i] + n_in[i] * dmin;
  }
  *depth = is_out ? -od : dmin;
  qrot(bq, n_loc, n_w);
  qrot(bq, s_loc, r);
  for (int i = 0; i < 3; ++i) surf[i] = bp[i] + r[i];
}

// closest points of segments p0p1 and q0q1 (lanes _segment_closest_lanes);
// either segment may be a point
__device__ void segment_closest(const float* p0, const float* p1, const float* q0, const float* q1,
                                float* cp, float* cq) {
  const float eps = 1e-9f;
  float d1[3], d2[3], r[3];
  for (int i = 0; i < 3; ++i) { d1[i] = p1[i] - p0[i]; d2[i] = q1[i] - q0[i]; r[i] = p0[i] - q0[i]; }
  const float a = dot3(d1, d1), e = dot3(d2, d2), f = dot3(d2, r);
  const float c = dot3(d1, r), b = dot3(d1, d2);
  const float denom = a * e - b * b;
  float s = denom > eps ? fminf(fmaxf((b * f - c * e) / fmaxf(denom, eps), 0.f), 1.f) : 0.f;
  const float t = e > eps ? fminf(fmaxf((b * s + f) / fmaxf(e, eps), 0.f), 1.f) : 0.f;
  s = a > eps ? fminf(fmaxf((b * t - c) / fmaxf(a, eps), 0.f), 1.f) : 0.f;
  for (int i = 0; i < 3; ++i) { cp[i] = p0[i] + d1[i] * s; cq[i] = q0[i] + d2[i] * t; }
}

// "possibly in contact" (block_gate)
__device__ bool block_gate(const SceneTables& sc, const Kin& k, int bi) {
  const int fl = sc.blk_flags[bi];
  const float* ca = k.pos[sc.blk_ba[bi]];
  const float thr = sc.blk_thr[bi];
  if (!(fl & F_HAS_B)) return !(ca[2] > thr);
  const int bb = sc.blk_bb[bi];
  float d[3];
  for (int i = 0; i < 3; ++i) d[i] = ca[i] - k.pos[bb][i];
  if (fl & F_SLAB) {
    const int gb = sc.blk_gb[bi];
    float db[3], e[3];
    qrot_inv(k.quat[bb], d, db);
    for (int i = 0; i < 3; ++i)
      e[i] = fmaxf(fabsf(db[i] - sc.geom_pos[3 * gb + i]) - sc.geom_size[3 * gb + i], 0.f);
    return !(e[0] * e[0] + e[1] * e[1] + e[2] * e[2] > thr);
  }
  return !(dot3(d, d) > thr);
}

// point, normal, depth of manifold sample s of block bi (block_geometry)
__device__ void block_sample(const SceneTables& sc, const Kin& k, int bi, int s, float* point,
                             float* normal, float* depth) {
  const int kind = sc.blk_kind[bi];
  const int ga = sc.blk_ga[bi], gb = sc.blk_gb[bi];
  if (kind == KIND_CP) {
    float p0[3], p1[3];
    const float r = geom_segment(sc, k, ga, p0, p1);
    const float* pe = s == 0 ? p0 : p1;
    point[0] = pe[0]; point[1] = pe[1]; point[2] = pe[2] - r;
    normal[0] = 0.f; normal[1] = 0.f; normal[2] = 1.f;
    *depth = r - pe[2];
    return;
  }
  if (kind == KIND_CB) {
    float p0[3], p1[3], sp[3], gp[4], gq[4];
    const float r = geom_segment(sc, k, ga, p0, p1);
    geom_pose(sc, k, gb, gp, gq);
    if (s == 0) {
      for (int i = 0; i < 3; ++i) sp[i] = p0[i];
    } else if (s == 1) {
      for (int i = 0; i < 3; ++i) sp[i] = p1[i];
    } else {
      float unused[3];
      segment_closest(p0, p1, gp, gp, sp, unused);
    }
    float dc;
    point_to_box(sp, gp, gq, &sc.geom_size[3 * gb], normal, &dc, point);
    *depth = dc + r;
    return;
  }
  if (kind == KIND_CC) {
    // one sample: the closest points of the two axes (a sphere's axis is a
    // point), the normal from b to a, the point midway into the overlap
    float pa0[3], pa1[3], pb0[3], pb1[3], ca[3], cb[3], delta[3];
    const float ra = geom_segment(sc, k, ga, pa0, pa1);
    const float rb = geom_segment(sc, k, gb, pb0, pb1);
    segment_closest(pa0, pa1, pb0, pb1, ca, cb);
    for (int i = 0; i < 3; ++i) delta[i] = ca[i] - cb[i];
    const float dist = sqrtf(dot3(delta, delta));
    const float inv = 1.f / fmaxf(dist, 1e-9f);
    const float d = (ra + rb) - dist;
    const float off = rb - 0.5f * fmaxf(d, 0.f);
    for (int i = 0; i < 3; ++i) {
      normal[i] = delta[i] * inv;
      point[i] = cb[i] + normal[i] * off;
    }
    *depth = d;
    return;
  }
  // bp / bbc / bbA: a box sample of ga (against the ground, or box gb);
  // bbB: a box sample of gb against box ga, its normal turned to point from
  // b to a
  const int gs = kind == KIND_BBB ? gb : ga, gh = kind == KIND_BBB ? ga : gb;
  float gp[3], gq[4], off[3], w[3], pt[3];
  geom_pose(sc, k, gs, gp, gq);
  const int o = sc.blk_sc[bi], S = sc.blk_S[bi];
  for (int i = 0; i < 3; ++i) off[i] = sc.sconst[o + i * S + s];
  qrot(gq, off, w);
  for (int i = 0; i < 3; ++i) pt[i] = gp[i] + w[i];
  if (kind == KIND_BP) {
    for (int i = 0; i < 3; ++i) point[i] = pt[i];
    normal[0] = 0.f; normal[1] = 0.f; normal[2] = 1.f;
    *depth = -pt[2];
    return;
  }
  float gph[3], gqh[4];
  geom_pose(sc, k, gh, gph, gqh);
  point_to_box(pt, gph, gqh, &sc.geom_size[3 * gh], normal, depth, point);
  if (kind == KIND_BBB)
    for (int i = 0; i < 3; ++i) normal[i] = -normal[i];
}

__device__ __forceinline__ void point_vel(const Kin& k, int b, const float* p, float* v) {
  float d[3], c[3];
  for (int i = 0; i < 3; ++i) d[i] = p[i] - k.pos[b][i];
  cross3(k.angv[b], d, c);
  for (int i = 0; i < 3; ++i) v[i] = k.linv[b][i] + c[i];
}

// fn, ft_s of the penalty law at one sample (contacts_lanes force_with)
__device__ __forceinline__ void penalty(float kn_base, float tau_c, float mu, float depth,
                                        float dcap, float vn, const float* vt, float eps_v,
                                        const float* normal, float* f) {
  const float kn = kn_base / (tau_c * tau_c);
  const float kd = 2.f * kn_base / tau_c;
  const float fn = depth > 0.f ? fmaxf(kn * fminf(depth, dcap) - kd * vn, 0.f) : 0.f;
  const float vt_norm = sqrtf(dot3(vt, vt));
  const float ft = -(mu * fn / fmaxf(vt_norm, eps_v));
  for (int i = 0; i < 3; ++i) f[i] = normal[i] * fn + vt[i] * ft;
}

// One sample's contacts by its warp. fric: this sample's geom friction
// scales, stride K. Lanes run over the blocks for the gates, then over the
// contact chunks (32 lanes of whole emitting or swept blocks), one candidate
// each; each block's force and torque sums on its two sides are segmented
// scans over its lanes (bsum: 12 per block), added to the bodies by lanes
// over the bodies, each over its own blocks in block order (cb_start).
AB_TEMPLATE __device__ void contacts(const SceneTables& sc, const Kin& k, const float* fric, int K,
                                     float dt_sub, float plk_n[][3], float plk_f[][3],
                                     float ncf[][3], Swept& sw, float (*bsum)[12], int lane) {
  const float tau_c = fmaxf(2.f * dt_sub, 1e-3f);
  for (int b = lane; b < sc.nbody; b += 32)
    for (int i = 0; i < 3; ++i) { plk_n[b][i] = 0.f; plk_f[b][i] = 0.f; ncf[b][i] = 0.f; }
  for (int bi = lane; bi < sc.nblk; bi += 32) {
    const int fl = sc.blk_flags[bi];
    sw.live[bi] = (fl & (F_EMIT_A | F_EMIT_B | F_SWEPT))
                      ? (int)AB_OR(AB_NO_GATE, block_gate(sc, k, bi)) : 0;
  }
  __syncwarp();
  for (int ch = 0; ch < sc.n_ck; ++ch) {
    const int bi = sc.ck_blk[ch * 32 + lane];
    float v[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = 0.f;
    int seg0 = lane, s = -1;
    if (bi != 255) {
      seg0 = sc.blk_lane0[bi];
      s = lane - seg0;
      const int fl = sc.blk_flags[bi];
      const bool emit_a = fl & F_EMIT_A, emit_b = fl & F_EMIT_B, swept = fl & F_SWEPT;
      const int ba = sc.blk_ba[bi], bb = sc.blk_bb[bi], c = sc.blk_c0[bi] + s;
      const bool live = sw.live[bi];
      if (swept && !live) {
        const bool static_n = sc.blk_kind[bi] == KIND_CP || sc.blk_kind[bi] == KIND_BP;
        for (int i = 0; i < 3; ++i) {
          sw.pt[c][i] = 0.f;
          sw.nrm[c][i] = static_n && i == 2 ? 1.f : 0.f;
        }
        sw.depth[c] = 0.f;
      }
      if (live) {
        const float fa = fric[sc.blk_ga[bi] * K];
        const float fb = (fl & F_HAS_B) ? fric[sc.blk_gb[bi] * K] : fa;
        const float mu = sc.blk_mu0[bi] * 0.5f * (fa + fb);
        const float kn_a = sc.blk_kn_a[bi], kn_b = sc.blk_kn_b[bi];
        float point[3], normal[3], depth;
        block_sample(sc, k, bi, s, point, normal, &depth);
        if (swept) {
          for (int i = 0; i < 3; ++i) { sw.pt[c][i] = point[i]; sw.nrm[c][i] = normal[i]; }
          sw.depth[c] = depth;
        }
        if (emit_a || emit_b) {
          float v_rel[3], vb[3], vt[3], f[3], tq[3];
          point_vel(k, ba, point, v_rel);
          if (fl & F_HAS_B) {
            point_vel(k, bb, point, vb);
            for (int i = 0; i < 3; ++i) v_rel[i] -= vb[i];
          }
          const float vn = dot3(v_rel, normal);
          for (int i = 0; i < 3; ++i) vt[i] = v_rel[i] - normal[i] * vn;
          penalty(kn_a, tau_c, mu, depth, sc.max_depth, vn, vt, sc.eps_v, normal, f);
          if (emit_a) {
            cross3(point, f, tq);
            for (int i = 0; i < 3; ++i) { v[i] = f[i]; v[3 + i] = tq[i]; }
          }
          if (emit_b) {
            if (kn_b != kn_a) penalty(kn_b, tau_c, mu, depth, sc.max_depth, vn, vt, sc.eps_v, normal, f);
            cross3(point, f, tq);
            for (int i = 0; i < 3; ++i) { v[6 + i] = f[i]; v[9 + i] = tq[i]; }
          }
        }
      }
    }
    seg_scan<12>(v, lane, seg0);
    if (bi != 255 && s == sc.blk_S[bi] - 1)
      for (int i = 0; i < 12; ++i) bsum[bi][i] = v[i];
  }
  __syncwarp();
  for (int b = lane; b < sc.nbody; b += 32) {
    for (int e = sc.cb_start[b]; e < sc.cb_start[b + 1]; ++e) {
      const int bi = sc.cb_ent[e] >> 1;
      if (!sw.live[bi]) continue;
      const float* t = bsum[bi];
      if (!(sc.cb_ent[e] & 1))
        for (int i = 0; i < 3; ++i) { plk_n[b][i] += t[3 + i]; plk_f[b][i] += t[i]; ncf[b][i] += t[i]; }
      else
        for (int i = 0; i < 3; ++i) { plk_n[b][i] -= t[9 + i]; plk_f[b][i] -= t[6 + i]; ncf[b][i] -= t[6 + i]; }
    }
  }
  __syncwarp();
}
