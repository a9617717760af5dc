# Frozen copy of mppiisaac_tpu_torch/ops/fused_impulse.py, part of the benchmark's yardstick.
"""Couple terms, operational inverse inertias, impulse sweeps and the
stiction snap of the fused physics substep: the plain PyTorch twin of
csrc/impulse.cuh, batched over a leading sample axis K.

Counterpart of the second half of the JAX package's
`ops/pallas/fused_physics.py` `dynamics_lanes`:

* `couple_terms` — the implicit Baraff JᵀJ terms of articulated↔free
  (couple: grasp, push) contacts in the articulated velocity solve, with the
  damper cap;
* `psi_blocks` — Ψ_b = Φ_b M⁻¹ Φ_bᵀ per contact link of a couple or a
  stiction block (a floating base's link against a static geom), from the
  live Cholesky factor;
* `impulse_pass` — the mass-splitting Jacobi sweeps (relax 0.9, β 0.2,
  slop 2e-3) with the vector friction cone, warm-started from the λ rows,
  impulses applied at the END of each sweep from a frozen velocity snapshot,
  the two-way fold-back ΔU = M⁻¹ΦᵀY for the articulated side (stiction
  blocks: friction only, their λ_n carried unchanged), and the
  world-fidelity stiction snap of the couple contacts (one 6×6
  least-squares solve per free body, clipped to ±0.05). At fast fidelity
  the sweeps start from zero and there is no snap.

The articulated side is indexed by velocity coordinate (base, then dofs;
see ops/fused_physics.py).

Vectors are (K,3) or (K,S,3) tensors, per-sample scalars (K,) or (K,S).
Every gated region's output is replaced by exact zeros where its block's
gate is off, as the TPU kernel's `lax.cond` did.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..physics.math3d import cholesky_factor, cholesky_solve_factored, cross, dot, quat_to_matrix
from ..physics.stacked import DAMP_CAP_BETA
from .fused_contacts import (
    F_A_ART,
    F_A_FREE,
    F_A_STA,
    F_B_ART,
    F_B_FREE,
    F_B_STA,
    F_HAS_B,
    SweptGeo,
    block_live_or,
)

BETA, SLOP, RELAX = 0.2, 2e-3, 0.9
SNAP_CLIP = 0.05


def _sub_coords(ks, b: int, v0: int, nv: int) -> List[int]:
    """Local velocity coordinates of the actor (first coordinate `v0`) that
    move body b."""
    m = int(ks.body_vmask[b])
    return [j for j in range(nv) if (m >> (v0 + j)) & 1]


def _is_couple(ks, bi: int) -> bool:
    return bool(int(ks.blk_flags[bi]) & (F_A_ART | F_B_ART))


def _is_sta(ks, bi: int) -> bool:
    return bool(int(ks.blk_flags[bi]) & (F_A_STA | F_B_STA))


def _two_way(ks, bi: int) -> bool:
    """A couple or stiction block: its articulated side takes part in the
    sweeps through Ψ."""
    return _is_couple(ks, bi) or _is_sta(ks, bi)


def _art_body(ks, bi: int) -> int:
    return int(ks.blk_ba[bi]) if int(ks.blk_flags[bi]) & (F_A_ART | F_A_STA) else int(ks.blk_bb[bi])


def _kd_couple(ks, bi: int, mass, dt: float, tau_c: float):
    """Couple damper capped at the free side's momentum-transfer scale."""
    kn = float(ks.blk_kn[bi])
    cap = DAMP_CAP_BETA * float(ks.blk_m_oth[bi]) * mass[:, int(ks.blk_ob[bi])] \
        / (dt * float(ks.blk_npts[bi]))
    return torch.clamp(cap, max=2.0 * kn / tau_c)


def couple_terms(ks, geos: List[SweptGeo], S, v0: int, nv: int, pos, linv, angv, mass, dt,
                 rhs: List[torch.Tensor], Ms: torch.Tensor):
    """Add the implicit couple-contact terms of one actor's couple blocks:
    M += dt(kd+κ)·JᵀJ, rhs += dt·Jᵀ(e·kn·d⁺ + (kd+κ)·v_oth_n), J_j = X·S_j.
    rhs (list of (K,)) and Ms (K,nd,nd) are updated in place."""
    tau_c = max(2.0 * dt, 1e-3)
    for geo in geos:
        bi = geo.blk
        a_art = bool(int(ks.blk_flags[bi]) & F_A_ART)
        e = 1.0 if a_art else -1.0
        sub = _sub_coords(ks, _art_body(ks, bi), v0, nv)
        pt, n = geo.point, geo.normal
        depth_c = torch.clamp(geo.depth, max=ks.max_depth)
        act = (depth_c > 0.0).to(pt.dtype)
        X6 = torch.cat([cross(pt, n), n], -1)
        Jc = {j: (X6 * S[j][:, None, :]).sum(-1) for j in sub}
        kn = float(ks.blk_kn[bi])
        kn_c = kn / (tau_c * tau_c)
        kd_c = _kd_couple(ks, bi, mass, dt, tau_c)[:, None]
        kap = dt * kn_c
        ob = int(ks.blk_ob[bi])
        v_oth = linv[ob][:, None] + cross(angv[ob][:, None], pt - pos[ob][:, None])
        v_oth_n = dot(v_oth, n)
        coefM = dt * (kd_c + kap) * act
        coefR = dt * (e * kn_c * torch.clamp(depth_c, min=0.0) + (kd_c + kap) * v_oth_n) * act
        for i in sub:
            rhs[i] = rhs[i] + block_live_or(geo.live, (coefR * Jc[i]).sum(1))
            MJi = coefM * Jc[i]
            for j in sub:
                if j < i:
                    continue
                v = block_live_or(geo.live, (MJi * Jc[j]).sum(1))
                Ms[:, i, j] = Ms[:, i, j] + v
                if j != i:
                    Ms[:, j, i] = Ms[:, j, i] + v


def psi_blocks(ks, bodies: List[int], S, Lc, v0: int, nv: int) -> Dict[int, torch.Tensor]:
    """Ψ_b (K,6,6) per contact link b from the factor Lc of the actor's
    velocity-solve matrix."""
    ref = S[0]
    out = {}
    for b in bodies:
        sub = _sub_coords(ks, b, v0, nv)
        cols = []
        for c6 in range(6):
            col = [S[j][:, c6] if j in sub else torch.zeros_like(ref[:, 0]) for j in range(nv)]
            xs = cholesky_solve_factored(Lc, torch.stack(col, -1)).unbind(-1)
            acc = torch.zeros_like(ref)
            for j in sub:
                acc = acc + S[j] * xs[j][:, None]
            cols.append(acc)
        out[b] = torch.stack(cols, -1)                     # [:, r, c6]
    return out


def _skew(r):
    """skew(r) entries as nested lists; the diagonal is exactly zero."""
    z = torch.zeros_like(r[..., 0])
    return [[z, -r[..., 2], r[..., 1]], [r[..., 2], z, -r[..., 0]], [-r[..., 1], r[..., 0], z]]


def _quad(Kc, floor, d):
    """max(dᵀKd, floor) for the per-sample contact-space inverse mass K."""
    q = (d[..., 0] * d[..., 0] * Kc[0][0] + d[..., 1] * d[..., 1] * Kc[1][1]
         + d[..., 2] * d[..., 2] * Kc[2][2]
         + 2.0 * (d[..., 0] * d[..., 1] * Kc[0][1] + d[..., 0] * d[..., 2] * Kc[0][2]
                  + d[..., 1] * d[..., 2] * Kc[1][2]))
    return torch.maximum(q, floor)


def impulse_pass(ks, swept: List[SweptGeo], st, pos, linv, angv, mass, fric, dt: float,
                 sweeps: int, free_vel: Dict[int, list], art_ctx: Dict[int, dict], lam,
                 two_way_sweeps: bool = True):
    """The in-kernel impulse pass of one substep.

    st: the substep's input state (root poses of the free bodies before
    integration); free_vel: {actor: [linvel, angvel]} of the free bodies
    after the velocity solve (updated in place); art_ctx: {actor: ctx} of
    articulated actors with couple or stiction blocks (ctx["u"] updated in
    place);
    lam (K, n_fc, 4) the warm-start λ rows, or None at fast fidelity: the
    sweeps start from zero and the stiction snap is left out. → λ rows
    after the sweeps (None at fast fidelity).

    two_way_sweeps=False (a profiling ablation, the JAX package's
    TWO_WAY_SWEEPS off) leaves the articulated side out of the sweeps: no Ψ
    in the inverse masses, the free-side friction seed on couple blocks, no
    impulse folded back into the articulation."""
    dcap = ks.max_depth
    tau_c = max(2.0 * dt, 1e-3)
    ref = pos[0]
    K = ref.shape[0]
    body2actor = {int(ks.actor_body0[a]): a for a in free_vel}
    inv_m, invIw = {}, {}
    for a in free_vel:
        b = int(ks.actor_body0[a])
        ms = torch.clamp(mass[:, b], min=1e-6)
        inv_m[b] = float(ks.actor_invm[a]) / ms
        R = quat_to_matrix(st["root_quat"][:, a])
        Iinv = torch.as_tensor(ks.actor_iinv[a], dtype=ref.dtype, device=ref.device).reshape(3, 3)
        invIw[b] = (R @ Iinv @ R.transpose(-1, -2)) / ms[:, None, None]
    body_art = {}
    for aid, ctx in art_ctx.items():
        for b in ctx["bodies"]:
            body_art[b] = aid

    nb = len(swept)
    act, mu, c0s = [], [], []
    for geo in swept:
        bi = geo.blk
        act.append((torch.clamp(geo.depth, max=dcap) > 0.0).to(ref.dtype))
        fa = fric[:, int(ks.blk_ga[bi])]
        fb = fric[:, int(ks.blk_gb[bi])] if int(ks.blk_flags[bi]) & F_HAS_B else fa
        mu.append(float(ks.blk_mu0[bi]) * 0.5 * (fa + fb))
        c0s.append(int(ks.blk_c0[bi]))

    def free_sides(bi):
        fl = int(ks.blk_flags[bi])
        out = []
        if fl & F_A_FREE:
            out.append((int(ks.blk_ba[bi]), 1.0))
        if fl & F_B_FREE:
            out.append((int(ks.blk_bb[bi]), -1.0))
        return out

    count_body: Dict[int, torch.Tensor] = {}
    count_act: Dict[int, torch.Tensor] = {}
    for si, geo in enumerate(swept):
        s_ = act[si].sum(1)
        for b, _ in free_sides(geo.blk):
            count_body[b] = count_body.get(b, 0.0) + s_
        if _two_way(ks, geo.blk):
            aid = body_art[_art_body(ks, geo.blk)]
            count_act[aid] = count_act.get(aid, 0.0) + s_

    # contact-space inverse mass per sample, fixed within the substep
    Kcache, floors, kncache, neff = [], [], [], []
    for si, geo in enumerate(swept):
        bi, pt = geo.blk, geo.point
        Kc = [[torch.full_like(pt[..., 0], 1e-9 if i == j else 0.0) for j in range(3)] for i in range(3)]
        floor = 1e-9
        for b, _ in free_sides(bi):
            a = body2actor[b]
            sk = _skew(pt - st["root_pos"][:, a, None])
            I2 = invIw[b][:, None]                              # (K,1,3,3)
            T = [[I2[..., i, 1] * sk[1][0] + I2[..., i, 2] * sk[2][0],
                  I2[..., i, 0] * sk[0][1] + I2[..., i, 2] * sk[2][1],
                  I2[..., i, 0] * sk[0][2] + I2[..., i, 1] * sk[1][2]] for i in range(3)]
            for a_ in range(3):
                Kc[a_][a_] = Kc[a_][a_] + inv_m[b][:, None]
                for b3 in range(a_, 3):
                    i1, i2 = [i for i in range(3) if i != a_]
                    Kc[a_][b3] = Kc[a_][b3] + (sk[i1][a_] * T[i1][b3] + sk[i2][a_] * T[i2][b3])
            floor = floor + inv_m[b]
        if _two_way(ks, bi) and two_way_sweeps:
            b2 = _art_body(ks, bi)
            psi = art_ctx[body_art[b2]]["psi"][b2][:, None]        # (K,1,6,6)
            P = _skew(pt)
            V = [[psi[..., r, 1] * P[1][0] + psi[..., r, 2] * P[2][0] + psi[..., r, 3],
                  psi[..., r, 0] * P[0][1] + psi[..., r, 2] * P[2][1] + psi[..., r, 4],
                  psi[..., r, 0] * P[0][2] + psi[..., r, 1] * P[1][2] + psi[..., r, 5]]
                 for r in range(6)]
            for a_ in range(3):
                i1, i2 = [i for i in range(3) if i != a_]
                for b3 in range(a_, 3):
                    Kc[a_][b3] = Kc[a_][b3] + (P[i1][a_] * V[i1][b3] + P[i2][a_] * V[i2][b3]
                                               + V[3 + a_][b3])
        for a_ in range(3):
            for b3 in range(a_ + 1, 3):
                Kc[b3][a_] = Kc[a_][b3]
        if not torch.is_tensor(floor):
            floor = torch.full((K,), floor, dtype=ref.dtype, device=ref.device)
        kn_ = _quad(Kc, floor[:, None], geo.normal)
        # gated-off samples: K = 0, floor = 1, k_n = 1 (their impulses are
        # exactly zero; the floor keeps the divisions finite)
        lv = geo.live[:, None]
        Kcache.append([[torch.where(lv, Kc[i][j], 0.0) for j in range(3)] for i in range(3)])
        floors.append(torch.where(geo.live, floor, 1.0))
        kncache.append(torch.where(lv, kn_, 1.0))
        ne = 0.0
        for b, _ in free_sides(bi):
            ne = ne + count_body[b]
        if _two_way(ks, bi):
            ne = ne + count_act[body_art[_art_body(ks, bi)]]
        neff.append(torch.clamp(ne, min=1.0) if torch.is_tensor(ne)
                    else torch.full((K,), max(ne, 1.0), dtype=ref.dtype, device=ref.device))

    def fn_seed(si, vn):
        bi, depth = swept[si].blk, torch.clamp(swept[si].depth, max=dcap)
        kn = float(ks.blk_kn[bi])
        fl = int(ks.blk_flags[bi])
        if _is_sta(ks, bi):
            return torch.clamp((kn / (tau_c * tau_c)) * torch.clamp(depth, min=0.0)
                               - (2.0 * kn / tau_c) * vn, min=0.0)
        if _is_couple(ks, bi) and two_way_sweeps:
            kn_c = kn / (tau_c * tau_c)
            kd_c = _kd_couple(ks, bi, mass, dt, tau_c)[:, None]
            return torch.clamp(kn_c * torch.clamp(depth, min=0.0) - (kd_c + dt * kn_c) * vn, min=0.0)
        if fl & F_HAS_B and bool(fl & F_A_FREE) != bool(fl & F_B_FREE):
            return (kn / (tau_c * tau_c)) * torch.clamp(depth, min=0.0)
        return 0.0

    def contribs(si, imp):
        """(free-side (actor, Δp, Δτ) list, art-side (body, Y (K,6)) or None),
        zero where the block's gate is off."""
        geo = swept[si]
        bi, pt, live = geo.blk, geo.point, geo.live
        fr = []
        for b, sgn in free_sides(bi):
            a = body2actor[b]
            si3 = imp * sgn
            r = pt - st["root_pos"][:, a, None]
            fr.append((a, block_live_or(live, si3.sum(1)), block_live_or(live, cross(r, si3).sum(1))))
        art = None
        if _two_way(ks, bi) and two_way_sweeps:
            si3 = imp * (1.0 if int(ks.blk_flags[bi]) & (F_A_ART | F_A_STA) else -1.0)
            Y = torch.cat([cross(pt, si3).sum(1), si3.sum(1)], -1)
            art = (_art_body(ks, bi), block_live_or(live, Y))
        return fr, art

    def commit(parts, rlv, rav, ubys):
        dP = {a: 0.0 for a in free_vel}
        dT = {a: 0.0 for a in free_vel}
        Yb = {b: 0.0 for b in body_art}
        for fr, art in parts:
            for a, p, t in fr:
                dP[a] = dP[a] + p
                dT[a] = dT[a] + t
            if art is not None:
                Yb[art[0]] = Yb[art[0]] + art[1]
        for a in free_vel:
            b = int(ks.actor_body0[a])
            if torch.is_tensor(dP[a]):
                rlv[a] = rlv[a] + dP[a] * inv_m[b][:, None]
                rav[a] = rav[a] + (invIw[b] @ dT[a][..., None])[..., 0]
        for aid, ctx in art_ctx.items():
            S, v0, nv = ctx["S"], ctx["v0"], ctx["nv"]
            rhsY = [torch.zeros_like(ref[:, 0]) for _ in range(nv)]
            for b in ctx["bodies"]:
                if not torch.is_tensor(Yb[b]):
                    continue
                for j in _sub_coords(ks, b, v0, nv):
                    rhsY[j] = rhsY[j] + (S[j] * Yb[b]).sum(-1)
            dU = cholesky_solve_factored(ctx["L"], torch.stack(rhsY, -1)).unbind(-1)
            ubys[aid] = [ubys[aid][j] + dU[j] for j in range(nv)]

    def v6_of(ubys):
        v6 = {}
        for aid, ctx in art_ctx.items():
            for b in ctx["bodies"]:
                acc = torch.zeros_like(ref.new_zeros(K, 6))
                for j in _sub_coords(ks, b, ctx["v0"], ctx["nv"]):
                    acc = acc + ctx["S"][j] * ubys[aid][j][:, None]
                v6[b] = acc
        return v6

    # warm start: re-apply the carried impulses on currently active samples
    rlv = {a: v[0] for a, v in free_vel.items()}
    rav = {a: v[1] for a, v in free_vel.items()}
    ubys = {aid: list(ctx["u"]) for aid, ctx in art_ctx.items()}
    lam_n, lam_t, parts = [], [], []
    for si, geo in enumerate(swept):
        if lam is None:
            lam_n.append(torch.zeros_like(geo.depth))
            lam_t.append(torch.zeros_like(geo.point))
            continue
        c0, S_ = c0s[si], geo.depth.shape[1]
        lnw = lam[:, c0:c0 + S_, 0] * act[si]
        ltw = lam[:, c0:c0 + S_, 1:4] * act[si][..., None]
        imp = geo.normal * lnw[..., None] + ltw
        lam_n.append(block_live_or(geo.live, lnw))
        lam_t.append(block_live_or(geo.live, ltw))
        parts.append(contribs(si, imp))
    if lam is not None:
        commit(parts, rlv, rav, ubys)

    for _ in range(sweeps):
        v6 = v6_of(ubys)

        def vel_at(b, point):
            if b in body2actor:
                a = body2actor[b]
                return rlv[a][:, None] + cross(rav[a][:, None], point - st["root_pos"][:, a, None])
            if b in v6:
                return v6[b][:, None, 3:6] + cross(v6[b][:, None, 0:3], point)
            return linv[b][:, None] + cross(angv[b][:, None], point - pos[b][:, None])

        parts = []
        for si, geo in enumerate(swept):
            bi, pt, n = geo.blk, geo.point, geo.normal
            ln0, lt0 = lam_n[si], lam_t[si]
            depth = torch.clamp(geo.depth, max=dcap)
            active = act[si] > 0.0
            target = torch.clamp(BETA * torch.clamp(depth - SLOP, min=0.0) / dt, max=0.5)
            v_rel = vel_at(int(ks.blk_ba[bi]), pt)
            if int(ks.blk_flags[bi]) & F_HAS_B:
                v_rel = v_rel - vel_at(int(ks.blk_bb[bi]), pt)
            vn = dot(v_rel, n)
            ne = neff[si][:, None]
            if _is_sta(ks, bi):
                # friction only: the stiff penalty carries the normal force
                new_lam = ln0
                imp = torch.zeros_like(pt)
            else:
                d_lam = torch.where(active, -(vn - target) / (kncache[si] * ne) * RELAX, 0.0)
                new_lam = torch.clamp(ln0 + d_lam, min=0.0)
                imp = n * (new_lam - ln0)[..., None]
            vt = v_rel - n * vn[..., None]
            vt_n = torch.sqrt(dot(vt, vt) + 1e-9)
            t_dir = vt * (1.0 / vt_n)[..., None]
            k_t = _quad(Kcache[si], floors[si][:, None], t_dir)
            jt_try = torch.where(active[..., None], -vt / (k_t * ne)[..., None], 0.0)
            cap = mu[si][:, None] * (new_lam + fn_seed(si, vn) * dt)
            lt_new = lt0 + jt_try
            ltn = torch.sqrt(dot(lt_new, lt_new) + 1e-9)
            lt_proj = lt_new * torch.clamp(cap / ltn, max=1.0)[..., None]
            imp = imp + (lt_proj - lt0)
            lam_n[si] = block_live_or(geo.live, new_lam)
            lam_t[si] = block_live_or(geo.live, lt_proj)
            parts.append(contribs(si, imp))
        commit(parts, rlv, rav, ubys)

    if body_art and lam is not None:
        # stiction snap: one regularised 6×6 least-squares solve per free
        # body matching its rigid motion to the articulated side at every
        # sticking couple sample, clipped to ±SNAP_CLIP
        v6 = v6_of(ubys)
        A_by: Dict[int, torch.Tensor] = {}
        b_by: Dict[int, torch.Tensor] = {}
        eye3 = torch.eye(3, dtype=ref.dtype, device=ref.device)
        for si, geo in enumerate(swept):
            bi = geo.blk
            if not _is_couple(ks, bi):
                continue
            a_art = bool(int(ks.blk_flags[bi]) & F_A_ART)
            b_free = int(ks.blk_bb[bi]) if a_art else int(ks.blk_ba[bi])
            b_art = _art_body(ks, bi)
            e_snap = -1.0 if a_art else 1.0
            a2 = body2actor[b_free]
            pt, n = geo.point, geo.normal
            r_free = pt - st["root_pos"][:, a2, None]
            v_free = rlv[a2][:, None] + cross(rav[a2][:, None], r_free)
            v_art = v6[b_art][:, None, 3:6] + cross(v6[b_art][:, None, 0:3], pt)
            v_rel = v_art - v_free if a_art else v_free - v_art
            vn_f = dot(v_rel, n)
            kn = float(ks.blk_kn[bi])
            kn_c = kn / (tau_c * tau_c)
            kd_c = _kd_couple(ks, bi, mass, dt, tau_c)[:, None]
            fn_imp = torch.clamp(kn_c * torch.clamp(torch.clamp(geo.depth, max=dcap), min=0.0)
                                 - (kd_c + dt * kn_c) * vn_f, min=0.0)
            cap_f = mu[si][:, None] * (lam_n[si] + fn_imp * dt)
            lt_n = torch.sqrt(dot(lam_t[si], lam_t[si]))
            w_st = act[si] * (lt_n < 0.98 * cap_f).to(ref.dtype)
            z = torch.zeros_like(r_free[..., 0])
            o = torch.ones_like(z)
            X = torch.stack([
                torch.stack([z, r_free[..., 2], -r_free[..., 1], o, z, z], -1),
                torch.stack([-r_free[..., 2], z, r_free[..., 0], z, o, z], -1),
                torch.stack([r_free[..., 1], -r_free[..., 0], z, z, z, o], -1),
            ], -2)                                                       # (K,S,3,6)
            P = eye3 - n[..., :, None] * n[..., None, :]
            PX = P @ X
            Pv = (P @ (e_snap * v_rel)[..., None])[..., 0]
            bvec = -(w_st[..., None] * (X.transpose(-1, -2) @ Pv[..., None])[..., 0]).sum(1)
            Amat = (w_st[..., None, None] * (X.transpose(-1, -2) @ PX)).sum(1)
            A_by[b_free] = A_by.get(b_free, 0.0) + block_live_or(geo.live, Amat)
            b_by[b_free] = b_by.get(b_free, 0.0) + block_live_or(geo.live, bvec)
        for b_free, A in A_by.items():
            a2 = body2actor[b_free]
            A_reg = A + 1e-4 * torch.eye(6, dtype=ref.dtype, device=ref.device)
            xi = cholesky_solve_factored(cholesky_factor(A_reg), b_by[b_free])
            xi = torch.clamp(xi, -SNAP_CLIP, SNAP_CLIP)
            rav[a2] = rav[a2] + xi[:, 0:3]
            rlv[a2] = rlv[a2] + xi[:, 3:6]

    for a in free_vel:
        free_vel[a][0], free_vel[a][1] = rlv[a], rav[a]
    for aid, ctx in art_ctx.items():
        ctx["u"] = ubys[aid]
    if lam is None:
        return None
    out = lam.clone()
    for si, geo in enumerate(swept):
        c0, S_ = c0s[si], geo.depth.shape[1]
        out[:, c0:c0 + S_, 0] = lam_n[si]
        out[:, c0:c0 + S_, 1:4] = lam_t[si]
    return out
