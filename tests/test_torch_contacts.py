"""The port's contact twin (ops/fused_contacts.py, the plain version of the
kernels' contacts.cuh) against the JAX package's lanes functions on the
panda_pick scene: `block_gate`, `block_geometry` for the cp, bp, cb and bbc
blocks, and `contacts_lanes`, called on plain arrays of K random poses, plus
the math the narrowphase stands on.

Poses: the arm bent at random (a quarter of the samples into the ground),
the fingers at random openings, the block between the fingers, on or into
the table, or on the ground, so that every block kind carries real contacts
and many blocks are separated.
The JAX gate is "any sample of the batch"; the port's is per sample, so the
gates are compared sample by sample (JAX vmapped over samples).

Tolerances: points and depths 1e-5 m (float32 sums in another order);
normals 2e-4 (the normal of a point just outside a box is its overshoot
vector over its length, and near the surface both are a few µm, so an ulp of
the overshoot moves the normal by ~1e-5 to 1e-4); forces rtol 1e-4 with atol
1e-3 N on penalty forces that reach 1e3 N.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.ops.pallas import fused_physics as jfp
from mppiisaac_tpu.ops.pallas import lanes as JL
from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.scene.actor import load_actor_cfgs as j_actors
from mppiisaac_tpu.scene.builder import build_scene as j_build
from mppiisaac_tpu.utils.config_store import actors_conf_dir as j_actor_dir
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.ops import fused_contacts as tfc
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.physics import math3d as M
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.utils.config_store import actors_conf_dir, load_config

torch.set_num_threads(1)
K = 64
GEO_TOL = 1e-5
NRM_TOL = 2e-4
F_RTOL, F_ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def pick():
    jc = j_load("tasks/panda_pick")
    jb = j_build(j_actors(jc.actors, j_actor_dir()), jc.isaacgym, jc.initial_actor_positions)
    je = JEngine(jb.scene)
    tc = load_config("tasks/panda_pick")
    tb = t_build(t_actors(tc.actors, actors_conf_dir()), tc.isaacgym, tc.initial_actor_positions)
    te = TEngine(tb.scene)
    ks = tfp.KernelScene.build(tb, te)
    return jb, je, tb, te, ks


def _poses(tb, te, ks, seed):
    """K random states of the pick scene as the twin's state dict."""
    rng = np.random.RandomState(seed)
    s0 = tb.initial_state(te)
    A, D = ks.nactor, ks.ndof
    q = np.tile(s0.q.numpy(), (K, 1))
    q[:, :7] += rng.uniform(-0.6, 0.6, (K, 7))
    q[:, 7:9] = rng.uniform(0.0, 0.04, (K, 2))
    low = rng.uniform(size=K) < 0.25                 # arm bent down into the ground
    q[low, 1] = rng.uniform(1.4, 1.8, int(low.sum()))
    q[low, 3] = -0.3
    qd = rng.uniform(-1, 1, (K, D)).astype(np.float32)
    root = np.tile(torch.cat([s0.root_pos, s0.root_quat, s0.root_linvel, s0.root_angvel], -1).numpy(),
                   (K, 1, 1))
    st = tfp.rows_to_state(ks, tfp.state_to_rows(
        ks, torch.as_tensor(root), torch.as_tensor(q, dtype=torch.float32), torch.as_tensor(qd)))
    pos, _, _, _, _ = tfp.fk(ks, st)
    ai = tb.scene.actor_index("panda_pick_block")
    ee = tb.scene.body_index("panda_ee", "panda")
    at = tb.scene.actor_index("table")
    gt = int(np.flatnonzero(tb.scene.geom_body == tb.scene.body_offset[at])[0])
    table_top = float(s0.root_pos[at, 2]) + float(tb.scene.geom_pos[gt][2]) + float(tb.scene.geom_size[gt][2])
    where = rng.randint(0, 3, (K, 1))                # between the fingers, on the table, on the ground
    blk = np.where(where == 0, pos[ee].numpy() + rng.uniform(-0.03, 0.03, (K, 3)),
                   np.stack([rng.uniform(0.3, 0.7, K), rng.uniform(-0.2, 0.2, K),
                             table_top + rng.uniform(-0.01, 0.06, K)], -1))
    blk = np.where(where == 2, np.stack([rng.uniform(-0.8, -0.5, K), rng.uniform(-0.2, 0.2, K),
                                         rng.uniform(0.0, 0.06, K)], -1), blk)
    ang = rng.uniform(-np.pi, np.pi, K)
    root[:, ai, 0:3] = blk
    root[:, ai, 3:7] = np.stack([np.zeros(K), np.zeros(K), np.sin(ang / 2), np.cos(ang / 2)], -1)
    root[:, ai, 7:13] = rng.uniform(-0.5, 0.5, (K, 6))
    return tfp.rows_to_state(ks, tfp.state_to_rows(
        ks, torch.as_tensor(root, dtype=torch.float32), torch.as_tensor(q, dtype=torch.float32),
        torch.as_tensor(qd)))


def _jax_state(st):
    A = st["root_pos"].shape[1]

    def t3(x, a):
        return tuple(jnp.asarray(x[:, a, i].numpy()) for i in range(x.shape[-1]))

    return {
        "root_pos": [t3(st["root_pos"], a) for a in range(A)],
        "root_quat": [t3(st["root_quat"], a) for a in range(A)],
        "root_linvel": [t3(st["root_linvel"], a) for a in range(A)],
        "root_angvel": [t3(st["root_angvel"], a) for a in range(A)],
        "q": [jnp.asarray(st["q"][:, d].numpy()) for d in range(st["q"].shape[1])],
        "qd": [jnp.asarray(st["qd"][:, d].numpy()) for d in range(st["qd"].shape[1])],
    }


def _np3(t):
    return np.stack([np.broadcast_to(np.asarray(c, np.float32), (K,)) for c in t], -1)


def test_point_to_box_and_segment_match_lanes():
    rng = np.random.RandomState(0)
    p = rng.uniform(-0.3, 0.3, (K, 5, 3)).astype(np.float32)
    p[:, 0] = 0.0                                   # the box centre: every face ties
    bp = rng.uniform(-0.1, 0.1, (K, 1, 3)).astype(np.float32)
    bq = rng.normal(size=(K, 1, 4)).astype(np.float32)
    bq /= np.linalg.norm(bq, axis=-1, keepdims=True)
    bp[:, :, :] = np.where(np.arange(K)[:, None, None] == 0, 0.0, bp)
    bq[0] = [0, 0, 0, 1]
    half = (0.1, 0.05, 0.2)
    n_t, d_t, s_t = M.point_to_box(torch.as_tensor(p), torch.as_tensor(bp), torch.as_tensor(bq), half)
    T = lambda x: tuple(jnp.asarray(x[..., i]) for i in range(x.shape[-1]))   # noqa: E731
    n_j, d_j, s_j = jfp._point_to_box_lanes(T(p), T(bp), T(bq), half)
    np.testing.assert_allclose(n_t.numpy(), np.stack([np.asarray(c) for c in n_j], -1), atol=NRM_TOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=GEO_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.stack([np.asarray(c) for c in s_j], -1), atol=GEO_TOL)
    a0, a1, b0 = (rng.uniform(-1, 1, (K, 3)).astype(np.float32) for _ in range(3))
    a1[:4] = a0[:4]                                  # degenerate segments
    c_t, _ = M.segment_closest(*(torch.as_tensor(x) for x in (a0, a1, b0, b0)))
    c_j, _ = jfp._segment_closest_lanes(T(a0), T(a1), T(b0), T(b0))
    np.testing.assert_allclose(c_t.numpy(), np.stack([np.asarray(c) for c in c_j], -1), atol=GEO_TOL)
    q = rng.normal(size=(K, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w = rng.uniform(-3, 3, (K, 3)).astype(np.float32)
    w[0] = 0.0
    qi_t = M.qintegrate(torch.as_tensor(q), torch.as_tensor(w), 0.0125)
    qi_j = JL.qintegrate(T(q), T(w), 0.0125)
    np.testing.assert_allclose(qi_t.numpy(), np.stack([np.asarray(c) for c in qi_j], -1), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_and_geometry_match_lanes(pick, seed):
    jb, je, tb, te, ks = pick
    st = _poses(tb, te, ks, seed)
    pos, quat, _, _, _ = tfp.fk(ks, st)
    jpos, jquat, _, _, _ = jfp.fk_lanes(jb.scene, _jax_state(st))
    blocks, sconst = jfp.pair_blocks(jb.scene, je.tables)
    sc = jnp.asarray(sconst)[:, None]
    kinds, live_any, dead_any = set(), 0, 0
    for bi, blk in enumerate(blocks):
        live = tfc.block_gate(ks, bi, pos, quat).numpy()
        jg = jax.vmap(lambda p, q: jfp.block_gate(jb.scene, blk, p, q))(jpos, jquat)
        np.testing.assert_array_equal(live, np.asarray(jg), err_msg=f"gate of block {bi}")
        live_any += int(live.any())
        dead_any += int((~live).any())
        point, normal, depth = tfc.block_geometry(ks, bi, pos, quat)
        jp, jn, jd = jfp.block_geometry(jb.scene, blk, jpos, jquat, sc)
        S = depth.shape[1]
        jp = np.stack([np.broadcast_to(np.asarray(c), (S, K)).T for c in jp], -1)
        jn = np.stack([np.broadcast_to(np.asarray(c, np.float32), (S, K)).T for c in jn], -1)
        np.testing.assert_allclose(point.numpy(), jp, atol=GEO_TOL, err_msg=f"point of block {bi}")
        np.testing.assert_allclose(normal.expand(K, S, 3).numpy(), jn, atol=NRM_TOL,
                                   err_msg=f"normal of block {bi}")
        np.testing.assert_allclose(depth.numpy(), np.asarray(jd).T, atol=GEO_TOL,
                                   err_msg=f"depth of block {bi}")
        if (depth.numpy() > 0).any():
            kinds.add(blk["kind"])
    assert kinds >= {"cp", "bp", "cb", "bbc"}, kinds
    assert live_any > 5 and dead_any > 5


def test_slab_gate_edge_cases(pick):
    """Samples straddling the exact slab threshold of the finger↔block and
    block↔table blocks, a rotated b-side box, and a NaN pose (its blocks stay
    live, as on the TPU)."""
    jb, je, tb, te, ks = pick
    st = _poses(tb, te, ks, 2)
    blocks, _ = jfp.pair_blocks(jb.scene, je.tables)
    slab = [bi for bi, b in enumerate(blocks) if int(ks.blk_flags[bi]) & tfc.F_SLAB]
    assert slab
    bi = slab[0]
    ba, bb = int(ks.blk_ba[bi]), int(ks.blk_bb[bi])
    pos, quat, _, _, _ = tfp.fk(ks, st)
    gb = int(ks.blk_gb[bi])
    thr = float(np.sqrt(ks.blk_thr[bi]))
    offs = torch.linspace(-2e-5, 2e-5, K, dtype=torch.float64)
    pos, quat = list(pos), list(quat)
    quat[bb] = torch.tensor([0.0, 0.0, 0.0, 1.0]).repeat(K, 1)
    quat[bb][1] = torch.tensor([0.0, 0.0, 0.38268343, 0.92387953])
    p = pos[bb].double() + torch.as_tensor(ks.geom_pos[gb], dtype=torch.float64)
    p[:, 0] += float(ks.geom_size[gb][0]) + thr + offs
    pos[ba] = p.float()
    pos[ba][0] = float("nan")
    live = tfc.block_gate(ks, bi, pos, quat).numpy()
    T = lambda x: tuple(jnp.asarray(x[:, i].numpy()) for i in range(x.shape[-1]))   # noqa: E731
    jg = jax.vmap(lambda p_, q_: jfp.block_gate(jb.scene, blocks[bi], p_, q_))(
        [T(x) for x in pos], [T(x) for x in quat])
    np.testing.assert_array_equal(live, np.asarray(jg))
    assert live[0] and live.any() and not live.all()


@pytest.mark.parametrize("seed", [3, 4])
def test_contacts_match_lanes(pick, seed):
    jb, je, tb, te, ks = pick
    st = _poses(tb, te, ks, seed)
    rng = np.random.RandomState(seed)
    fric = rng.uniform(0.8, 1.2, (K, ks.ngeom)).astype(np.float32)
    dt = te.dt_sub
    pos, quat, linv, angv, _ = tfp.fk(ks, st)
    plk_n, plk_f, net_cf, swept = tfc.contacts(ks, pos, quat, linv, angv, torch.as_tensor(fric), dt)
    jpos, jquat, jlinv, jangv, _ = jfp.fk_lanes(jb.scene, _jax_state(st))
    sconst = jnp.asarray(jfp.pair_blocks(jb.scene, je.tables)[1])[:, None]
    jn, jf, jcf, jsw = jfp.contacts_lanes(jb.scene, je.tables, jpos, jquat, jlinv, jangv,
                                          [jnp.asarray(fric[:, g]) for g in range(ks.ngeom)], dt,
                                          sconst=sconst)
    total = 0.0
    for b in range(ks.nbody):
        for got, ref in ((plk_n[b], jn[b]), (plk_f[b], jf[b]), (net_cf[b], jcf[b])):
            np.testing.assert_allclose(got.numpy(), _np3(ref), rtol=F_RTOL, atol=F_ATOL,
                                       err_msg=f"body {b}")
        total += float(net_cf[b].abs().sum())
    assert total > 10.0, "no contact force: the contact path went untested"
    assert [g.blk for g in swept] == [bi for bi in range(ks.nblk) if ks.blk_flags[bi] & tfc.F_SWEPT]
    assert len(jsw) == len(swept)
    for g, (blk, (jp, jnrm, jd), _) in zip(swept, jsw):
        lv = g.live.numpy()
        S = g.depth.shape[1]
        jd = np.broadcast_to(np.asarray(jd), (S, K)).T
        np.testing.assert_allclose(g.depth.numpy()[lv], jd[lv], atol=GEO_TOL)
        assert (g.depth.numpy()[~lv] == 0).all()
