"""Host-side tables of the PyTorch port equal the JAX package's exactly: the
conf reader, the scene, the contact tables, the stacked articulation model and
the pair-block contact plan, for `panda`, `point_robot`, `panda_pick`, the
mobile-robot tasks `boxer_reach`, `boxer_push`, `heijn_reach` and
`heijn_push`, `multi_pointbot`, `panda_stick_push`, `panda_effort` and
`omni_panda_pick` (the effort drives' rows, `finger_motor` and
`dof_gate_body` included), and the mesh-fitted robots of `albert`, `anymal`
and `multi_jackal` (every collision element an OBJ mesh fit to a sphere,
capsule or box)."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from mppiisaac_tpu.ops.pallas import fused_physics as jfp
from mppiisaac_tpu.physics.dynamics import build_actor_masks as j_masks
from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.scene.actor import load_actor_cfgs as j_actors
from mppiisaac_tpu.scene.builder import build_scene as j_build
from mppiisaac_tpu.utils.config_store import actors_conf_dir as j_actor_dir
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.ops import fused_contacts as tfc
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.physics.dynamics import build_actor_masks as t_masks
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.utils import confsys
from mppiisaac_tpu_torch.utils.config_store import CONF_ROOT, actors_conf_dir
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)

CONF_FILES = sorted(
    os.path.relpath(p, CONF_ROOT) for p in glob.glob(os.path.join(CONF_ROOT, "**", "*.yaml"), recursive=True)
)
TASKS = ["panda", "point_robot", "panda_pick", "boxer_reach", "boxer_push", "heijn_reach",
         "heijn_push", "multi_pointbot", "panda_stick_push", "panda_effort", "omni_panda_pick",
         "albert", "anymal", "multi_jackal"]


@pytest.mark.parametrize("rel", CONF_FILES)
def test_conf_reader_matches_pyyaml(rel):
    with open(os.path.join(CONF_ROOT, rel)) as f:
        text = f.read()
    assert confsys.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "500", "1e-3", "1.0e-3", "-2", ".5", "010", "0x1f", "true", "off", "null", "~", "",
    "abc", "'quoted: x'", "[1, [2, 3.5], [], x]", "a:\n  b: 1  # c\n  c: [1,\n    2]\nd:\n- 1\n- x: 2\n",
])
def test_conf_reader_scalars_and_blocks(text):
    assert confsys.safe_load(text) == yaml.safe_load(text)


def _eq(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _eq(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    else:
        assert a == b, where


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _build(task):
    jc, tc = j_load(f"tasks/{task}"), t_load(f"tasks/{task}")
    jb = j_build(j_actors(jc.actors, j_actor_dir()), jc.isaacgym, jc.initial_actor_positions)
    tb = t_build(t_actors(tc.actors, actors_conf_dir()), tc.isaacgym, tc.initial_actor_positions)
    return jc, tc, jb, tb, JEngine(jb.scene), TEngine(tb.scene)


@pytest.mark.parametrize("task", TASKS)
def test_config_matches(task):
    jc, tc, *_ = _build(task)
    _eq(_fields(jc.mppi), _fields(tc.mppi), "mppi")
    _eq(_fields(jc.isaacgym), _fields(tc.isaacgym), "isaacgym")
    for k in ("render", "n_steps", "goal", "nx", "actors", "initial_actor_positions"):
        _eq(getattr(jc, k), getattr(tc, k), k)


@pytest.mark.parametrize("task", TASKS)
def test_scene_and_command_map_match(task):
    _, _, jb, tb, _, _ = _build(task)
    js, ts = _fields(jb.scene), _fields(tb.scene)
    ja, ta = js.pop("actors"), ts.pop("actors")
    _eq(js, ts, "scene")
    for a, b in zip(ja, ta):
        jd, td = _fields(a), _fields(b)
        jg, tg = jd.pop("geoms"), td.pop("geoms")
        _eq(jd, td, f"actor {a.name}")
        _eq([_fields(g) for g in jg], [_fields(g) for g in tg], f"geoms {a.name}")
    _eq(_fields(jb.cmd_map), _fields(tb.cmd_map), "cmd_map")
    _eq(jb.init_state_template, tb.init_state_template, "init")
    assert jb.visualize_bodies == tb.visualize_bodies
    assert jb.robot_names == tb.robot_names


@pytest.mark.parametrize("task", TASKS)
def test_engine_tables_match(task):
    _, _, jb, tb, je, te = _build(task)
    assert (je.substeps, je.dt_sub) == (te.substeps, te.dt_sub)
    jt, tt = _fields(je.tables), _fields(te.tables)
    _eq(jt, tt, "contact tables")
    js, ts = _fields(je.stacked), _fields(te.stacked)
    js.pop("scene"), ts.pop("scene")
    _eq(js, ts, "stacked")
    for a, b in zip(jb.scene.actors, tb.scene.actors):
        _eq(j_masks(a)._asdict(), t_masks(b)._asdict(), f"masks {a.name}")


@pytest.mark.parametrize("task", TASKS)
def test_pair_block_plan_matches(task):
    _, _, jb, tb, je, te = _build(task)
    jblocks, jsc = jfp.build_pair_blocks(jb.scene, je.tables)
    tblocks, tsc = tfp.build_pair_blocks(tb.scene, te.tables)
    _eq(jblocks, tblocks, "blocks")
    assert np.array_equal(jsc, tsc)
    assert np.array_equal(jfp.free_cand_indices(jb.scene, je.tables),
                          tfp.free_cand_indices(tb.scene, te.tables))
    assert [b["S"] for b in jfp.swept_blocks(jb.scene, je.tables)] == \
        [b["S"] for b in tfp.swept_blocks(tb.scene, te.tables)]


def test_kernel_scene_panda_tables():
    """The packed kernel tables of panda: 10 cp blocks, one solved actor."""
    *_, tb, _, te = _build("panda")
    ks = tfp.KernelScene.build(tb, te)
    assert (ks.nactor, ks.nbody, ks.ndof, ks.ngeom, ks.nu, ks.ncp) == (2, 12, 7, 11, 7, 10)
    assert ks.n_state_rows == 76 and ks.n_fc == 0 and ks.n_rows == 76
    assert ks.actor_dynamic.tolist() == [1, 0]
    blocks, _ = tfp.pair_blocks(tb.scene, te.tables)
    assert ks.blk_ba.tolist() == [b["ba"] for b in blocks]
    assert np.allclose(ks.blk_kn_a, [b["kn"] for b in blocks])


def test_kernel_scene_pick_tables():
    """The packed kernel tables of panda_pick: 38 pair blocks, 130 swept
    candidates (670 rows with λ), the block as a free body, 11 couple links
    with a Ψ, and the two binarized finger dofs."""
    *_, tb, _, te = _build("panda_pick")
    ks = tfp.KernelScene.build(tb, te)
    blocks, _ = tfp.pair_blocks(tb.scene, te.tables)
    assert ks.nblk == 38 and ks.n_fc == 130 and ks.n_rows == 670
    assert [b["kind"] for b in blocks].count("bbc") == 10
    assert ks.n_fc == len(tfp.free_cand_indices(tb.scene, te.tables))
    swept = [b for b in blocks if b["swept"]]
    assert [int(c) for c in ks.blk_c0 if c >= 0] == list(np.cumsum([0] + [b["S"] for b in swept])[:-1])
    assert ks.actor_dynamic.tolist() == [1, 0, 0, 2, 0, 0]
    assert int((ks.body_psi >= 0).sum()) == 11
    assert ks.bin_dof.tolist() == [7, 8] and ks.bin_src.tolist() == [8, 8]
    assert np.allclose(ks.bin_uhi, 0.15) and np.allclose(ks.bin_qopen, 0.03)


def test_kernel_scene_boxer_push_tables():
    """The packed kernel tables of boxer_push: 27 pair blocks (cp 6, bp 2,
    cc 9, cb 8, bbc 2), all swept, 89 candidates (455 rows with λ), the boxer
    as the one floating-base articulation (6 base + 2 wheel coordinates), 16
    couple and 5 stiction blocks, a Ψ for each of the boxer's 5 contact
    links, and the diff-drive map."""
    *_, tb, _, te = _build("boxer_push")
    ks = tfp.KernelScene.build(tb, te)
    blocks, _ = tfp.pair_blocks(tb.scene, te.tables)
    kinds = [b["kind"] for b in blocks]
    assert ks.nblk == 27 and ks.n_fc == 89 and ks.n_rows == 455 and ks.n_state_rows == 99
    assert {k: kinds.count(k) for k in set(kinds)} == dict(cp=6, bp=2, cc=9, cb=8, bbc=2)
    assert all(b["swept"] for b in blocks)
    assert ks.actor_dynamic.tolist() == [1, 2, 2, 2, 0]
    assert ks.actor_base.tolist() == [6, 0, 0, 0, 0] and ks.nv == 8
    assert int(((ks.blk_flags & (tfc.F_A_ART | tfc.F_B_ART)) != 0).sum()) == 16
    assert int(((ks.blk_flags & (tfc.F_A_STA | tfc.F_B_STA)) != 0).sum()) == 5
    assert sorted(np.flatnonzero(ks.body_psi >= 0).tolist()) == [0, 1, 2, 3, 4]
    assert np.allclose(ks.cmd_W, tb.cmd_map.W) and ks.nu == 2


def test_kernel_scene_effort_tables():
    """The packed kernel tables of omni_panda_pick and panda_effort: every
    dof effort-driven with the passive damping 10, the motor flag on the
    omni's two fingers only, no velocity-driven finger (so no force gate);
    omni's 42 pair blocks, 144 swept candidates and 12 velocity coordinates
    fit the kernels' bounds."""
    from mppiisaac_tpu_torch.ops.fused_rollout import check_bounds
    from mppiisaac_tpu_torch.physics.model import DRIVE_EFFORT

    *_, tb, _, te = _build("omni_panda_pick")
    ks = tfp.KernelScene.build(tb, te)
    assert (ks.dof_mode == DRIVE_EFFORT).all() and np.allclose(ks.dof_kd, 10.0)
    assert ks.dof_motor.tolist() == [0] * 10 + [1, 1]
    assert (ks.dof_gate_body < 0).all() and ks.grip_force_gate == 10.0
    assert (ks.nblk, ks.n_fc, ks.nv, ks.nbody, ks.ndof) == (42, 144, 12, 22, 12)
    check_bounds(ks)
    *_, tb, _, te = _build("panda_effort")
    ks = tfp.KernelScene.build(tb, te)
    assert (ks.dof_mode == DRIVE_EFFORT).all() and not ks.dof_motor.any()
