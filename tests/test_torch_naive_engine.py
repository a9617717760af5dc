"""The naive per-link engine (`mppiisaac_tpu_torch/physics/kinematics.py`
and the per-link half of `physics/dynamics.py`) against the JAX package's
on the same inputs, made from a seed with numpy: the two-link arm of
tests/test_physics_basic.py (fixed base), the same arm on a floating base,
and the panda of the shipped configs. The JAX functions take one env and
are vmapped over the batch; the port's take the batch as a leading axis.

Tolerances: the port's solve is its Cholesky (physics/math3d), the JAX
package's a general LU solve on the same SPD matrix, and every sum runs in
float32 in another order: 1e-5 relative on kinematics and 1e-4 on the
dynamics' outputs, with absolute floors scaled to each quantity.

Also the per-link mass matrix against the port's stacked engine
(physics/stacked.py) on panda, which assembles the same CRBA for every
actor at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.physics import dynamics as jdyn
from mppiisaac_tpu.physics import kinematics as jkin
from mppiisaac_tpu.physics.math3d import quat_to_matrix as jq2m
from mppiisaac_tpu.physics.model import build_articulation as j_build_articulation
from mppiisaac_tpu.physics.urdf import parse_urdf as j_parse_urdf
from mppiisaac_tpu_torch.physics import dynamics as tdyn
from mppiisaac_tpu_torch.physics import kinematics as tkin
from mppiisaac_tpu_torch.physics.math3d import quat_to_matrix as tq2m
from mppiisaac_tpu_torch.physics.model import build_articulation as t_build_articulation
from mppiisaac_tpu_torch.physics.stacked import fk_stacked, motion_subspace_stacked, spatial_inertias
from mppiisaac_tpu_torch.physics.urdf import parse_urdf as t_parse_urdf
from mppiisaac_tpu_torch.runtime.sim import Simulation
from mppiisaac_tpu_torch.scene.robots import robot_urdf
from mppiisaac_tpu_torch.utils.config_store import load_config

torch.set_num_threads(1)
K = 3
GRAVITY = np.array([0.0, 0.0, -9.81], np.float32)
# tests/test_physics_basic.py test_double_pendulum_mass_matrix_symmetry
TWO_LINK = """
<robot name="dp">
  <link name="base"/>
  <link name="l1">
    <inertial><origin xyz="0 0 -0.5"/><mass value="1.0"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="l2">
    <inertial><origin xyz="0 0 -0.5"/><mass value="0.7"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/><origin xyz="0 0 0"/>
    <axis xyz="0 1 0"/><limit lower="-10" upper="10" effort="100" velocity="100"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/><origin xyz="0 0 -1"/>
    <axis xyz="0 1 0"/><limit lower="-10" upper="10" effort="100" velocity="100"/>
  </joint>
</robot>
"""


def _panda_urdf():
    return robot_urdf("panda")


def _arts(source, fixed_base, dof_mode):
    ja = j_build_articulation(j_parse_urdf(source), fixed_base=fixed_base, dof_mode=dof_mode)
    ta = t_build_articulation(t_parse_urdf(source), fixed_base=fixed_base, dof_mode=dof_mode)
    return ja, ta


def _inputs(art, seed):
    """Root pose and velocities, q, qd, targets, Plücker forces and mass
    scales of K envs, from numpy."""
    r = np.random.RandomState(seed)
    quat = r.normal(size=(K, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    lo = np.maximum(art.dof_lower, -2.0)
    hi = np.minimum(art.dof_upper, 2.0)
    return dict(
        root_pos=r.uniform(-0.5, 0.5, (K, 3)).astype(np.float32),
        root_quat=quat if not art.fixed_base else np.tile([0.0, 0.0, 0.0, 1.0], (K, 1)).astype(np.float32),
        root_linvel=(r.uniform(-1, 1, (K, 3)) * (not art.fixed_base)).astype(np.float32),
        root_angvel=(r.uniform(-1, 1, (K, 3)) * (not art.fixed_base)).astype(np.float32),
        q=r.uniform(lo, hi, (K, art.ndof)).astype(np.float32),
        qd=r.uniform(-1.5, 1.5, (K, art.ndof)).astype(np.float32),
        target=r.uniform(-1.0, 1.0, (K, art.ndof)).astype(np.float32),
        f_ext=r.uniform(-2, 2, (K, art.nbody, 6)).astype(np.float32),
        mass_scale=r.uniform(0.8, 1.2, (K, art.nbody)).astype(np.float32),
    )


def _jax_all(art, x, dt):
    """The JAX functions on one env, vmapped: FK, the subspaces, M, C, u_new."""
    masks = jdyn.build_actor_masks(art)

    def one(rp, rq, rl, ra, q, qd, tgt, fe, ms):
        p, qq, lv, av = jkin.fk_actor(art, rp, rq, rl, ra, q, qd)
        anchors, axes = jkin.joint_world_frames(art, p, qq)
        din = jdyn.DynInputs(p, qq, lv, av, anchors, axes)
        R = jq2m(qq)
        com_w = p + jnp.einsum("bij,bj->bi", R, jnp.asarray(art.com, jnp.float32))
        mass = jnp.asarray(art.mass, jnp.float32) * ms
        I_com = jnp.asarray(art.inertia, jnp.float32) * ms[:, None, None]
        Iw = jdyn.spatial_inertia_world(mass, com_w, R, I_com)
        S = jdyn.motion_subspaces(art, masks, din)
        v_b = jdyn.body_spatial_velocity(din)
        M = jdyn.mass_matrix(art, masks, S, Iw)
        C = jdyn.bias_and_external(art, masks, S, Iw, v_b, qd, fe, GRAVITY)
        tau, d_imp = jdyn.drive_terms(art, q, qd, tgt, dt)
        lim = jdyn.joint_limit_torque(art, q, qd)
        u = jdyn.solve_velocity_update(art, masks, din, q, qd, tgt, fe, GRAVITY, dt, ms)
        return dict(pos=p, quat=qq, linvel=lv, angvel=av, axes=axes, S=S, v_b=v_b, M=M, C=C,
                    tau=tau, d_imp=d_imp, lim=lim, u=u)

    keys = ("root_pos", "root_quat", "root_linvel", "root_angvel", "q", "qd", "target", "f_ext",
            "mass_scale")
    out = jax.vmap(one)(*[jnp.asarray(x[k]) for k in keys])
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_all(art, x, dt):
    masks = tdyn.build_actor_masks(art)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    p, qq, lv, av = tkin.fk_actor(art, t["root_pos"], t["root_quat"], t["root_linvel"],
                                  t["root_angvel"], t["q"], t["qd"])
    anchors, axes = tkin.joint_world_frames(art, p, qq)
    din = tdyn.DynInputs(p, qq, lv, av, anchors, axes)
    R = tq2m(qq)
    com_w = p + torch.einsum("kbij,bj->kbi", R, torch.as_tensor(art.com, dtype=torch.float32))
    ms = t["mass_scale"]
    mass = torch.as_tensor(art.mass, dtype=torch.float32) * ms
    I_com = torch.as_tensor(art.inertia, dtype=torch.float32) * ms[..., None, None]
    Iw = tdyn.spatial_inertia_world(mass, com_w, R, I_com)
    S = tdyn.motion_subspaces(art, masks, din)
    v_b = tdyn.body_spatial_velocity(din)
    M = tdyn.mass_matrix(art, masks, S, Iw)
    C = tdyn.bias_and_external(art, masks, S, Iw, v_b, t["qd"], t["f_ext"], GRAVITY)
    tau, d_imp = tdyn.drive_terms(art, t["q"], t["qd"], t["target"], dt)
    lim = tdyn.joint_limit_torque(art, t["q"], t["qd"])
    u = tdyn.solve_velocity_update(art, masks, din, t["q"], t["qd"], t["target"], t["f_ext"],
                                   GRAVITY, dt, ms)
    out = dict(pos=p, quat=qq, linvel=lv, angvel=av, axes=axes, S=S, v_b=v_b, M=M, C=C, tau=tau,
               d_imp=d_imp, lim=lim, u=u)
    return {k: v.numpy() for k, v in out.items()}


CASES = {
    # (source, fixed_base, dof_mode)
    "two_link": (TWO_LINK, True, "velocity"),
    "two_link_floating": (TWO_LINK, False, "position"),
    "panda": (None, True, "velocity"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_link_engine_matches_jax(case):
    source, fixed, mode = CASES[case]
    ja, ta = _arts(source if source is not None else _panda_urdf(), fixed, mode)
    x = _inputs(ta, seed=sorted(CASES).index(case) + 1)
    dt = 0.0125
    ref, got = _jax_all(ja, x, dt), _torch_all(ta, x, dt)
    for k in ("pos", "quat", "linvel", "angvel", "axes", "S", "v_b"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    scale = {k: max(1.0, float(np.abs(ref[k]).max())) for k in ("M", "C", "tau", "lim", "u")}
    for k in ("M", "C", "tau", "d_imp", "lim", "u"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5 * scale.get(k, 1.0),
                                   err_msg=k)
    assert np.isfinite(got["u"]).all() and got["u"].shape == (K, tdyn.build_actor_masks(ta).nv)


def test_mass_matrix_matches_the_stacked_engine():
    """The panda reach scene's stick panda at K random poses and mass
    scales: the per-link CRBA (fk_actor → mass_matrix) against the stacked
    engine's own assembly of the same matrix (its FK, subspaces, spatial
    inertias and ancestry mask, as `stacked_substep` forms M0)."""
    cfg = load_config("tasks/panda")
    w = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
    scene, m = w.scene, w.engine.stacked
    a = scene.actor_index("panda_stick") if "panda_stick" in scene.actor_names else 0
    art = scene.actors[a]
    assert art.fixed_base and art.ndof == scene.ndof
    x = _inputs(art, seed=7)
    q = torch.as_tensor(x["q"])
    root_pos = w.state.root_pos[0][None].expand(K, -1, -1)
    root_quat = w.state.root_quat[0][None].expand(K, -1, -1)
    ms = torch.ones(K, scene.nbody)
    bo = scene.body_offset[a]
    ms[:, bo:bo + art.nbody] = torch.as_tensor(x["mass_scale"])
    # the stacked engine's M0 of the panda (its one dynamic actor)
    body_pos, body_quat, axis_w = fk_stacked(m, root_pos, root_quat, q)
    S = motion_subspace_stacked(m, body_pos, axis_w)
    Iw = spatial_inertias(m, body_pos, body_quat, ms)
    sub = torch.as_tensor(m.subtree, dtype=torch.float32)
    Ic = (sub @ Iw.reshape(K, m.B, 36)).reshape(K, m.NV, 6, 6)
    F = torch.einsum("kvij,kvj->kvi", Ic, S)
    ac = torch.as_tensor(m.act_coords[0], dtype=torch.long)
    Mm = (S[:, ac] @ F[:, ac].transpose(-1, -2)) * torch.as_tensor(m.act_anc[0], dtype=torch.float32)
    M_stacked = Mm + Mm.transpose(-1, -2) - Mm * torch.eye(ac.shape[0])
    # the per-link engine
    masks = tdyn.build_actor_masks(art)
    zero = torch.zeros(K, 3)
    p, qq, lv, av = tkin.fk_actor(art, root_pos[:, a], root_quat[:, a], zero, zero, q,
                                  torch.zeros_like(q))
    ms = ms[:, bo:bo + art.nbody]
    anchors, axes = tkin.joint_world_frames(art, p, qq)
    din = tdyn.DynInputs(p, qq, lv, av, anchors, axes)
    R = tq2m(qq)
    com_w = p + torch.einsum("kbij,bj->kbi", R, torch.as_tensor(art.com, dtype=torch.float32))
    Iw1 = tdyn.spatial_inertia_world(torch.as_tensor(art.mass, dtype=torch.float32) * ms, com_w, R,
                                     torch.as_tensor(art.inertia, dtype=torch.float32) * ms[..., None, None])
    M = tdyn.mass_matrix(art, masks, tdyn.motion_subspaces(art, masks, din), Iw1)
    torch.testing.assert_close(M, M_stacked[:, :art.ndof, :art.ndof], rtol=1e-4, atol=1e-5)
