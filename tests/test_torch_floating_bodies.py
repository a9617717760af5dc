"""A floating actor of several bodies and no joints (two spheres joined by a
fixed joint): a documented parity fact.

* The port's kernels refuse it: `KernelScene.build` raises
  NotImplementedError naming the actor. The JAX package's K2 fails on it
  too (its `body2actor` holds only the root of such an actor: a KeyError
  at `mppiisaac_tpu/ops/pallas/fused_physics.py:1101` in interpret mode).
* Both packages' engines step it (`Engine.step`, the port's
  `fused_world=False` world and unfused rollout), and they agree: the
  dumbbell dropped onto the ground, 3 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.scene.actor import ActorSpec as JSpec
from mppiisaac_tpu.scene.builder import SimConfig as JConfig
from mppiisaac_tpu.scene.builder import build_scene as j_build

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops.fused_physics import KernelScene
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.scene.builder import SimConfig as TConfig
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build

torch.set_num_threads(1)
STEPS = 3
# a free-falling dumbbell: a 0.1 m sphere and a 0.05 m one 0.15 m beside it
URDF = """<robot name="dumbbell">
  <link name="a">
    <inertial><mass value="1.0"/>
      <inertia ixx="0.004" ixy="0" ixz="0" iyy="0.004" iyz="0" izz="0.004"/></inertial>
    <collision><geometry><sphere radius="0.1"/></geometry></collision>
  </link>
  <link name="b">
    <inertial><mass value="0.5"/>
      <inertia ixx="0.0005" ixy="0" ixz="0" iyy="0.0005" iyz="0" izz="0.0005"/></inertial>
    <collision><geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <joint name="a_b" type="fixed">
    <parent link="a"/><child link="b"/><origin xyz="0.15 0 0"/>
  </joint>
</robot>
"""


def _scenes(tmp_path):
    path = tmp_path / "dumbbell.urdf"
    path.write_text(URDF)

    def specs(S):
        return [S(type="robot", name="dumbbell", urdf_file=str(path), fixed=False,
                  init_pos=[0.0, 0.0, 0.12])]

    jb = j_build(specs(JSpec), JConfig(dt=0.05, substeps=2))
    tb = t_build(specs(TSpec), TConfig(dt=0.05, substeps=2))
    return jb, JEngine(jb.scene), tb, TEngine(tb.scene)


def test_the_scene_is_a_floating_actor_of_two_bodies_and_no_joints(tmp_path):
    jb, _, tb, _ = _scenes(tmp_path)
    for b in (jb, tb):
        art = b.scene.actors[0]
        assert (art.nbody, art.ndof, bool(art.fixed_base)) == (2, 0, False)


def test_the_kernels_refuse_it_naming_the_actor(tmp_path):
    _, _, tb, te = _scenes(tmp_path)
    with pytest.raises(NotImplementedError, match="'dumbbell'"):
        KernelScene.build(tb, te, None)


def test_engine_step_matches_jax(tmp_path):
    jb, je, tb, te = _scenes(tmp_path)
    js = jax.tree.map(lambda x: x[None], jb.initial_state(je))
    jp = jax.tree.map(lambda x: x[None], _ones(jb))
    ts, tp = sim_state_from_jax(js), model_params_from_jax(jp)
    jstep = jax.jit(jax.vmap(je.step))
    z0 = float(ts.root_pos[0, 0, 2])
    for _ in range(STEPS):
        js, ts = jstep(js, jp), te.step(ts, tp)
    for f in SIM_STATE_FIELDS:
        j = np.asarray(getattr(js, f)) if getattr(js, f) is not None else None
        if j is None or not j.size:
            continue
        np.testing.assert_allclose(getattr(ts, f).numpy(), j, atol=1e-5, rtol=1e-5, err_msg=f)
    # it fell: the root and the second body moved down
    assert float(ts.root_pos[0, 0, 2]) < z0 - 1e-3
    assert float(ts.body_pos[0, 1, 2]) < z0 - 1e-3


def _ones(jb):
    from mppiisaac_tpu.physics.types import ModelParams

    return ModelParams(body_mass_scale=jnp.ones((jb.scene.nbody,), jnp.float32),
                       geom_friction=jnp.ones((jb.scene.ngeom,), jnp.float32))
