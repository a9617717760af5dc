"""The balls demo's scene on the port's batched world step, against the JAX
package's Pallas kernel and its demo (the CPU: K2's plain version).

* Against JAX's Pallas `FusedWorldStep` in interpret mode, env by env, for
  3 steps from a landed state whose envs differ (the balls rolling, each env
  with its own x velocities from a numpy seed): 10× the plain version's own
  float32-vs-float64 drift there over the same steps (2.0e-6 in poses,
  1.0e-4 in velocities: the rolling contacts' angular velocities), since
  both run the same device code in float32 in another order.
* The port's demo (`mppiisaac_tpu_torch.examples.balls_demo`) at N=2 and 30
  steps against the JAX demo's printed mean height (3 decimals).
"""
import importlib.util
import os
import re

import jax
import numpy as np
import torch

from mppiisaac_tpu.ops.pallas.fused_rollout import FusedWorldStep as JWorld

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.examples import balls_demo
from test_torch_batched import HEIGHT_ATOL, HEIGHT_STEPS, N_ENVS, jax_balls

torch.set_num_threads(1)
PALLAS_POSE_ATOL, PALLAS_VEL_ATOL, PALLAS_STEPS = 2e-5, 1e-3, 3


def test_balls_batch_matches_pallas_world_step_per_env():
    """Envs made different (per-env x velocities from a numpy seed) after 20
    steps, when two balls rest and two are still falling; then each env of
    the port's batched step against the Pallas kernel on that env."""
    js = jax_balls(N_ENVS)
    for _ in range(HEIGHT_STEPS):
        js.step()
    rng = np.random.RandomState(0)
    vx = rng.uniform(-0.5, 0.5, (N_ENVS, 4)).astype(np.float32)
    st = js.state._replace(root_linvel=js.state.root_linvel.at[..., 0].set(vx))
    st = jax.vmap(js.engine.refresh)(st)
    jw = JWorld(js.built, js.engine, impulse_sweeps=js.cfg.fused_world_sweeps, interpret=True)
    ts = balls_demo.balls_sim(N_ENVS, 4, device="cpu")
    ts.state = sim_state_from_jax(st)
    ts.params = model_params_from_jax(js.params)
    for _ in range(PALLAS_STEPS):
        ts.step()
    for e in range(N_ENVS):
        je = jax.tree.map(lambda x: x[e], st)
        pe = jax.tree.map(lambda x: x[e], js.params)
        for _ in range(PALLAS_STEPS):
            je = jw.step(je, pe)
        for f, atol in (("root_pos", PALLAS_POSE_ATOL), ("root_quat", PALLAS_POSE_ATOL),
                        ("root_linvel", PALLAS_VEL_ATOL), ("root_angvel", PALLAS_VEL_ATOL)):
            np.testing.assert_allclose(getattr(ts.state, f)[e].numpy(), np.asarray(getattr(je, f)),
                                       rtol=0, atol=atol, err_msg=f"env {e} {f}")


def test_demo_matches_jax_demo(capsys):
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "balls_demo.py")
    spec = importlib.util.spec_from_file_location("jax_balls_demo", path)
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    jdemo.main(num_envs=2, n_balls=4, steps=30)
    jout = capsys.readouterr().out
    out = balls_demo.main(num_envs=2, n_balls=4, steps=30, device="cpu")
    tout = capsys.readouterr().out
    j_mean = float(re.search(r"mean height ([0-9.]+)", jout).group(1))
    assert abs(out["mean_height"] - j_mean) <= 5e-4 + HEIGHT_ATOL    # JAX prints 3 decimals
    assert out["identical"] and out["exact"]
    assert "identical across envs: True" in tout and "snapshot restore: exact" in tout
