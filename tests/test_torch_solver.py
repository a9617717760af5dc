"""The port's MPPI update against the JAX solver with the noise ε injected,
the port's Halton/ndtri sampler checked by its statistics, and the port's
random numbers (`mppi.prng`) against `jax.random`: the same keys bit for bit,
so whole commands agree with the noise drawn, not injected.

Both solvers roll out through the same stub (a smooth cost of the controls),
so the comparison isolates the update: clip, null sample, action cost,
softmax weights, Savitzky–Golay filter, shift, λ and Σ updates. The same
costs must give U, weights and the action to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.mppi.solver import MPPIPlanner as JPlanner
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import carry_from_jax
from mppiisaac_tpu_torch.mppi import prng
from mppiisaac_tpu_torch.mppi.sampling import bspline_interp_matrix
from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner as TPlanner
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)
TOL = 1e-5


class _JStub:
    def rollout(self, state, params, V):
        return 0.1 * jnp.mean((V - 0.3) ** 2, axis=-1), jnp.zeros((V.shape[1], V.shape[0], 3))


class _TStub:
    def rollout(self, state, params, V):
        return 0.1 * torch.mean((V - 0.3) ** 2, dim=-1), torch.zeros(V.shape[1], V.shape[0], 3)


CASES = [
    ("panda", []),
    ("point_robot", []),
    ("panda", ["mppi.update_lambda=true", "mppi.update_cov=true", "mppi.noise_abs_cost=true"]),
    ("panda_effort", []),
    ("omni_panda_pick", []),
    ("multi_jackal", []),
    ("albert", []),
    ("anymal", []),
]


@pytest.mark.parametrize("task,overrides", CASES)
def test_command_matches_jax_with_injected_noise(task, overrides):
    jc, tc = j_load(f"tasks/{task}", overrides), t_load(f"tasks/{task}", overrides)
    jp = JPlanner(jc.mppi, jc.nx, dynamics=None, running_cost=None, fused=_JStub())
    tp = TPlanner(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    rng = np.random.RandomState(7)
    carry = jp.init_carry()
    carry = carry._replace(U=jnp.asarray(rng.uniform(-0.5, 0.5, carry.U.shape), jnp.float32))
    # the noise JAX draws inside _command_impl (solver.py:177-178)
    _, sub = jax.random.split(carry.key)
    eps = np.asarray(jp._sample_noise(sub, carry.sigma))
    a_j, c_j, i_j = jp._command_impl(carry, (None, None))
    a_t, c_t, i_t = tp._command_impl(carry_from_jax(carry), (None, None), eps=torch.tensor(eps))

    def close(t, j, what):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL, err_msg=what)

    close(i_t["costs"], i_j["costs"], "costs S")
    close(i_t["weights"], i_j["weights"], "weights")
    close(i_t["eta"], i_j["eta"], "eta")
    close(a_t, a_j, "action")
    close(c_t.U, c_j.U, "U")
    close(c_t.lambda_, c_j.lambda_, "lambda")
    close(c_t.sigma, c_j.sigma, "sigma")
    assert c_t.t0 == int(c_j.t0)


def test_halton_ndtri_noise_statistics():
    """ε = P z Lᵀ with z the Cranley–Patterson-shifted Halton table through
    ndtri: zero mean, per-step covariance (Σ_t P[h,t]²)·Σ, fresh shifts per
    draw and a seeded, reproducible generator."""
    tc = t_load("tasks/panda")
    tp = TPlanner(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    c = tp.cfg
    sigma = tp.carry.sigma
    key, draws = tp.carry.key, []
    for _ in range(4):
        key, sub = prng.split(key)
        draws.append(tp.noise(torch.from_numpy(tp._draw_np(sub)), sigma))
    eps = torch.cat(draws).double()                                  # (4K,H,nu)
    assert eps.shape[1:] == (c.horizon, tp.nu)
    P = bspline_interp_matrix(tp._n_knots, c.horizon, c.spline_degree)
    expect_var = (P ** 2).sum(1)[:, None] * np.diag(c.noise_sigma)[None]   # (H,nu)
    std = np.sqrt(expect_var)
    assert np.abs(eps.mean(0).numpy()).max() < 0.05 * std.min()
    np.testing.assert_allclose(eps.var(0).numpy(), expect_var, rtol=0.1)
    assert not torch.equal(draws[0], draws[1])
    tp2 = TPlanner(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    assert torch.equal(tp2.noise(torch.from_numpy(tp2._draw_np(prng.split(tp2.carry.key)[1])),
                                 sigma), draws[0])


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_prng_matches_jax_random(seed):
    """Keys, splits and uniform draws are bit-identical to jax.random's; the
    normal draws agree to the rounding of float32 erfinv, which grows in the
    tails (3e-6 relative at |z| = 3.6)."""
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_array_equal(tsub, np.asarray(jsub))
        np.testing.assert_array_equal(prng.uniform(tsub, (3, 37)),
                                      np.asarray(jax.random.uniform(jsub, (3, 37))))
        z = torch.special.erfinv(torch.as_tensor(prng.normal_uniforms(tsub, (5, 8)))) * np.sqrt(2.0)
        np.testing.assert_allclose(z.numpy(), np.asarray(jax.random.normal(jsub, (5, 8))),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("task,overrides", [("panda", []), ("boxer_reach", []),
                                            ("point_robot", ["mppi.sampling_method=random"]),
                                            ("panda_effort", []), ("omni_panda_pick", []),
                                            ("multi_jackal", []), ("albert", []), ("anymal", [])])
def test_commands_match_jax_with_drawn_noise(task, overrides):
    """Three commands from the same seed, each drawing its own noise: the port
    draws what the JAX solver draws, so actions and carries agree."""
    jc, tc = j_load(f"tasks/{task}", overrides), t_load(f"tasks/{task}", overrides)
    jp = JPlanner(jc.mppi, jc.nx, dynamics=None, running_cost=None, fused=_JStub())
    tp = TPlanner(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    jcar, tcar = jp.init_carry(), tp.carry
    for i in range(3):
        a_j, jcar, i_j = jp._command_impl(jcar, (None, None))
        a_t, tcar, i_t = tp._command_impl(tcar, (None, None))
        np.testing.assert_array_equal(tcar.key, np.asarray(jcar.key))
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=TOL, atol=TOL,
                                   err_msg=f"action {i}")
        np.testing.assert_allclose(tcar.U.numpy(), np.asarray(jcar.U), rtol=TOL, atol=TOL,
                                   err_msg=f"U {i}")


def test_update_noise_sigma_matches_jax():
    """Online re-tuning of Σ: the carry's covariance and the resolved config
    change together, as in the JAX solver."""
    jc, tc = j_load("tasks/point_robot"), t_load("tasks/point_robot")
    jp = JPlanner(jc.mppi, jc.nx, dynamics=None, running_cost=None, fused=_JStub())
    tp = TPlanner(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    new = np.diag([0.3, 0.4, 0.5])
    jp.update_noise_sigma(new)
    tp.update_noise_sigma(new)
    np.testing.assert_array_equal(tp.carry.sigma.numpy(), np.asarray(jp.carry.sigma))
    np.testing.assert_array_equal(tp.cfg.noise_sigma, jp.cfg.noise_sigma)
