"""The cases of tests/test_math3d.py run through both packages: the port's
torch math3d agrees with the JAX package's to 1e-6 and keeps each property."""
import jax.numpy as jnp
import numpy as np
import torch

from mppiisaac_tpu.physics import math3d as jm
from mppiisaac_tpu_torch.physics import math3d as tm

torch.set_num_threads(1)
TOL = 1e-6


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _close(a, b, atol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol)


def test_quat_rotate_matches_matrix():
    rng = np.random.RandomState(0)
    q = rng.randn(32, 4).astype(np.float32)
    v = rng.randn(32, 3).astype(np.float32)
    jq = jm.quat_normalize(jnp.asarray(q))
    tq = tm.quat_normalize(_t(q))
    _close(tq, jq)
    _close(tm.quat_to_matrix(tq), jm.quat_to_matrix(jq))
    _close(tm.quat_rotate(tq, _t(v)), jm.quat_rotate(jq, jnp.asarray(v)))
    R = tm.quat_to_matrix(tq)
    _close(tm.quat_rotate(tq, _t(v)), torch.einsum("bij,bj->bi", R, _t(v)), atol=1e-5)


def test_quat_mul_compose():
    rng = np.random.RandomState(1)
    qa, qb = (rng.randn(8, 4).astype(np.float32) for _ in range(2))
    v = rng.randn(8, 3).astype(np.float32)
    jqa, jqb = jm.quat_normalize(jnp.asarray(qa)), jm.quat_normalize(jnp.asarray(qb))
    tqa, tqb = tm.quat_normalize(_t(qa)), tm.quat_normalize(_t(qb))
    _close(tm.quat_mul(tqa, tqb), jm.quat_mul(jqa, jqb))
    lhs = tm.quat_rotate(tm.quat_mul(tqa, tqb), _t(v))
    rhs = tm.quat_rotate(tqa, tm.quat_rotate(tqb, _t(v)))
    _close(lhs, rhs, atol=1e-5)
    _close(lhs, jm.quat_rotate(jm.quat_mul(jqa, jqb), jnp.asarray(v)))


def test_matrix_quat_roundtrip():
    rng = np.random.RandomState(2)
    q = rng.randn(64, 4).astype(np.float32)
    jq = np.asarray(jm.quat_normalize(jnp.asarray(q)))
    tq = tm.quat_normalize(_t(q))
    tq2 = tm.matrix_to_quat(tm.quat_to_matrix(tq))
    jq2 = np.asarray(jm.matrix_to_quat(jm.quat_to_matrix(jnp.asarray(jq))))
    _close(tq2, jq2)
    np.testing.assert_allclose(np.abs(np.sum(tq.numpy() * tq2.numpy(), -1)), 1.0, atol=1e-5)


def test_axis_angle_90deg():
    tq = tm.quat_from_axis_angle(_t([0.0, 0, 1]), torch.tensor(np.pi / 2, dtype=torch.float32))
    jq = jm.quat_from_axis_angle(jnp.array([0.0, 0, 1]), jnp.asarray(np.pi / 2, jnp.float32))
    _close(tq, jq)
    v = tm.quat_rotate(tq, _t([1.0, 0, 0]))
    _close(v, jm.quat_rotate(jq, jnp.array([1.0, 0, 0])))
    _close(v, [0, 1, 0])


def test_euler_roundtrip_and_yaw():
    rpy = [0.3, -0.4, 1.2]
    tq = tm.quat_from_euler_zyx(*rpy)
    jq = jm.quat_from_euler_zyx(*jnp.array(rpy))
    _close(tq, jq)
    r, p, y = tm.quat_to_euler_zyx(tq)
    _close([r, p, y], rpy)
    _close([r, p, y], jm.quat_to_euler_zyx(jq))
    _close(tm.quat_to_yaw(tq), jm.quat_to_yaw(jq))
    _close(tm.quat_to_yaw(tq), 1.2)
    # the kernels' atan2 pitch agrees with the arcsin form
    _close(tm.euler_zyx_atan2(tq), [r, p, y])


def test_quat_integrate_constant_omega():
    tq = tm.quat_identity()
    jq = jm.quat_identity()
    w = np.array([0.0, 0.0, np.pi], np.float32)
    for _ in range(100):
        tq = tm.quat_integrate(tq, _t(w), 0.01)
        jq = jm.quat_integrate(jq, jnp.asarray(w), 0.01)
    _close(tq, jq)
    _close(tm.quat_rotate(tq, _t([1.0, 0, 0])), [-1, 0, 0], atol=1e-4)


def test_transforms():
    p = _t([1.0, 2, 3])
    q = tm.quat_from_axis_angle(_t([0.0, 0, 1]), torch.tensor(np.pi / 2, dtype=torch.float32))
    jp = jnp.array([1.0, 2, 3])
    jq = jm.quat_from_axis_angle(jnp.array([0.0, 0, 1]), jnp.asarray(np.pi / 2, jnp.float32))
    pi, qi = tm.transform_inverse(p, q)
    jpi, jqi = jm.transform_inverse(jp, jq)
    _close(pi, jpi)
    _close(qi, jqi)
    p2, q2 = tm.transform_compose(p, q, pi, qi)
    _close(p2, 0)
    _close(np.abs(q2.numpy()[3]), 1)
    _close(tm.transform_apply(p, q, _t([1.0, 0, 0])), jm.transform_apply(jp, jq, jnp.array([1.0, 0, 0])))


def test_cholesky_matches_lanes():
    """The batched Cholesky solve against the lanes one (the TPU kernel's
    unrolled factor), batched over samples; the factor bit for bit."""
    from mppiisaac_tpu.ops.pallas import lanes

    rng = np.random.RandomState(3)
    A = rng.randn(5, 7, 7).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 7 * np.eye(7, dtype=np.float32)
    b = rng.randn(5, 7).astype(np.float32)
    x_t = tm.cholesky_solve_factored(tm.cholesky_factor(_t(M)), _t(b))
    Mj = [[jnp.asarray(M[:, i, j]) for j in range(7)] for i in range(7)]
    x_j = lanes.cholesky_solve(Mj, [jnp.asarray(b[:, i]) for i in range(7)])
    # the factor: the same subtractions in the same order as the lanes one
    L_t = tm.cholesky_factor(_t(M)).numpy()
    L_j = lanes.cholesky_factor(Mj)
    for i in range(7):
        for j in range(i + 1):
            np.testing.assert_array_equal(L_t[:, i, j], np.asarray(L_j[i][j]))
    _close(x_t, np.stack([np.asarray(x) for x in x_j], -1))
    _close(x_t, np.linalg.solve(M.astype(np.float64), b[..., None])[..., 0], atol=1e-5)
