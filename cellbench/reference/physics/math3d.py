# Frozen copy of mppiisaac_tpu_torch/physics/math3d.py, part of the benchmark's yardstick.
"""Quaternion / SO(3) / SE(3) math and small dense solves, batched, torch.

One module for what the JAX package splits between `physics/math3d.py`
(batched arrays) and `ops/pallas/lanes.py` (per-component tiles): here every
function takes tensors whose trailing axis is the vector (3) or quaternion (4)
and broadcasts over the leading axes, so the physics twin runs it on (K, 3)
sample batches and the host code on single poses alike.

Conventions: quaternions are ``(x, y, z, w)`` (the reference's root-state
layout); Z-up.
"""
from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def norm(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """sqrt(a·a + eps) — the lanes form, whose eps sits inside the root."""
    return torch.sqrt(dot(a, a) + eps)


def quat_identity(shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, both xyzw."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (xyzw)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """axis (...,3) assumed unit; angle (...)."""
    half = 0.5 * angle
    s = torch.sin(half)
    axis, s = torch.broadcast_tensors(axis, s[..., None])
    return torch.cat([axis * s, torch.cos(half)[..., None].expand(s.shape[:-1] + (1,))], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) xyzw → (...,3,3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(...,3,3) → (...,4) xyzw. Branch-free (Shepperd via max trace choice)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    best = torch.argmax(torch.stack([qx2, qy2, qz2, qw2], dim=-1), dim=-1)

    def half_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 0.5

    sx, sy, sz, sw = half_sqrt(qx2), half_sqrt(qy2), half_sqrt(qz2), half_sqrt(qw2)
    cand = torch.stack(
        [
            torch.stack([sx, (m01 + m10) / (4 * sx), (m02 + m20) / (4 * sx), (m21 - m12) / (4 * sx)], -1),
            torch.stack([(m01 + m10) / (4 * sy), sy, (m12 + m21) / (4 * sy), (m02 - m20) / (4 * sy)], -1),
            torch.stack([(m02 + m20) / (4 * sz), (m12 + m21) / (4 * sz), sz, (m10 - m01) / (4 * sz)], -1),
            torch.stack([(m21 - m12) / (4 * sw), (m02 - m20) / (4 * sw), (m10 - m01) / (4 * sw), sw], -1),
        ],
        dim=-2,
    )
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return quat_normalize(torch.gather(cand, -2, idx)[..., 0, :])


def quat_from_euler_zyx(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic ZYX (yaw-pitch-roll) Euler → quat xyzw."""
    roll, pitch, yaw = (torch.as_tensor(x, dtype=torch.float32) for x in (roll, pitch, yaw))
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def quat_to_euler_zyx(q: torch.Tensor):
    """quat xyzw → (roll, pitch, yaw), pitch by arcsin."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def euler_zyx_atan2(q: torch.Tensor):
    """(roll, pitch, yaw) with pitch = atan2(s, sqrt(max(1 − s², 1e-12))):
    the form of the fused kernel's cost (lanes `euler_zyx`), with the
    library atan2 where the TPU kernel used a ~1e-6 rad polynomial."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sp = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.atan2(sp, torch.sqrt(torch.clamp(1.0 - sp * sp, min=1e-12)))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def qintegrate(q: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """The lanes form of `quat_integrate` (fused kernels): the angle's root
    carries eps 1e-9 and the normalisation eps 1e-12 inside the root."""
    angle = torch.sqrt(dot(w, w) + 1e-9)
    axis = w * (1.0 / torch.clamp(angle, min=1e-9))[..., None]
    dq = quat_from_axis_angle(axis, angle * dt)
    p = quat_mul(dq, q)
    return p * (1.0 / torch.sqrt(dot(p, p) + 1e-12))[..., None]


def point_to_box(point: torch.Tensor, box_pos: torch.Tensor, box_quat: torch.Tensor, half):
    """Closest-feature query of point(s) against a box of half extents
    `half` (3 floats) → (world normal, depth (>0 inside), world surface
    point); the lanes `_point_to_box_lanes`."""
    lp = quat_rotate_inv(box_quat, point - box_pos)
    hv = torch.as_tensor(half, dtype=lp.dtype, device=lp.device)
    cl = torch.maximum(torch.minimum(lp, hv), -hv)
    ov = lp - cl
    od = torch.sqrt(dot(ov, ov))
    is_out = od > 1e-9
    fd = hv - lp.abs()
    dmin = torch.minimum(torch.minimum(fd[..., 0], fd[..., 1]), fd[..., 2])
    sel0 = fd[..., 0] <= torch.minimum(fd[..., 1], fd[..., 2])
    sel1 = (~sel0) & (fd[..., 1] <= fd[..., 2])
    sel2 = ~(sel0 | sel1)
    sgn = torch.sign(lp)
    n_in = torch.stack([torch.where(sel0, sgn[..., 0], 0.0), torch.where(sel1, sgn[..., 1], 0.0),
                        torch.where(sel2, sgn[..., 2], 0.0)], -1)
    n_out = ov * (1.0 / torch.clamp(od, min=1e-9))[..., None]
    n_loc = torch.where(is_out[..., None], n_out, n_in)
    depth = torch.where(is_out, -od, dmin)
    surf_loc = torch.where(is_out[..., None], cl, lp + n_in * dmin[..., None])
    return quat_rotate(box_quat, n_loc), depth, box_pos + quat_rotate(box_quat, surf_loc)


def segment_closest(p0, p1, q0, q1, eps: float = 1e-9):
    """Closest points of segments p0p1 and q0q1 (the lanes
    `_segment_closest_lanes`)."""
    d1, d2, r = p1 - p0, q1 - q0, p0 - q0
    a, e, f = dot(d1, d1), dot(d2, d2), dot(d2, r)
    c, b = dot(d1, r), dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > eps, torch.clamp((b * f - c * e) / torch.clamp(denom, min=eps), 0.0, 1.0), 0.0)
    t = torch.where(e > eps, torch.clamp((b * s + f) / torch.clamp(e, min=eps), 0.0, 1.0), 0.0)
    s = torch.where(a > eps, torch.clamp((b * t - c) / torch.clamp(a, min=eps), 0.0, 1.0), 0.0)
    return p0 + d1 * s[..., None], q0 + d2 * t[..., None]


def quat_to_yaw(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation by world-frame angular velocity for dt (exponential map)."""
    angle = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / torch.clamp(angle, min=1e-9)
    dq = quat_from_axis_angle(axis, (angle * dt)[..., 0])
    return quat_normalize(quat_mul(dq, q))


# ---------------------------------------------------------------------------
# SE(3) transforms: (pos (...,3), quat (...,4)) pairs
# ---------------------------------------------------------------------------

def transform_apply(pos, quat, point):
    return pos + quat_rotate(quat, point)


def transform_compose(pa, qa, pb, qb):
    """(pa,qa) ∘ (pb,qb): first apply b, then a."""
    return pa + quat_rotate(qa, pb), quat_mul(qa, qb)


def transform_inverse(p, q):
    qi = quat_conjugate(q)
    return -quat_rotate(qi, p), qi


# ---------------------------------------------------------------------------
# small SPD solves, batched: M is (..., n, n) with n static and small
# ---------------------------------------------------------------------------

def cholesky_factor(M: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Lower factor L (..., n, n) of SPD M, each pivot clamped to eps before
    its root as in the kernels' unrolled factor (`chol_factor`, lanes
    `cholesky_factor`). Right-looking: column j is scaled by 1/L_jj and the
    trailing block takes its rank-1 update, so every entry sees the same
    subtractions in the same order as the unrolled factor, in a few tensor
    ops per column over the whole batch.

    Not `torch.linalg.cholesky`: it raises on a pivot that is not positive
    where the kernels clamp, and its error check syncs with the host, which
    a CUDA graph cannot capture."""
    n = M.shape[-1]
    A = M
    cols = []
    for _ in range(n):
        Ljj = torch.sqrt(torch.clamp(A[..., 0, 0], min=eps))
        col = A[..., 1:, 0] * (1.0 / Ljj)[..., None]
        cols.append(torch.cat([Ljj[..., None], col], -1))
        A = A[..., 1:, 1:] - col[..., :, None] * col[..., None, :]
    # column j holds rows j..n-1: pad its top with zeros
    z = M.new_zeros(M.shape[:-2] + (n,))
    return torch.stack([torch.cat([z[..., :j], c], -1) for j, c in enumerate(cols)], -1)


def cholesky_solve_factored(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) X = B with the factor of `cholesky_factor`: L (..., n, n),
    B (..., n) or (..., n, m). Column-oriented: each solved entry is
    subtracted from the rows still to solve at once. The forward pass
    subtracts in the kernels' order; the back pass from the last row up,
    the reverse of their dot products, so the two differ by roundings."""
    vec = B.dim() == L.dim() - 1
    X = B[..., None] if vec else B
    n = L.shape[-1]
    d = torch.diagonal(L, dim1=-2, dim2=-1)[..., None]          # (..., n, 1)
    ys = []
    s = X
    for k in range(n):
        yk = s[..., :1, :] / d[..., k:k + 1, :]
        ys.append(yk)
        s = s[..., 1:, :] - L[..., k + 1:, k:k + 1] * yk
    t = torch.cat(ys, -2)
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        xk = t[..., k:k + 1, :] / d[..., k:k + 1, :]
        xs[k] = xk
        t = t[..., :k, :] - L[..., k:k + 1, :k].transpose(-1, -2) * xk
    x = torch.cat(xs, -2)
    return x[..., 0] if vec else x
