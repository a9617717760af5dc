# Frozen copy of mppiisaac_tpu_torch/scene/assets.py, part of the benchmark's yardstick.
"""Mesh collision fitting: a URDF `<collision><mesh>` element reduced to the
bounding sphere, capsule or box the contact kernels take.

Counterpart of the JAX package's `scene/assets.py` and its native fitter
`csrc/meshfit.cpp`, written in numpy and run once per scene build. The fit
is the C++ one operation for operation, so that the host tables come out
bit for bit the same: every sum over vertices is accumulated sequentially
in vertex order (`np.add.accumulate`, never the pairwise `np.sum`), every
vertex expression keeps the C++ association, and the small eigenproblem,
the sort and the quaternion are scalar Python floats (IEEE doubles, as the
C++ doubles). The choice among sphere, capsule and box sits on thresholds
(0.08·r, 2·cross), which a rounding difference could flip.

Meshes: OBJ `v` lines, ASCII STL `vertex` lines and binary STL, told apart
as the C++ loader does (an `.obj`/`.OBJ` name is OBJ; otherwise a file that
starts with `solid` is tried as ASCII STL first). A file that is missing or
holds no vertex raises, naming the file: the port never drops a geom.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np

from ..physics.urdf import GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, UrdfGeom

KIND_SPHERE, KIND_BOX, KIND_CAPSULE = 0, 1, 2
_LINE = 1023            # the C++ loader reads lines through a 1024-byte fgets buffer
# the prefix of a token that C's strtod (sscanf %lf) reads as a number
_NUM = re.compile(rb"[ \t\n\v\f\r]*([+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
                  rb"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN]))")


def _scan3(text: bytes):
    """sscanf(text, "%lf %lf %lf") == 3 → the three values, else None."""
    out, pos = [], 0
    for _ in range(3):
        m = _NUM.match(text, pos)
        if m is None:
            return None
        out.append(float(m.group(1)))
        pos = m.end()
    return out


def _lines(data: bytes):
    """The lines fgets returns with a 1024-byte buffer (long lines in parts)."""
    for line in data.split(b"\n"):
        while len(line) > _LINE:
            yield line[:_LINE]
            line = line[_LINE:]
        yield line


def _load_ascii(data: bytes, obj: bool):
    verts = []
    for line in _lines(data):
        if obj:
            if len(line) > 1 and line[0:1] == b"v" and line[1:2] in (b" ", b"\t"):
                v = _scan3(line[1:])
                if v is not None:
                    verts.append(v)
        else:
            i = line.find(b"vertex")
            if i >= 0:
                v = _scan3(line[i + 6:])
                if v is not None:
                    verts.append(v)
    return verts


def _load_binary_stl(data: bytes):
    if len(data) < 84:
        return None
    ntri = int(np.frombuffer(data, np.uint32, 1, 80)[0])
    if ntri == 0 or ntri > 50_000_000 or len(data) < 84 + 50 * ntri:
        return None
    tri = np.frombuffer(data, np.dtype([("f", "<f4", (12,)), ("a", "<u2")]), ntri, 84)
    return tri["f"][:, 3:12].reshape(-1, 3).astype(np.float64)


def load_mesh_vertices(path: str) -> np.ndarray:
    """(n, 3) float64 vertices of an OBJ or STL file; raises when the file is
    missing or yields none."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(f"mesh collision file {path!r} cannot be read: {e}") from e
    if path.endswith((".obj", ".OBJ")) and len(path) > 4:
        verts = _load_ascii(data, obj=True)
    elif data[:5] == b"solid":
        verts = _load_ascii(data, obj=False) or _load_binary_stl(data)
    else:
        verts = _load_binary_stl(data)
    if verts is None or len(verts) == 0:
        raise ValueError(f"mesh collision file {path!r} holds no vertex the fitter reads")
    return np.asarray(verts, np.float64).reshape(-1, 3)


def _seq_sum(x: np.ndarray) -> float:
    """x[0] + x[1] + … in order (the C++ loop's accumulation)."""
    return float(np.add.accumulate(x)[-1])


def _jacobi3(A):
    """Symmetric 3×3 eigenvectors by Jacobi rotations (meshfit.cpp jacobi3):
    → (V with the eigenvectors as columns, eigenvalues)."""
    V = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    for _ in range(32):
        off = abs(A[0][1]) + abs(A[0][2]) + abs(A[1][2])
        if off < 1e-12:
            break
        for p in range(2):
            for q in range(p + 1, 3):
                if abs(A[p][q]) < 1e-15:
                    continue
                theta = (A[q][q] - A[p][p]) / (2.0 * A[p][q])
                t = (1.0 if theta >= 0 else -1.0) / (abs(theta) + math.sqrt(theta * theta + 1.0))
                c = 1.0 / math.sqrt(t * t + 1.0)
                s = t * c
                for k in range(3):
                    akp, akq = A[k][p], A[k][q]
                    A[k][p] = c * akp - s * akq
                    A[k][q] = s * akp + c * akq
                for k in range(3):
                    apk, aqk = A[p][k], A[q][k]
                    A[p][k] = c * apk - s * aqk
                    A[q][k] = s * apk + c * aqk
                for k in range(3):
                    vkp, vkq = V[k][p], V[k][q]
                    V[k][p] = c * vkp - s * vkq
                    V[k][q] = s * vkp + c * vkq
    return V, [A[i][i] for i in range(3)]


def _proj(d, a):
    """d · a per vertex, summed x, then y, then z."""
    return d[:, 0] * a[0] + d[:, 1] * a[1] + d[:, 2] * a[2]


def _quat_of(R):
    """Rotation matrix → quaternion xyzw (meshfit.cpp's branches)."""
    tr = R[0][0] + R[1][1] + R[2][2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        return ((R[2][1] - R[1][2]) / s, (R[0][2] - R[2][0]) / s, (R[1][0] - R[0][1]) / s, 0.25 * s)
    if R[0][0] > R[1][1] and R[0][0] > R[2][2]:
        s = math.sqrt(1.0 + R[0][0] - R[1][1] - R[2][2]) * 2
        return (0.25 * s, (R[0][1] + R[1][0]) / s, (R[0][2] + R[2][0]) / s, (R[2][1] - R[1][2]) / s)
    if R[1][1] > R[2][2]:
        s = math.sqrt(1.0 + R[1][1] - R[0][0] - R[2][2]) * 2
        return ((R[0][1] + R[1][0]) / s, 0.25 * s, (R[1][2] + R[2][1]) / s, (R[0][2] - R[2][0]) / s)
    s = math.sqrt(1.0 + R[2][2] - R[0][0] - R[1][1]) * 2
    return ((R[0][2] + R[2][0]) / s, (R[1][2] + R[2][1]) / s, 0.25 * s, (R[1][0] - R[0][1]) / s)


def fit_vertices(verts: np.ndarray) -> dict:
    """Bounding primitive of a (scaled) vertex cloud in its mesh frame
    (meshfit.cpp meshfit_file after loading). → dict(kind (KIND_*), pos (3),
    quat (4, xyzw), params (3), half_extents (3), nverts), all float64:
    a sphere's params are (r, 0, 0), a capsule's (r, half length, 0) about
    its local z, a box's its half extents."""
    v = np.asarray(verts, np.float64)
    n = float(len(v))
    mu = [_seq_sum(v[:, i]) / n for i in range(3)]
    d = np.stack([v[:, i] - mu[i] for i in range(3)], 1)
    C = [[_seq_sum(d[:, i] * d[:, j] / n) for j in range(3)] for i in range(3)]
    V, w = _jacobi3(C)
    order = [0, 1, 2]
    for i in range(3):
        for j in range(i + 1, 3):
            if w[order[j]] > w[order[i]]:
                order[i], order[j] = order[j], order[i]
    axes = [[V[i][order[k]] for i in range(3)] for k in range(3)]
    cx = axes[0][1] * axes[1][2] - axes[0][2] * axes[1][1]
    cy = axes[0][2] * axes[1][0] - axes[0][0] * axes[1][2]
    cz = axes[0][0] * axes[1][1] - axes[0][1] * axes[1][0]
    if cx * axes[2][0] + cy * axes[2][1] + cz * axes[2][2] < 0:
        axes[2] = [-a for a in axes[2]]

    # extents in the principal frame
    pr = [_proj(d, axes[k]) for k in range(3)]
    lo = [min(1e30, float(pr[k].min())) for k in range(3)]
    hi = [max(-1e30, float(pr[k].max())) for k in range(3)]
    rmax = max(0.0, float(np.sqrt(pr[1] * pr[1] + pr[2] * pr[2]).max()))
    he = [(hi[k] - lo[k]) / 2 for k in range(3)]
    ctr_p = [(hi[k] + lo[k]) / 2 for k in range(3)]
    ctr = list(mu)
    for k in range(3):
        for i in range(3):
            ctr[i] += ctr_p[k] * axes[k][i]

    # the sphere's and each principal capsule's radial spread
    dc = np.stack([v[:, i] - ctr[i] for i in range(3)], 1)
    r = np.sqrt(dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] + dc[:, 2] * dc[:, 2])
    sph_lo, sph_hi = min(1e30, float(r.min())), max(0.0, float(r.max()))
    best_axis, best_spread, best_r, best_hl = -1, 1e30, 0.0, 0.0
    for k in range(3):
        pa = _proj(dc, axes[k])
        p1 = _proj(dc, axes[(k + 1) % 3])
        p2 = _proj(dc, axes[(k + 2) % 3])
        rk = max(0.0, float(np.sqrt(p1 * p1 + p2 * p2).max()))
        hlk = max(he[k] - rk, 0.0)
        ax = np.maximum(np.abs(pa) - hlk, 0.0)
        ds = np.sqrt(p1 * p1 + p2 * p2 + ax * ax)
        lo_d, hi_d = min(1e30, float(ds.min())), max(0.0, float(ds.max()))
        if hi_d - lo_d < best_spread:
            best_spread, best_axis, best_r, best_hl = hi_d - lo_d, k, rk, hlk

    cross_ = max(he[1], he[2])
    sphere_exact = sph_hi - sph_lo <= 0.08 * max(sph_hi, 1e-6)
    capsule_exact = best_spread <= 0.08 * max(best_r, 1e-6)
    if capsule_exact and sphere_exact:
        sphere_exact = (sph_hi - sph_lo) <= best_spread
    capsule_elong = he[0] >= 2.0 * cross_ and rmax <= 1.1 * cross_
    if sphere_exact:
        kind, params = KIND_SPHERE, (sph_hi, 0.0, 0.0)
    elif not capsule_exact and capsule_elong:
        kind, params = KIND_CAPSULE, (rmax, max(he[0] - rmax, 1e-4), 0.0)
    elif capsule_exact:
        kind, params = KIND_CAPSULE, (best_r, max(best_hl, 1e-4), 0.0)
        if best_axis != 0:
            axes[0], axes[best_axis] = axes[best_axis], axes[0]
    else:
        kind, params = KIND_BOX, (he[1], he[2], he[0])
    # columns: principal axes 1, 2, 0 (the capsule's axis is the local z)
    R = [[axes[1][i], axes[2][i], axes[0][i]] for i in range(3)]
    return dict(kind=kind, pos=np.asarray(ctr), quat=np.asarray(_quat_of(R)),
                params=np.asarray(params), half_extents=np.asarray(he), nverts=int(n))


_FITS: Dict[Tuple[str, Tuple[float, float, float]], dict] = {}


def mesh_fit_file(path: str, scale=(1.0, 1.0, 1.0)) -> dict:
    """fit_vertices of a mesh file scaled per axis, cached by (path, scale)."""
    key = (path, tuple(float(s) for s in np.asarray(scale, np.float64)))
    fit = _FITS.get(key)
    if fit is None:
        v = load_mesh_vertices(path)
        fit = _FITS[key] = fit_vertices(v * np.asarray(key[1]))
    return fit


def _f32(x):
    return np.asarray(x, np.float32)


def _cross32(a, b):
    return np.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def _quat_rotate32(q, v):
    """float32 rotation of v by q (xyzw): v + w·t + u×t, t = 2·(u×v), the
    expression order of the JAX package's physics/math3d.quat_rotate."""
    u, w = q[:3], q[3]
    t = np.float32(2.0) * _cross32(u, v)
    return v + w * t + _cross32(u, t)


def _quat_mul32(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz])


def mesh_fit(path: str, scale, origin_pos, origin_quat) -> UrdfGeom:
    """URDF mesh collision element → primitive UrdfGeom: the fit's pose
    composed with the collision origin (the rotation and product in float32,
    the origin's offset added in float64, as the JAX package does)."""
    fit = mesh_fit_file(path, scale)
    oq = _f32(origin_quat)
    p = np.asarray(origin_pos) + _quat_rotate32(oq, _f32(fit["pos"]))
    q = _quat_mul32(oq, _f32(fit["quat"]))
    if fit["kind"] == KIND_CAPSULE:
        return UrdfGeom(GEOM_CAPSULE, np.array([fit["params"][0], fit["params"][1], 0.0]), p, q)
    if fit["kind"] == KIND_SPHERE:
        # wheels and feet stay round: a box's corners would catch the ground
        return UrdfGeom(GEOM_SPHERE, np.array([fit["params"][0], 0.0, 0.0]), p, q)
    return UrdfGeom(GEOM_BOX, np.asarray(fit["params"]), p, q)


def load_urdf_file(path: str):
    """Parse a user URDF file with mesh fitting on (the JAX package's
    `load_urdf_file`)."""
    from ..physics.urdf import parse_urdf

    return parse_urdf(path, mesh_fit=mesh_fit)
