"""The port's mesh collision fitter (mppiisaac_tpu_torch/scene/assets.py)
against the JAX package's native one (`csrc/meshfit.cpp` through
`mppiisaac_tpu.ops.native.meshfit`, and `scene/assets.mesh_fit` for the
pose composed with a collision origin): one case per OBJ mesh under
`assets/`, plus ASCII and binary STL files written here.

Tolerance: none. The kind must be the same and every number equal
(`np.array_equal`): the port accumulates its sums in the C++ order and
composes the pose in float32 in the JAX package's operation order, and the
kind choice sits on thresholds that a rounding difference could flip.
"""
import glob
import os
import struct

import numpy as np
import pytest

from mppiisaac_tpu.ops import native as j_native
from mppiisaac_tpu.scene.assets import mesh_fit as j_mesh_fit

from mppiisaac_tpu_torch.scene import assets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = sorted(os.path.relpath(p, REPO)
                for p in glob.glob(os.path.join(REPO, "assets", "**", "*.obj"), recursive=True))
FIELDS = ("pos", "quat", "params", "half_extents")


def _same_fit(path, scale):
    ref = j_native.meshfit(path, scale)
    got = assets.mesh_fit_file(path, scale)
    assert ref is not None
    assert got["kind"] == ref["kind"] and got["nverts"] == ref["nverts"]
    for f in FIELDS:
        assert np.array_equal(got[f], ref[f]), f
    return got


def _same_geom(path, scale, origin_pos, origin_quat):
    ref = j_mesh_fit(path, scale, origin_pos, origin_quat)
    got = assets.mesh_fit(path, scale, origin_pos, origin_quat)
    for f in ("gtype", "size", "pos", "quat"):
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))), f


def test_every_mesh_is_found():
    """63 OBJ meshes: 8 fit as spheres, 11 as boxes, 44 as capsules."""
    kinds = [assets.mesh_fit_file(os.path.join(REPO, m))["kind"] for m in MESHES]
    assert len(MESHES) == 63
    assert [kinds.count(k) for k in (assets.KIND_SPHERE, assets.KIND_BOX, assets.KIND_CAPSULE)] \
        == [8, 11, 44]


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_fit_matches_native(mesh):
    """The fit at unit scale and at an anisotropic scale, then the fitted
    pose composed with a random collision origin."""
    path = os.path.join(REPO, mesh)
    _same_fit(path, (1.0, 1.0, 1.0))
    _same_fit(path, (0.5, 1.2, 0.9))
    rng = np.random.RandomState(sum(map(ord, mesh)))
    q = rng.randn(4)
    _same_geom(path, (1.0, 1.0, 1.0), rng.uniform(-0.5, 0.5, 3), q / np.linalg.norm(q))


def _cloud(rng):
    """A cylinder's wall and caps: a capsule-like cloud of 200 points."""
    a = rng.uniform(0, 2 * np.pi, 200)
    z = rng.uniform(-0.2, 0.2, 200)
    return np.stack([0.05 * np.cos(a), 0.05 * np.sin(a), z], 1)


def test_stl_files_match_native(tmp_path):
    """An ASCII STL, a binary STL and a binary STL whose header starts with
    `solid` (the loader falls back to binary when no ASCII vertex reads)."""
    v = _cloud(np.random.RandomState(0)).astype(np.float32)[:198].reshape(-1, 3, 3)
    ascii_path = tmp_path / "cyl_ascii.stl"
    lines = ["solid cyl"]
    for tri in v:
        lines += ["facet normal 0 0 1", " outer loop"]
        lines += [f"  vertex {x:.6e} {y:.6e} {z:.6e}" for x, y, z in tri]
        lines += [" endloop", "endfacet"]
    ascii_path.write_text("\n".join(lines + ["endsolid cyl", ""]))
    for name, header in (("cyl_bin.stl", b"binary"), ("cyl_solid.stl", b"solid but binary")):
        body = b"".join(struct.pack("<12fH", 0.0, 0.0, 1.0, *tri.reshape(-1), 0) for tri in v)
        (tmp_path / name).write_bytes(header.ljust(80, b" ") + struct.pack("<I", len(v)) + body)
    for name in ("cyl_ascii.stl", "cyl_bin.stl", "cyl_solid.stl"):
        fit = _same_fit(str(tmp_path / name), (1.0, 1.0, 1.0))
        assert fit["nverts"] == 3 * len(v)


def test_missing_or_empty_mesh_raises(tmp_path):
    """Where the JAX package's fitter returns None and drops the geom, the
    port raises naming the file."""
    missing = str(tmp_path / "nowhere.obj")
    assert j_native.meshfit(missing) is None
    with pytest.raises(FileNotFoundError, match="nowhere.obj"):
        assets.mesh_fit(missing, (1.0, 1.0, 1.0), np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    empty = tmp_path / "empty.obj"
    empty.write_text("# no vertices\nf 1 2 3\n")
    assert j_native.meshfit(str(empty)) is None
    with pytest.raises(ValueError, match="empty.obj"):
        assets.mesh_fit_file(str(empty))
