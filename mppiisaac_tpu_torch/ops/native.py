"""Build and load the port's CUDA kernels (csrc/*.cu) as a plain C library.

`nvcc` compiles `csrc/fused_rollout.cu` (with the headers beside it) for
`sm_90a` into a shared library under `_build/`, named by a hash of the
sources and the flags, at the first call on a machine with the CUDA toolkit. The library is loaded with ctypes;
its functions take raw device pointers and the stream as `c_void_p`.

`VARIANT = "sections"` (set before the first load, by
scripts/profile_torch_step.py --sections) builds the same sources with
`-DSECTION_CLOCKS` into `_build/sections/`: the kernels then count clock64()
cycles per section, read back by `read_sections`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCE = os.path.join(CSRC, "fused_rollout.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


VARIANT = None          # None: the main build; "sections": the section counters
_DEFINES = {None: [], "sections": ["-DSECTION_CLOCKS"]}


def _flags():
    return NVCC_FLAGS + _DEFINES[VARIANT]


def library_path() -> str:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, VARIANT or "", f"libfused_rollout_{digest}.so")


def build() -> tuple:
    """Compile the library if its hashed file is missing.
    → (path, seconds spent compiling, ptxas report)."""
    out = library_path()
    report = out + ".ptxas.txt"
    if os.path.exists(out):
        with open(report) as f:
            return out, 0.0, f.read()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_flags(), "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    with open(report, "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)
    return out, seconds, proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernels with their ctypes signatures (built at first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.scene_tables_size.argtypes = []
    lib.scene_tables_size.restype = I
    lib.max_bounds.argtypes = [P]
    lib.max_bounds.restype = I
    lib.fused_rollout_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, F, I, I, I, I, P]
    lib.fused_rollout_launch.restype = I
    lib.fused_world_step_launch.argtypes = [P, P, P, P, P, P, I, F, I, I, P]
    lib.fused_world_step_launch.restype = I
    if VARIANT == "sections":
        lib.read_sections.argtypes = [P]
        lib.read_sections.restype = I
        lib.set_rollout_threads.argtypes = [I]
        lib.set_rollout_threads.restype = I
    return lib
