"""Build and load the port's CUDA kernels (csrc/*.cu) as a plain C library.

`nvcc` compiles `csrc/fused_rollout.cu` (with the headers beside it) for
`sm_90a` into a shared library under `_build/`, named by a hash of the
sources and the flags, at the first call on a machine with the CUDA toolkit. The library is loaded with ctypes;
its functions take raw device pointers and the stream as `c_void_p`.

`VARIANT = "sections"` (set before the first load, by
scripts/profile_torch_step.py --sections) builds the same sources with
`-DSECTION_CLOCKS` into `_build/sections/`: the kernels then count clock64()
cycles per section, read back by `read_sections`.

`VARIANT = "nofma"` builds them with `--fmad=false` into `_build/nofma/`:
nvcc then contracts no multiply and add into an FMA, so the kernels round
as the device code's CPU emulation does (csrc/emu; a rounding study's
twin of the default build: `scripts/jackal_commands_jax.py --replay
--no-fma`).

Every variant counts K1's Ψ columns, solved and held, in device globals
that `psi_columns` reads (`FusedRollout.psi_columns`).

`load_library("ablate")` builds, beside whichever library the wrappers use,
the profiling ablations (`-DABLATE`, into `_build/ablate/`): one nvcc run
instantiates the kernels for every mask of AB_K1_MASKS and AB_K2_MASKS
(csrc/scene_tables.cuh), launched by `fused_rollout_launch_ablate` and
`fused_world_step_launch_ablate` with the mask first. It has no default
launchers; only the wrappers built with `profile=` reach it.
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
ABLATE = "ablate"       # the profiling ablations' library
_DEFINES = {None: [], "sections": ["-DSECTION_CLOCKS"], ABLATE: ["-DABLATE"],
            "nofma": ["--fmad=false"]}


def _flags(variant):
    return NVCC_FLAGS + _DEFINES[variant]


def library_path(variant=None) -> str:
    """The library of `variant` (None: VARIANT's)."""
    variant = variant or VARIANT
    h = hashlib.sha256(" ".join(_flags(variant)).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, variant or "", f"libfused_rollout_{digest}.so")


def build(variant=None) -> tuple:
    """Compile the library of `variant` (None: VARIANT's) if its hashed file
    is missing. → (path, seconds spent compiling, ptxas report)."""
    variant = variant or VARIANT
    out = library_path(variant)
    report = out + ".ptxas.txt"
    if os.path.exists(out):
        with open(report) as f:
            return out, 0.0, f.read()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_flags(variant), "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    with open(report, "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)
    return out, seconds, proc.stderr


def load_library(variant=None) -> ctypes.CDLL:
    """The built kernels of `variant` (None: VARIANT's) with their ctypes
    signatures, built at first use."""
    return _load(variant or VARIANT)


@functools.lru_cache(maxsize=None)
def _load(variant) -> ctypes.CDLL:
    path, _, _ = build(variant)
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.scene_tables_size.argtypes = []
    lib.scene_tables_size.restype = I
    lib.max_bounds.argtypes = [P]
    lib.max_bounds.restype = I
    lib.psi_columns.argtypes = [P]
    lib.psi_columns.restype = I
    if variant == ABLATE:
        lib.fused_rollout_launch_ablate.argtypes = [I, P, P, P, P, P, P, P, I, I, I, F, I, I, I, I, P]
        lib.fused_rollout_launch_ablate.restype = I
        lib.fused_world_step_launch_ablate.argtypes = [I, P, P, P, P, P, P, P, I, I, F, I, I, I, P]
        lib.fused_world_step_launch_ablate.restype = I
        return lib
    lib.fused_rollout_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, F, I, I, I, I, P]
    lib.fused_rollout_launch.restype = I
    lib.fused_world_step_launch.argtypes = [P, P, P, P, P, P, P, I, I, F, I, I, I, P]
    lib.fused_world_step_launch.restype = I
    if variant == "sections":
        lib.read_sections.argtypes = [P]
        lib.read_sections.restype = I
        lib.set_rollout_threads.argtypes = [I]
        lib.set_rollout_threads.restype = I
    return lib
