"""K1 and K2 times of one checkout of the port, for A/B runs of two commits
on one card.

    python scripts/ab_kernel_times.py ROOT [label]

Imports `mppiisaac_tpu_torch` from ROOT (this repository, or a checkout of
another commit unpacked into a directory of it that `.gitignore` lists; a
ROOT outside the repository is refused), builds its default kernel library
there, and times its K1 and K2 with CUDA events (`profile_kernel.time_ms` of
this repository: median of 50 launches after 5) at two shipped configs from their initial world states: panda reach
(K=500, H=12) and panda_pick (K=1000, H=12), controls uniform in ±0.3 from
seed 0. Prints one JSON line with the times, the card's name and power
limit. Run the two checkouts in turns in one call (A, B, B, A): times from
different calls may come from different cards.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def _time_ms():
    """This repository's `profile_kernel.time_ms`, loaded from its file, so
    that ROOT's package (which may predate it) is the one imported."""
    path = os.path.join(REPO, "mppiisaac_tpu_torch", "profile_kernel.py")
    spec = importlib.util.spec_from_file_location("_ab_profile_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.time_ms


def main(root, label):
    root = os.path.realpath(root)
    if root != REPO and not root.startswith(REPO + os.sep):
        raise SystemExit(f"ROOT {root} lies outside the repository {REPO}")
    time_ms = _time_ms()
    sys.path.insert(0, root)
    import torch

    from mppiisaac_tpu_torch.ops import native
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.physics.types import ModelParams
    from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
    from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective
    from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective
    from mppiisaac_tpu_torch.utils.config_store import load_config

    assert os.path.dirname(native.__file__).startswith(root)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0

    res = {"label": label, "root": root, "build_s": build_s}
    for task, Obj in (("panda", PandaReachObjective), ("panda_pick", PandaPickObjective)):
        cfg = load_config(f"tasks/{task}")
        w = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device=dev)
        b = w.built
        K, H = cfg.mppi.num_samples, cfg.mppi.horizon
        fr = FusedRollout(b, w.engine, Obj(cfg).kernel_cost(b), H, K, vis_body=b.visualize_bodies[0],
                          impulse_sweeps=cfg.mppi.rollout_sweeps)
        g = torch.Generator().manual_seed(0)
        V = (torch.rand(K, H, fr.nu, generator=g) * 0.6 - 0.3).to(dev)
        st = w.state.map(lambda x: x[0])
        pm = ModelParams(torch.ones(K, b.scene.nbody, device=dev),
                         torch.ones(K, b.scene.ngeom, device=dev))
        k1_in = fr.pack(broadcast_state(st, K), pm, V)
        fw = FusedWorldStep(b, w.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
        k2_in = (fw.pack(st).contiguous(), st.q.contiguous(),
                 torch.ones(b.scene.nbody, device=dev), torch.ones(b.scene.ngeom, device=dev))
        res[f"{task}_k1_ms"] = time_ms(lambda: fr.run(*k1_in), reps=50, warmup=5)
        res[f"{task}_k2_ms"] = time_ms(lambda: fw.step_rows(*k2_in), reps=50, warmup=5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    res["card"] = smi.stdout.strip()
    print("AB " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else sys.argv[1])
