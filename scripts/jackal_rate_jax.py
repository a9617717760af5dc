"""multi_jackal's success rate in the JAX package, on the host CPU.

    python -u scripts/jackal_rate_jax.py [n_seeds] [n_steps] [out.json]

Runs `mppiisaac_tpu.runtime.loop.run_task_episodes` for multi_jackal at the
conf's K=300, H=12, with the XLA rollout (the JAX package's CPU default), at
seeds 0 .. n_seeds-1 (default 5) and n_steps control steps each (default 400),
success as `tasks/multi_robot.run` defines it (both jackals within 0.25 m of
their goals). Every episode runs on one build, chunked at device_steps=16, as
the port's `python -m mppiisaac_tpu_torch.validate jackal` does on the card.

Each chunk prints `chunk @<step>` (the JAX loop's verbose line) and each seed
prints its summary, so a run cut short still shows how far every seed got.
The summary JSON goes to out.json (default chiprun_out/jackal_rate_jax.json).
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from mppiisaac_tpu.runtime.loop import run_task_episodes  # noqa: E402
from mppiisaac_tpu.tasks.multi_robot import MultiJackalObjective  # noqa: E402
from mppiisaac_tpu.utils.config_store import load_config  # noqa: E402


def main(argv):
    n_seeds = int(argv[0]) if len(argv) > 0 else 5
    n_steps = int(argv[1]) if len(argv) > 1 else 400
    out = argv[2] if len(argv) > 2 else os.path.join(REPO, "chiprun_out", "jackal_rate_jax.json")
    cfg = load_config("tasks/multi_jackal", None)
    obj = MultiJackalObjective(cfg)

    def success(world):
        idxs = MultiJackalObjective._robot_actor_indices(world.built.scene)
        rp = np.asarray(world.state.root_pos[0])
        return all(np.linalg.norm(rp[i, :2] - g) < 0.25 for i, g in zip(idxs, obj.goals))

    t0 = time.perf_counter()
    res = run_task_episodes(cfg, obj, list(range(n_seeds)), n_steps=n_steps,
                            success_fn=success, device_steps=16, verbose=True)
    summary = {
        "task": "multi_jackal", "backend": jax.default_backend(),
        "K": cfg.mppi.num_samples, "H": cfg.mppi.horizon, "n_steps": n_steps,
        "success_steps": {int(s): m.success_step for s, m in res.items()},
        "steps": {int(s): m.steps for s, m in res.items()},
        "successes": sum(m.success_step is not None for m in res.values()),
        "episodes": len(res),
        "median_ms_per_step": float(np.median(
            [t for m in res.values() for t in m.solver_time])) * 1e3,
        "wall_s": time.perf_counter() - t0,
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print("JACKAL_JAX " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
