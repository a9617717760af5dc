"""Where K1's time goes, by ablation: the port's twin of the JAX package's
`scripts/profile_kernel.py`.

    python -m mppiisaac_tpu_torch.profile_kernel [fast|world] [substeps] [sweeps] [manifold] [sections]

The workload is the bench twin's (`mppiisaac_tpu_torch.bench`): panda_pick at
K=1000, H=30, from the planner's K-wide rollout state with its randomized
model parameters, controls 0.1·N(0, 1) from seed 0; by default at the bench
twin's settings (world fidelity, the conf's substeps and sweeps, the reduced
manifold), where the JAX script defaults to fast fidelity. Each variant is a
FusedRollout with `profile=` (the ablation library, ops/native.py ABLATE)
or with its sweeps set to 0 (the default library), timed with CUDA events
as the median of REPS launches after WARMUP:

    full       the kernel as the control loop runs it
    nocost     zero_cost: no post-step FK and no task cost
    nosweeps   impulse_sweeps=0
    nocontact  skip_contacts, impulse_sweeps=0
    fkonly     skip_contacts, skip_dynamics, zero_cost, impulse_sweeps=0
    oneway     two_way_sweeps=False: the articulated side out of the sweeps
    nogate     broadphase_gate=False: every pair block computed

and K2 (one world step of the pick scene at its 16 sweeps, one env) in full,
oneway and nogate. Each variant prints one JSON line; then one line

    BREAKDOWN {"cost_section_ms", "gs_sweeps_ms", "contacts_ms",
               "artic_solve_ms", "fk_integrate_base_ms", "full_ms", ...}

with the JAX script's differences (cost = full − nocost, sweeps = full −
nosweeps, contacts = nosweeps − nocontact, articulated solve = nocontact −
fkonly, base = fkonly), plus two_way_sweeps_ms = full − oneway and
gate_saves_ms = nogate − full for K1 and K2, the card's name and its power
limit. `sections` adds the clock64() split of the full K1 by section
(ops/native.py VARIANT "sections", its own build) on the same inputs. Every
ablation is physically wrong on purpose except nogate; none is reachable
from the control loop's entry points. Needs the card: there is no CPU
measurement.
"""
from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

K, H = 1000, 30
WARMUP, REPS = 3, 20
K1_VARIANTS = {
    # name: (profile, sweeps: None keeps the conf's)
    "full": ({}, None),
    "nocost": ({"zero_cost": True}, None),
    "nosweeps": ({}, 0),
    "nocontact": ({"skip_contacts": True}, 0),
    "fkonly": ({"skip_contacts": True, "skip_dynamics": True, "zero_cost": True}, 0),
    "oneway": ({"two_way_sweeps": False}, None),
    "nogate": ({"broadphase_gate": False}, None),
}
K2_VARIANTS = {"full": {}, "oneway": {"two_way_sweeps": False}, "nogate": {"broadphase_gate": False}}
# the clock64() sections of csrc/scene_tables.cuh (SEC_*), in their order
SECTIONS = ("fk", "contacts", "free bodies and integration", "impulse inverse masses",
            "warm start", "sweeps", "snap", "command map and cost", "solves: tree and RNEA",
            "solves: CRBA and drives", "solves: couple terms", "solves: Cholesky", "solves: psi")


def time_ms(fn, reps=REPS, warmup=WARMUP) -> float:
    """Median ms of `fn`'s device work over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def setup(fidelity="world", substeps=None, sweeps=None, manifold="reduced", device="cuda"):
    """The bench twin's planner at K, H with these rollout settings →
    (planner, world-step wrapper, K1's state and params, V, conf sweeps)."""
    from .planner.mppi_isaac import MPPIisaacPlanner
    from .tasks.panda_pick import PandaPickObjective
    from .utils.config_store import load_config

    over = [f"mppi.num_samples={K}", f"mppi.horizon={H}", f"mppi.rollout_fidelity={fidelity}",
            f"mppi.rollout_manifold={manifold}"]
    if substeps:
        over.append(f"mppi.rollout_substeps={int(substeps)}")
    if sweeps is not None:
        over.append(f"mppi.rollout_sweeps={int(sweeps)}")
    cfg = load_config("tasks/panda_pick", over)
    planner = MPPIisaacPlanner(cfg, PandaPickObjective(cfg), randomize=True, device=device)
    g = torch.Generator().manual_seed(0)
    V = (0.1 * torch.randn(K, H, planner.mppi.nu, generator=g)).to(device)
    return cfg, planner, V


def main(argv=None) -> dict:
    """Run every variant; print their lines and the breakdown. → {"k1":
    {variant: record}, "k2": {...}, "breakdown": {...}, "sections": {...} or
    None}, each record with its wrapper and inputs ("fr"/"fw", "inputs")."""
    from .ops.fused_rollout import FusedRollout, FusedWorldStep
    from .utils.profiling import card

    argv = list(sys.argv[1:] if argv is None else argv)
    want_sections = "sections" in argv
    argv = [a for a in argv if a != "sections"]
    fidelity = argv[0] if len(argv) > 0 else "world"
    substeps = int(argv[1]) if len(argv) > 1 and argv[1] not in ("", "none") else None
    sweeps = int(argv[2]) if len(argv) > 2 and argv[2] not in ("", "none") else None
    manifold = argv[3] if len(argv) > 3 else "reduced"
    if fidelity not in ("fast", "world") or manifold not in ("full", "reduced"):
        raise SystemExit("usage: python -m mppiisaac_tpu_torch.profile_kernel [fast|world] "
                         "[substeps] [sweeps] [full|reduced] [sections]")
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernel times the CUDA kernels: it needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg, planner, V = setup(fidelity, substeps, sweeps, manifold, dev)
    base = planner.mppi.fused
    built, engine = planner.built, planner.sim.engine
    sw = base.impulse_sweeps
    k1 = {}
    for name, (profile, sw_v) in K1_VARIANTS.items():
        fr = FusedRollout(built, engine, base.ks.cost, H, K, vis_body=base.vis_body,
                          substeps=base.substeps, impulse_sweeps=sw if sw_v is None else sw_v,
                          world_fidelity=base.world_fidelity, manifold=base.manifold,
                          profile=profile)
        inputs = fr.pack(planner.sim.state, planner._params_K, V)
        ms = time_ms(lambda: fr.run(*inputs))
        k1[name] = dict(ms=ms, fr=fr, inputs=inputs)
        print(json.dumps({"kernel": "K1", "variant": name, "ms": ms, "sweeps": fr.impulse_sweeps,
                          "substeps": fr.substeps, "profile": profile, "mask": fr.mask}),
              flush=True)
    # K2: one world step of the pick scene, one env, at its conf's sweeps
    world_sweeps = cfg.isaacgym.fused_world_sweeps
    st = planner.sim.state.map(lambda x: x[0])
    k2 = {}
    for name, profile in K2_VARIANTS.items():
        fw = FusedWorldStep(built, engine, impulse_sweeps=world_sweeps, profile=profile)
        inputs = (fw.pack(st).contiguous(), st.dof_target.contiguous(),
                  torch.ones(built.scene.nbody, device=dev), torch.ones(built.scene.ngeom, device=dev))
        ms = time_ms(lambda: fw.step_rows(*inputs))
        k2[name] = dict(ms=ms, fw=fw, inputs=inputs)
        print(json.dumps({"kernel": "K2", "variant": name, "ms": ms, "sweeps": world_sweeps,
                          "profile": profile, "mask": fw.mask}), flush=True)
    t = {n: r["ms"] for n, r in k1.items()}
    where = card()
    breakdown = {
        "cost_section_ms": t["full"] - t["nocost"],
        "gs_sweeps_ms": t["full"] - t["nosweeps"],
        "contacts_ms": t["nosweeps"] - t["nocontact"],
        "artic_solve_ms": t["nocontact"] - t["fkonly"],
        "fk_integrate_base_ms": t["fkonly"],
        "full_ms": t["full"],
        "two_way_sweeps_ms": t["full"] - t["oneway"],
        "gate_saves_ms": t["nogate"] - t["full"],
        "k2_full_ms": k2["full"]["ms"],
        "k2_two_way_sweeps_ms": k2["full"]["ms"] - k2["oneway"]["ms"],
        "k2_gate_saves_ms": k2["nogate"]["ms"] - k2["full"]["ms"],
        "fidelity": fidelity, "substeps": base.substeps, "sweeps": sw, "manifold": manifold,
        "k2_sweeps": world_sweeps, "K": K, "H": H, "reps": REPS,
        "device": where["device"], "power_limit": where["power_limit"],
    }
    print("BREAKDOWN " + json.dumps(breakdown), flush=True)
    secs = sections(k1["full"]["fr"], k1["full"]["inputs"]) if want_sections else None
    return dict(k1=k1, k2=k2, breakdown=breakdown, sections=secs)


def sections(fr, inputs, launches=5) -> dict:
    """The clock64() split of the full K1 by section, from the section build
    (ops/native.py VARIANT "sections") on the same inputs: cycles of lane 0
    of each sample's warp per sample and launch. → {section: share}."""
    from .ops import native

    old = native.VARIANT
    native.VARIANT = "sections"
    try:
        lib = native.load_library()
        out = (ctypes.c_ulonglong * (2 * len(SECTIONS)))()
        fr.run(*inputs)
        torch.cuda.synchronize()
        lib.read_sections(ctypes.cast(out, ctypes.c_void_p))      # zero the counters
        for _ in range(launches):
            fr.run(*inputs)
        lib.read_sections(ctypes.cast(out, ctypes.c_void_p))
    finally:
        native.VARIANT = old
    per = np.array(out[:len(SECTIONS)], np.float64) / (launches * fr.K)
    total = max(per.sum(), 1.0)
    share = {s: float(c / total) for s, c in zip(SECTIONS, per)}
    print("SECTIONS " + json.dumps({"kernel": "K1", "launches": launches,
                                    "cycles_per_sample_and_launch": float(per.sum()),
                                    "share": share}), flush=True)
    return share


if __name__ == "__main__":
    main()
