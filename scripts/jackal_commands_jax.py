"""multi_jackal's commands and world steps, recorded on the card, held
against the JAX package on the CPU.

    python scripts/jackal_commands_jax.py RECORDS [--out JSON] [--workers N]
        [--subset NPZ --keep SEED:STEP,...] [--only SEED:STEP,...] [--card REPLAY]
    python scripts/jackal_commands_jax.py RECORDS --replay REPLAY [--no-fma]
    python scripts/jackal_commands_jax.py RECORDS --emulate REPLAY

RECORDS is the .npz that `python -m mppiisaac_tpu_torch.validate jackal
seeds=42,0,1,2,3,4 n_steps=400 device_steps=1 record=PATH` writes on the
card (`runtime/loop.CommandRecorder`): per recorded control step the 1-env
world state before it, the solver carry before the command, the card's
command (the per-sample costs S, the rollout's costs, the new U, the
action) and the world state after K2; the rollout's per-sample ModelParams
once. For each record the same (carry, state, params) go into

* the JAX package's command, `MPPIisaacPlanner(..., use_fused=True)`: its
  Pallas K1 in interpret mode, the path the TPU ran;
* the JAX package's K2, `FusedWorldStep(..., interpret=True)`, from the
  world state with the card's action through the command map;
* the port's plain command and plain K2 on the CPU, in float32 and in
  float64 (the float64 command: every solver constant and the rollout in
  float64, V still rounded through bf16 as both fused paths round it), and
  in float32 from ENVELOPE_RUNS copies of the state with every float moved
  by one float32 rounding (a relative 2^-23, its sign drawn per value).

and are compared (`compare`): the command's draw from the carry's key bit
for bit; the noise ε, the rollout's costs (K, H) (the largest difference,
the first step's and the median over samples of each sample's largest),
S (K,) (the largest and the median), the new U and the action, and the
world state after K2 by row group (pose, velocity, λ). Each measure is held
for JAX against the card and JAX against the port's plain float32, within
10× the port plain's own rounding there (floor 1e-6): the larger of its
float32-vs-float64 drift and its envelope (the most any of the rounded
copies moved it). The JSON gives both beside each difference, and which
records the drift alone would not have held.

--out writes every record's differences and bounds as JSON; --subset
writes the records of --keep, in its order, with the JAX outputs, the
drifts and the envelopes, the first TIER1 of them the ones
tests/test_torch_jackal_commands.py holds live. Each worker compiles the
JAX command once (about two minutes on one core).

--replay runs on the card (it imports no JAX): every record's command and
K2 again from its inputs, written to REPLAY as `card.*` and
`card.after_rows`; with --no-fma the kernels are built with `--fmad=false`
(native.py's "nofma" variant). --card REPLAY holds JAX against such a
replay instead of the recorded card outputs. --emulate REPLAY runs every
record's K2 through the device code's CPU emulation (csrc/emu, built by
g++, which contracts no multiply-add) and counts the records whose rows
equal the replay's bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mppiisaac_tpu_torch.convert import sim_state_from_jax  # noqa: E402
from mppiisaac_tpu_torch.mppi.solver import MppiCarry  # noqa: E402
from mppiisaac_tpu_torch.ops.fused_rollout import rollout_plain, world_step_plain  # noqa: E402
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS, SimState  # noqa: E402
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner  # noqa: E402
from mppiisaac_tpu_torch.runtime.sim import Simulation  # noqa: E402
from mppiisaac_tpu_torch.tasks.multi_robot import MultiJackalObjective  # noqa: E402
from mppiisaac_tpu_torch.utils.config_store import load_config  # noqa: E402

TASK = "tasks/multi_jackal"
# XLA:CPU compile options of the JAX kernels in interpret mode: without the
# fusion pass the compile takes about half as long, with the same results
INTERPRET_OPTIONS = {"xla_disable_hlo_passes": "fusion"}
FLOOR = 1e-6
TIER1 = 4                 # --subset: the first records the tier-1 test holds live
ENVELOPE_RUNS = 6         # rounded copies of each record's state
COMMAND_MEASURES = ("eps", "costs_max", "costs_first", "costs_median", "S_max", "S_median", "U",
                    "action")
K2_MEASURES = ("pose", "vel", "lam")
OUTPUTS = ("S", "costs", "U", "action")


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def load(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def record(d: dict, i: int) -> dict:
    """Row i of a records dict: {"seed", "step", "stalled", "before",
    "after" (field → (1, ...) arrays), "carry.*", "card.*", ...}."""
    r = {"seed": int(d["seed"][i]), "step": int(d["step"][i]), "stalled": bool(d["stalled"][i])}
    for side in ("before", "after"):
        r[side] = {f: d[f"{side}.{f}"][i] for f in SIM_STATE_FIELDS if f"{side}.{f}" in d}
    for k in d:
        if k.startswith(("carry.", "card.", "jax.", "drift.", "envelope.")) and d[k].ndim >= 1 \
                and d[k].shape[0] == len(d["seed"]):
            r[k] = d[k][i]
    return r


def params(d: dict):
    return d["params.body_mass_scale"], d["params.geom_friction"]


def _state(fields: dict) -> SimState:
    return SimState(**{f: torch.from_numpy(np.array(v)) for f, v in fields.items()})


def _fields(st: SimState) -> dict:
    return {f: getattr(st, f).numpy() for f in SIM_STATE_FIELDS if getattr(st, f) is not None}


def rounded(fields: dict, g: np.random.Generator) -> dict:
    """The state with every float32 moved by one rounding: × (1 ± 2^-23)."""
    out = {}
    for f, v in fields.items():
        s = g.choice(np.array([-1.0, 1.0]), v.shape)
        out[f] = (v.astype(np.float64) * (1.0 + s * 2.0 ** -23)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the JAX package (imported on first use: the card's machine has no JAX)
# ---------------------------------------------------------------------------

class JaxSide:
    """The JAX package's command (Pallas K1 in interpret mode) and K2
    (interpret mode) on multi_jackal at the conf's K and H."""

    def __init__(self, mass, fric):
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        from mppiisaac_tpu.mppi.solver import MppiCarry as JCarry
        from mppiisaac_tpu.ops.pallas.fused_rollout import FusedWorldStep as JWorld
        from mppiisaac_tpu.physics.types import ModelParams as JParams
        from mppiisaac_tpu.planner.mppi_isaac import MPPIisaacPlanner as JPlanner
        from mppiisaac_tpu.tasks.multi_robot import MultiJackalObjective as JObjective
        from mppiisaac_tpu.utils.config_store import load_config as j_load

        self.jax, self.jnp, self.JCarry = jax, jnp, JCarry
        cfg = j_load(TASK)
        jp = JPlanner(cfg, JObjective(cfg), use_fused=True)
        if jp.mppi.fused is None or not jp.mppi.fused.interpret:
            raise RuntimeError("the JAX planner did not build its Pallas K1 in interpret mode")
        got = (np.asarray(jp._params_K.body_mass_scale), np.asarray(jp._params_K.geom_friction))
        if not (np.array_equal(got[0], mass) and np.array_equal(got[1], fric)):
            raise RuntimeError("the JAX planner's per-sample ModelParams differ from the record's")
        self.jp, self.mppi, self.K = jp, jp.mppi, cfg.mppi.num_samples
        self._full = jax.jit(self._full_fn(), compiler_options=INTERPRET_OPTIONS)
        mppi = self.mppi

        def noise(key, sigma):
            _, sub = jax.random.split(key)
            return jax.random.uniform(sub, (mppi._sample_dims,)), mppi._sample_noise(sub, sigma)

        self._noise = jax.jit(noise)
        b, e = jp.sim.built, jp.sim.engine
        self.built = b
        fw = JWorld(b, e, impulse_sweeps=cfg.isaacgym.fused_world_sweeps, interpret=True)
        fw._run = jax.jit(fw._build_call(), compiler_options=INTERPRET_OPTIONS)
        ones = JParams(body_mass_scale=jnp.ones((b.scene.nbody,), jnp.float32),
                       geom_friction=jnp.ones((b.scene.ngeom,), jnp.float32))

        def k2(st, action):
            tgt = b.cmd_map.apply(action[None], st.q[None])[0]
            return fw.step(st._replace(dof_target=tgt), ones)

        self._k2 = k2

    def _full_fn(self):
        jax, jnp, jp, mppi, K = self.jax, self.jnp, self.jp, self.mppi, self.K

        def full(carry, ws):
            real, tap = mppi.fused, {}

            class Tap:
                def rollout(self, s, p, V):
                    out = real.rollout(s, p, V)
                    tap["costs"] = out[0]
                    return out

            mppi.fused = Tap()
            try:
                sK = jax.tree.map(lambda x: jnp.broadcast_to(x[0], (K,) + x.shape[1:]), ws)
                action, new, info = mppi._command_impl(carry, (sK, jp._params_K))
            finally:
                mppi.fused = real
            return action, new.U, info["costs"], tap["costs"]

        return full

    def state(self, fields: dict, batch: bool):
        js = self.built.initial_state(self.jp.sim.engine)
        pick = (lambda a: a) if batch else (lambda a: a[0])
        return js._replace(**{f: None if f not in fields else self.jnp.asarray(pick(fields[f]))
                              for f in js._fields})

    def command(self, r) -> dict:
        jnp = self.jnp
        carry = self.JCarry(U=jnp.asarray(r["carry.U"]), lambda_=jnp.asarray(r["carry.lambda"]),
                            sigma=jnp.asarray(r["carry.sigma"]),
                            key=jnp.asarray(r["carry.key"], jnp.uint32),
                            t0=jnp.asarray(r["carry.t0"], jnp.int32))
        action, U, S, costs = self._full(carry, self.state(r["before"], batch=True))
        draw, eps = self._noise(carry.key, carry.sigma)
        return {"action": np.asarray(action).reshape(-1), "U": np.asarray(U),
                "S": np.asarray(S), "costs": np.asarray(costs), "draw": np.asarray(draw),
                "eps": np.asarray(eps)}

    def world_step(self, r) -> SimState:
        """K2 from the record's state with the card's action → port SimState."""
        out = self._k2(self.state(r["before"], batch=False), self.jnp.asarray(r["card.action"]))
        return sim_state_from_jax(self.jax.tree.map(lambda x: x[None], out))


# ---------------------------------------------------------------------------
# the port: its plain versions on the CPU (float32, float64), or the card
# ---------------------------------------------------------------------------

class _Tap:
    """The planner's fused rollout, its costs kept; in float64 the plain K1
    on the packed inputs in float64 (V rounded through bf16 first)."""

    def __init__(self, fr, dtype):
        self.fr, self.dtype, self.costs = fr, dtype, None

    def rollout(self, sK, pK, V):
        fr = self.fr
        if self.dtype == torch.float32:
            out = fr.rollout(sK, pK, V)
        else:
            rows, _, mass, fric = fr.pack(sK, pK, V.float())
            Vb = V.to(torch.bfloat16).permute(1, 2, 0).to(self.dtype)
            out = rollout_plain(fr.ks, rows.to(self.dtype), Vb, mass.to(self.dtype),
                                fric.to(self.dtype), fr.H, fr.substeps, fr.dt_sub, fr.vis_body,
                                fr.impulse_sweeps, fr.world_fidelity)
        self.costs = out[0]
        return out


class PortSide:
    """The port's command and K2 in `dtype` on `device` (the CPU: their
    plain versions; cuda: the kernels)."""

    def __init__(self, mass, fric, dtype=torch.float32, device="cpu"):
        cfg = load_config(TASK)
        self.cfg, self.dtype, self.device = cfg, dtype, torch.device(device)
        tp = MPPIisaacPlanner(cfg, MultiJackalObjective(cfg), device=self.device, use_fused=True)
        pm = tp._params_K
        if not (np.array_equal(pm.body_mass_scale.cpu().numpy(), mass)
                and np.array_equal(pm.geom_friction.cpu().numpy(), fric)):
            raise RuntimeError("the port's per-sample ModelParams differ from the record's")
        mppi = tp.mppi
        if dtype != torch.float32:
            for name, v in list(vars(mppi).items()):
                if torch.is_tensor(v) and v.dtype == torch.float32:
                    setattr(mppi, name, v.to(dtype))
        self.tap = _Tap(mppi.fused, dtype)
        mppi.fused = self.tap
        self.tp, self.mppi = tp, mppi
        self.world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions,
                                device=self.device)

    def command(self, r, before=None) -> dict:
        """The command from the record's carry and world state (or `before`)."""
        dev = self.device
        t = (lambda x: torch.as_tensor(np.asarray(x), device=dev).to(self.dtype))
        carry = MppiCarry(U=t(r["carry.U"]), lambda_=t(r["carry.lambda"]),
                          sigma=t(r["carry.sigma"]),
                          t0=torch.tensor(int(r["carry.t0"]), dtype=torch.int64, device=dev),
                          key=np.array(r["carry.key"], np.uint32))
        ws = _state(before or r["before"]).map(lambda x: x.to(dev))
        action, new, info = self.tp._full(carry, ws)
        _, d = self.mppi.draws(carry.key, 1)
        eps = self.mppi.noise(torch.as_tensor(d[0], device=dev), carry.sigma)
        dbl = (lambda x: x.detach().double().cpu().numpy())
        return {"action": dbl(action).reshape(-1), "U": dbl(new.U), "S": dbl(info["costs"]),
                "costs": dbl(self.tap.costs), "draw": d[0], "eps": dbl(eps)}

    def rows(self, fields: dict) -> torch.Tensor:
        """The K2 output rows of a 1-env state (fields (1, ...)): its packed
        rows with its net contact forces in their place (`pack` leaves
        them zero, as K2 takes them)."""
        st = _state(fields).map(lambda x: x.to(self.device))
        ks = self.world._world_step.ks
        lo = 13 * ks.nactor + 2 * ks.ndof
        out = self.world._world_step.pack(st)[:, 0].clone()
        out[lo: ks.n_state_rows] = st.net_contact_force[0].reshape(-1)
        return out.cpu()

    def world_step(self, r, before=None) -> torch.Tensor:
        """K2 from the record's state (or `before`) with the card's action →
        rows (on the CPU the plain version's raw output in `dtype`; on the
        card the stepped state's rows)."""
        w = self.world
        st = _state(before or r["before"]).map(lambda x: x.to(self.device))
        st = w.commanded(st, torch.as_tensor(r["card.action"], device=self.device)[None])
        if self.device.type == "cuda":
            return self.rows(_fields(w.stepped(st).map(lambda x: x.cpu())))
        fw = w._world_step
        ks, dt = fw.ks, self.dtype
        return world_step_plain(ks, fw.pack(st)[:, 0].to(dt), st.dof_target[0].to(dt),
                                torch.ones(ks.nbody, dtype=dt), torch.ones(ks.ngeom, dtype=dt),
                                fw.substeps, fw.dt_sub, fw.impulse_sweeps)


# ---------------------------------------------------------------------------
# measures
# ---------------------------------------------------------------------------

def groups(ks, d) -> dict:
    """|d| of K2 rows by group: pose (roots' position and orientation, q),
    vel (roots' velocities, qd, net contact forces), lam (λ rows)."""
    A, D, NS = ks.nactor, ks.ndof, ks.n_state_rows
    d = np.abs(np.asarray(d, np.float64))
    root = d[: 13 * A].reshape(A, 13)
    return {"pose": float(max(root[:, :7].max(), d[13 * A: 13 * A + D].max(initial=0.0))),
            "vel": float(max(root[:, 7:].max(), d[13 * A + D: NS].max())),
            "lam": float(d[NS:].max(initial=0.0))}


def command_measures(a: dict, b: dict) -> dict:
    """How far two commands' outputs (dicts of arrays) part, by measure."""
    f = (lambda k: np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)))
    dc, dS = f("costs"), f("S")
    m = {"costs_max": dc.max(), "costs_first": dc[:, 0].max(),
         "costs_median": np.median(dc.max(1)), "S_max": dS.max(), "S_median": np.median(dS),
         "U": f("U").max(), "action": f("action").max()}
    if "eps" in a and "eps" in b:
        m["eps"] = f("eps").max()
    return {k: float(v) for k, v in m.items()}


def rounding(p32, p64, r, c32, rows32) -> tuple:
    """The port plain's own rounding at a record: → (its float32-vs-float64
    drift, its envelope over ENVELOPE_RUNS rounded copies of the state), each
    {measure: value}."""
    ks = p32.world._world_step.ks
    drift = dict(command_measures(c32, p64.command(r)),
                 **groups(ks, rows32.double() - p64.world_step(r)))
    g = np.random.default_rng([r["seed"], r["step"]])
    env = dict.fromkeys(drift, 0.0)
    for _ in range(ENVELOPE_RUNS):
        before = rounded(r["before"], g)
        m = dict(command_measures(c32, p32.command(r, before)),
                 **groups(ks, rows32.double() - p32.world_step(r, before).double()))
        env = {k: max(env[k], m[k]) for k in env}
    return drift, env


def bounds_of(drift: dict, env: dict) -> dict:
    """10× the larger of the drift and the envelope, floor FLOOR."""
    return {k: max(10.0 * max(drift[k], env.get(k, 0.0)), FLOOR) for k in drift}


def compare(r, jx: dict, j_rows, p32: dict, p32_rows, drift: dict, env: dict, ks, card: dict,
            card_rows) -> dict:
    """One record's differences beside their bounds (bounds_of): JAX
    against the card and against the port's plain float32."""
    bounds = bounds_of(drift, env)
    by_drift = {k: max(10.0 * drift[k], FLOOR) for k in drift}
    card_m = dict(command_measures(jx, card), **groups(ks, j_rows - card_rows))
    port_m = dict(command_measures(jx, p32), **groups(ks, j_rows - p32_rows))
    draw_equal = bool(np.array_equal(np.asarray(jx["draw"]), np.asarray(p32["draw"])))
    held = draw_equal and all(card_m[k] <= bounds[k] for k in card_m) \
        and all(port_m[k] <= bounds[k] for k in port_m)
    beyond_drift = sorted({k for m in (card_m, port_m) for k in m if m[k] > by_drift[k]})
    return {"seed": r["seed"], "step": r["step"], "stalled": r["stalled"],
            "draw_bit_for_bit": draw_equal, "jax_vs_card": card_m, "jax_vs_port": port_m,
            "drift": drift, "envelope": env, "bound": bounds, "bound_by_drift": by_drift,
            "beyond_drift_alone": beyond_drift, "held": bool(held)}


# ---------------------------------------------------------------------------
# the run over the records
# ---------------------------------------------------------------------------

def _work(args):
    """One worker: the records `idx` of `path` → [(index, result, JAX
    outputs, drift, envelope)]."""
    path, idx, card_path = args
    torch.set_num_threads(1)
    d = load(path)
    replay = load(card_path) if card_path else None
    mass, fric = params(d)
    jx_side = JaxSide(mass, fric)
    p32, p64 = PortSide(mass, fric), PortSide(mass, fric, torch.float64)
    ks = p32.world._world_step.ks
    out = []
    for i in idx:
        t0 = time.perf_counter()
        r = record(d, i)
        jx = jx_side.command(r)
        j_rows = p32.rows(_fields(jx_side.world_step(r))).double().numpy()
        c32, rows32 = p32.command(r), p32.world_step(r)
        drift, env = rounding(p32, p64, r, c32, rows32)
        if replay is None:
            card = {k: r[f"card.{k}"] for k in OUTPUTS}
            card_rows = p32.rows(r["after"]).double().numpy()
        else:
            card = {k: replay[f"card.{k}"][i] for k in OUTPUTS}
            card_rows = replay["card.after_rows"][i].astype(np.float64)
        res = compare(r, jx, j_rows, c32, rows32.double().numpy(), drift, env, ks, card,
                      card_rows)
        res["seconds"] = time.perf_counter() - t0
        print(f"  seed {r['seed']} step {r['step']}{' (stall)' if r['stalled'] else ''}: "
              f"held {res['held']}; " + summary_line(res), flush=True)
        out.append((i, res, {k: jx[k] for k in OUTPUTS} | {"after_rows": j_rows}, drift, env))
    return out


def summary_line(res) -> str:
    c, p, b = res["jax_vs_card"], res["jax_vs_port"], res["bound"]
    keys = ("costs_first", "costs_median", "costs_max", "U", "action", "pose", "vel", "lam")
    return ", ".join(f"{k} {c[k]:.2e}/{p[k]:.2e} (≤ {b[k]:.2e})" for k in keys) + (
        f"; beyond 10x drift alone: {res['beyond_drift_alone']}" if res["beyond_drift_alone"]
        else "")


def subset(d, idx) -> dict:
    """Rows `idx` of d (and its constants), `tier1` marking the first
    TIER1."""
    out = {k: v[idx] for k, v in d.items()
           if not k.startswith("traj") and v.ndim >= 1 and v.shape[0] == len(d["seed"])}
    out.update({k: v for k, v in d.items() if k.startswith("params") or v.ndim == 0})
    out["tier1"] = np.arange(len(idx)) < TIER1
    return out


def replay(path, out, fma=True):
    """Every record's command and K2 again on the card → `out`."""
    from mppiisaac_tpu_torch.ops import native

    if not fma:
        native.VARIANT = "nofma"
    d = load(path)
    port = PortSide(*params(d), device="cuda")
    done = []
    for i in range(len(d["seed"])):
        r = record(d, i)
        done.append((port.command(r), port.world_step(r).double().numpy()))
    res = {f"card.{k}": np.stack([c[k] for c, _ in done]).astype(np.float32) for k in OUTPUTS}
    res["card.after_rows"] = np.stack([x for _, x in done]).astype(np.float32)
    same = sum(all(np.array_equal(d[f"card.{k}"][i], res[f"card.{k}"][i]) for k in OUTPUTS)
               for i in range(len(done)))
    np.savez_compressed(out, **res, fma=np.array(fma),
                        device=np.array(torch.cuda.get_device_name(0)))
    print(f"replayed {len(done)} records on {torch.cuda.get_device_name(0)} "
          f"({'the default build' if fma else '--fmad=false'}): commands bit for bit the "
          f"recorded ones at {same} -> {out}", flush=True)


def emulate(path, replay_path):
    """K2 of every record through the CPU emulation of the device code
    against a --replay's rows: → the records equal bit for bit."""
    import ctypes
    import shutil
    import subprocess
    import tempfile

    gxx = shutil.which("g++")
    if gxx is None:
        raise SystemExit("--emulate needs g++ with C++20")
    emu = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "mppiisaac_tpu_torch", "csrc", "emu")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libfused_emu.so")
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-I", emu, "-o", so,
                        os.path.join(emu, "launch.cpp")], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.emu_world_step.argtypes = [P] * 6 + [I, I, F, I, I]
    d, rep = load(path), load(replay_path)
    port = PortSide(*params(d))
    w = port.world
    fw, ks = w._world_step, w._world_step.ks
    tables = np.frombuffer(fw._tables._bytes, np.uint8).copy()
    ones_b, ones_g = torch.ones(ks.nbody, 1), torch.ones(ks.ngeom, 1)
    same = []
    for i in range(len(d["seed"])):
        r = record(d, i)
        st = w.commanded(_state(r["before"]), torch.as_tensor(r["card.action"])[None])
        rows, tgt = fw.pack(st).contiguous(), st.dof_target.T.contiguous()
        out = torch.empty_like(rows)
        if lib.emu_world_step(tables.ctypes.data, rows.data_ptr(), tgt.data_ptr(),
                              ones_b.data_ptr(), ones_g.data_ptr(), out.data_ptr(), 1,
                              fw.substeps, fw.dt_sub, fw.impulse_sweeps, fw.warp_bytes) != 0:
            raise RuntimeError(f"the emulated K2 failed at record {i}")
        e, c = out[:, 0].numpy(), rep["card.after_rows"][i]
        same.append(bool(np.array_equal(e, c)))
        if not same[-1]:
            g = groups(ks, e.astype(np.float64) - c)
            print(f"  seed {r['seed']} step {r['step']}: emulated K2 vs the replay: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in g.items()), flush=True)
    print(f"K2 emulated on the CPU against {replay_path} ({rep['device']}, "
          f"{'the default build' if bool(rep['fma']) else '--fmad=false'}): bit for bit at "
          f"{sum(same)} of {len(same)}", flush=True)
    return sum(same)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("records")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--subset", default=None)
    ap.add_argument("--keep", default=None, help="SEED:STEP,...: --subset's records, in order")
    ap.add_argument("--only", default=None, help="SEED:STEP,...: these records only")
    ap.add_argument("--card", default=None, help="a --replay output in place of the card's")
    ap.add_argument("--replay", default=None, help="replay on the card into this .npz")
    ap.add_argument("--no-fma", action="store_true")
    ap.add_argument("--emulate", default=None, help="a --replay output to emulate K2 against")
    args = ap.parse_args(argv)
    if args.replay:
        replay(args.records, args.replay, fma=not args.no_fma)
        return 0
    if args.emulate:
        emulate(args.records, args.emulate)
        return 0
    d = load(args.records)
    rows_of = {(int(s), int(t)): i for i, (s, t) in enumerate(zip(d["seed"], d["step"]))}
    pairs = (lambda s: [tuple(int(x) for x in p.split(":")) for p in s.split(",")])
    if args.subset and not args.keep:
        raise SystemExit("--subset needs --keep")
    todo = sorted({rows_of[k] for k in pairs(args.only)} if args.only else range(len(d["seed"])))
    print(f"{len(todo)} records of {args.records} ({d['device']}, K={int(d['K'])}, "
          f"H={int(d['H'])}) on {args.workers} worker(s)", flush=True)
    t0 = time.perf_counter()
    parts = [(args.records, todo[w::args.workers], args.card) for w in range(args.workers)]
    if args.workers == 1:
        done = _work(parts[0])
    else:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(args.workers) as pool:
            done = [x for part in pool.map(_work, parts) for x in part]
    done.sort(key=lambda x: x[0])
    results = [res for _, res, _, _, _ in done]
    held = sum(r["held"] for r in results)
    beyond = [f"{r['seed']}@{r['step']}" for r in results if r["beyond_drift_alone"]]
    print(f"HELD {held}/{len(results)} records in {time.perf_counter() - t0:.0f} s; beyond 10x "
          f"the float32-vs-float64 drift alone: {len(beyond)} {beyond}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"records": args.records, "card": args.card or "recorded",
                       "device": str(d["device"]), "K": int(d["K"]), "H": int(d["H"]),
                       "floor": FLOOR, "envelope_runs": ENVELOPE_RUNS, "held": held,
                       "n": len(results), "beyond_drift_alone": beyond, "results": results},
                      f, indent=1)
        print(f"wrote {args.out}", flush=True)
    if args.subset:
        by = {i: rest for i, _, *rest in done}
        idx = [rows_of[k] for k in pairs(args.keep)]
        out = subset(d, idx)
        for k in OUTPUTS + ("after_rows",):
            out[f"jax.{k}"] = np.stack([by[i][0][k] for i in idx]).astype(np.float32)
        for k in COMMAND_MEASURES + K2_MEASURES:
            out[f"drift.{k}"] = np.array([by[i][1][k] for i in idx], np.float64)
            out[f"envelope.{k}"] = np.array([by[i][2][k] for i in idx], np.float64)
        np.savez_compressed(args.subset, **out)
        print(f"wrote {len(idx)} records to {args.subset} (tier-1: the first {TIER1})",
              flush=True)
    return 0 if held == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
