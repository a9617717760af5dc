"""The operations and bytes of K1 and K2, counted through the frozen plain
versions, and the chip's published peaks.

A copy of `chip_smoke.py`'s `OpCount`, `k1_bound` and `k2_bound`, pointed
at the copies under this package, so that a rewritten kernel or plain
version cannot move the count. Float32 operations: one per output element
of each arithmetic op, one per input element of a reduction, 2mnk per
matrix product. Contact-block work (the contacts and the impulse pass) is
counted apart and scaled by the share of (sample, block) pairs whose gate is
on: the plain version evaluates every block and masks the separated ones,
the kernel skips them. The step is counted on its first substep and its
cost, and scaled by the substeps and the horizon. Bytes: the inputs, the
scene's tables and the outputs, each once.
"""
from __future__ import annotations

import torch

from .kernels import table_bytes

# one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit: float32
# outside the tensor cores, and HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt", "reciprocal", "clamp",
    "clamp_min", "clamp_max", "maximum", "minimum", "abs", "sin", "cos", "atan2", "asin", "where",
    "gt", "lt", "ge", "le", "eq", "ne", "pow", "exp", "sign", "addcmul", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod"}


class OpCount:
    """Counts the float32 operations of the plain version run inside it."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.__name__.split(".")[0].rstrip("_")
                n = 0
                if name in _ELEMENTWISE:
                    n = out.numel()
                elif name in _REDUCE:
                    n = args[0].numel()
                elif name in ("mm", "bmm"):
                    n = 2 * args[0].numel() * args[1].shape[-1]
                counter.ops[counter.label] += n
                return out

        self.mode = Mode()
        self.ops = {"block": 0, "rest": 0}
        self.label = "rest"
        self.gates = [0, 0]

    def __enter__(self):
        from .ops import fused_contacts, fused_physics

        self._saved = [(fused_physics, "contacts"), (fused_physics, "impulse_pass"),
                       (fused_contacts, "block_gate")]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]

        def labelled(fn):
            def run(*a, **k):
                self.label = "block"
                try:
                    return fn(*a, **k)
                finally:
                    self.label = "rest"
            return run

        gate = fused_contacts.block_gate

        def counted_gate(ks, bi, pos, quat):
            live = gate(ks, bi, pos, quat)
            S = int(ks.blk_S[bi])
            self.gates[0] += S * int(live.sum())
            self.gates[1] += S * live.numel()
            return live

        fused_physics.contacts = labelled(fused_physics.contacts)
        fused_physics.impulse_pass = labelled(fused_physics.impulse_pass)
        fused_contacts.block_gate = counted_gate
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for m, n, fn in self._saved:
            setattr(m, n, fn)

    @property
    def live_share(self):
        return self.gates[0] / max(self.gates[1], 1)

    @property
    def flops(self):
        return self.ops["rest"] + self.ops["block"] * self.live_share


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, nbytes: float):
    """→ (least seconds, "operations" or "bytes", flops, bytes)."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def k1_bound(rollout, rows, V, mass, fric):
    """(least s, bound by, flops, bytes, live share) of one K1 launch on its
    inputs: rows (NS + 4·n_fc, K), V (H,nu,K) as the kernel reads it (bf16),
    mass (B,K), fric (G,K); `rollout` a `kernels.Rollout`."""
    from .ops import fused_physics as fp

    with torch.no_grad(), OpCount() as c:
        st = fp.rows_to_state(rollout.ks, rows)
        tgt = fp.command_targets(rollout.ks, V[0].T.float(), st["q"])
        st = fp.substep(rollout.ks, st, tgt, mass.T, fric.T, rollout.dt_sub,
                        rollout.impulse_sweeps, rollout.world_fidelity)
        sub = c.flops
        pos, quat, _, _, _ = fp.fk(rollout.ks, st)
        fp.task_cost(rollout.ks, st, pos, quat)
    flops = sub * rollout.substeps * rollout.H + (c.flops - sub) * rollout.H
    nbytes = (_nbytes(rows, mass, fric) + V.numel() * 2 + table_bytes(rollout.ks)
              + rollout.K * rollout.H * 4 * 4)
    return bound(flops, nbytes) + (c.live_share,)


def k2_bound(world_step, rows, tgt):
    """(least s, bound by, flops, bytes, live share) of one K2 launch over
    N envs: rows (NS + 4·n_fc, N), tgt (N, D); `world_step` a
    `kernels.WorldStep` (unit mass and friction scales)."""
    from .ops import fused_physics as fp

    N = rows.shape[1]
    ks = world_step.ks
    mass = torch.ones(N, ks.nbody, dtype=torch.float32, device=rows.device)
    fric = torch.ones(N, ks.ngeom, dtype=torch.float32, device=rows.device)
    with torch.no_grad(), OpCount() as c:
        st = fp.rows_to_state(ks, rows)
        fp.substep(ks, st, tgt, mass, fric, world_step.dt_sub, world_step.impulse_sweeps)
    flops = c.flops * world_step.substeps
    nbytes = 2 * _nbytes(rows) + _nbytes(tgt, mass, fric) + table_bytes(ks)
    return bound(flops, nbytes) + (c.live_share,)
