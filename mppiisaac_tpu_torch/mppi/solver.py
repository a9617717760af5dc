"""The MPPI solver in torch: Halton-spline noise, the K-sample rollout, softmax
update, Savitzky–Golay filter, shift.

Counterpart of the JAX package's `mppi/solver.py` on one device: the same
carry (U, λ, Σ, step clock), the same noise construction and the same update.
Two notes on form:

* the carry's key is a numpy array and its draws come from `mppi.prng`,
  the JAX package's threefry bit for bit: the same seed gives the same
  Cranley–Patterson shifts of the Halton table, command after command
  (`_command_impl` also takes an injected ε, for tests of the update alone).
  The key chain does not depend on device results, so `draws(key, n)` makes
  n commands' draws ahead on the host, and `_command_impl(draw=...)` takes
  one of them: the chunked loop (runtime/loop.py) copies a chunk's draws to
  the device once and replays a CUDA graph of the command;
* past the host draw, a command is capturable in a CUDA graph: no host sync
  (`cholesky_ex`, `inv_ex`), no copy from host memory (the constants live
  on the device from `__init__` and `refresh_constants`), and the step clock
  `t0` is a 0-d int64 tensor on the device, advanced by the command;
* the rollout is the fused rollout (`ops/fused_rollout.FusedRollout`, the
  CUDA kernel on CUDA tensors, its plain version on CPU tensors) when one is
  given, else the unfused rollout: a Python loop over the horizon of
  `dynamics`, `running_cost` and `vis_fn`, each batched over the K samples
  (the JAX package's vmap-of-scan). Only the unfused rollout takes a
  closed-loop prior. Its controls are not rounded through bf16, which only
  the fused kernel does;
* sharded over a process group (`parallel/sharding.py`), `group`, `rank`
  and `n_shards` make β = min S an all-reduce MIN and η, Σ w ε and the
  covariance update all-reduce SUMs, and put the special samples (null
  action, tape or prior) on the last rank only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import span, tape_part
from . import prng
from .config import MPPIConfig
from .sampling import bspline_interp_matrix, halton, savgol_coeffs, savgol_matrix


@dataclass
class MppiCarry:
    U: torch.Tensor          # (H, nu) nominal control sequence
    lambda_: torch.Tensor    # () temperature
    sigma: torch.Tensor      # (nu, nu) sampling covariance
    t0: torch.Tensor         # () int64: world control steps executed so far
    key: Optional[np.ndarray] = None   # (2,) uint32 PRNG key, split per command


class MPPIPlanner:
    """fused: the fused rollout, `fused.rollout(sim_state_K, params_K, V
    (K,H,nu)) → (costs (K,H), vis (H,K,3))`, with state0 = (SimState_K,
    ModelParams_K); or None for the unfused rollout over the K-batched
    state0 through
      dynamics: (state, u (K,nu), t) → state,
      running_cost: (state, t) → (K,) costs,
      vis_fn: optional (state) → (K,d) per-step visualization payload,
      prior: optional closed-loop prior (state, t) → (K,nu) commands, of
        which sample K−2's replaces its control at each step (with
        `use_priors`).
    device: where the solver's tensors live ("cuda", the default, as every
    entry point of the port; "cpu" for the plain versions). tape_prior:
    optional `(state0, t0) → (H, nu)` control tape, evaluated once per
    command (with `use_priors`) from the K-wide state0 and the world step
    clock, outside the rollout: one sample rolls the tape, and with
    `prior_blend` a > 0 the sampling mean moves to (1 − a)·U + a·tape. The
    tape's evaluation and clamp are the span `solver.tape` and, in a
    captured step, the nodes that utils/profiling.tape_part counts.

    `tape_injections` counts the commands into which a tape was injected."""

    tape_injections = 0

    def __init__(self, cfg: MPPIConfig, nx: int, fused=None, device="cuda", tape_prior=None,
                 dynamics=None, running_cost=None, prior=None, vis_fn=None):
        if fused is None and (dynamics is None or running_cost is None):
            raise ValueError("the unfused rollout (fused=None) needs dynamics and running_cost")
        self.fused = fused
        self.tape_prior = tape_prior
        self.dynamics = dynamics
        self.running_cost = running_cost
        self.prior = prior
        self.vis_fn = vis_fn
        # sharding (parallel/sharding.py): the process group of the
        # reductions, this rank and the number of ranks; the special samples
        # go on the last rank
        self.group = None
        self.rank = 0
        self.n_shards = 1
        self.nx = nx
        self.device = torch.device(device)
        nu = np.asarray(cfg.noise_sigma, dtype=np.float64).shape[0] if cfg.noise_sigma is not None else nx
        self.nu = nu
        self.cfg = cfg.resolved(nu)
        c = self.cfg
        K, H = c.num_samples, c.horizon
        dev = self.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        # ---- static sampling bases ----
        if c.mppi_mode == "halton-spline":
            n_knots = max(c.spline_degree + 1, H // c.knot_scale)
            self._interp = f32(bspline_interp_matrix(n_knots, H, c.spline_degree))
            self._sample_dims = n_knots * nu
            self._n_knots = n_knots
        else:
            self._interp = None
            self._sample_dims = H * nu
            self._n_knots = H
        self._halton_base = f32(halton(K, self._sample_dims, skip=1)) \
            if c.sampling_method == "halton" else None
        self._sg = None
        if c.filter_u:
            w = min(H if H % 2 == 1 else H - 1, 9)
            if w >= 5:
                self._sg = f32(savgol_matrix(savgol_coeffs(w, 2), H))
        self._eye = torch.eye(nu, dtype=torch.float32, device=dev)
        # the closed-loop prior's sample
        self._prior_row = torch.arange(K, device=dev) == K - 2
        self.refresh_constants()
        self.carry = self.init_carry()
        self.last_info: dict = {}

    def refresh_constants(self):
        """Re-read the bounds, the initial control, the noise mean, the prior
        blend and the cost discount from the config (after an online change
        of them). A constant of the same shape is written in place, so a
        captured command sees the new value."""
        c = self.cfg

        def put(name, x):
            if not torch.is_tensor(x):
                x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            old = getattr(self, name, None)
            if old is not None and old.shape == x.shape:
                old.copy_(x)
            else:
                setattr(self, name, x)

        put("_u_min", c.u_min)
        put("_u_max", c.u_max)
        put("_u_init", c.u_init)
        put("_noise_mu", c.noise_mu)
        put("_prior_blend", c.prior_blend)
        put("_gamma", torch.tensor(np.float32(c.rollout_var_discount), device=self.device)
            ** torch.arange(c.horizon, device=self.device, dtype=torch.float32))

    # ------------------------------------------------------------------
    def init_carry(self) -> MppiCarry:
        c = self.cfg
        dev = self.device
        if c.U_init is not None:
            U0 = torch.as_tensor(np.asarray(c.U_init, np.float32), device=dev)
        else:
            U0 = self._u_init.expand(c.horizon, self.nu).clone()
        return MppiCarry(
            U=U0,
            lambda_=torch.tensor(float(c.lambda_), dtype=torch.float32, device=dev),
            sigma=torch.as_tensor(np.asarray(c.noise_sigma, np.float32), device=dev),
            t0=torch.zeros((), dtype=torch.int64, device=dev),
            key=prng.prng_key(int(c.seed_val)),
        )

    def reset(self):
        """A fresh carry from the config (the JAX solver's `reset`)."""
        self.carry = self.init_carry()

    def command(self, state0):
        """The stateful call of mppi_torch's contract (`.command(state)`, the
        JAX solver's `command`): one command from the planner's carry, which
        it advances, and its info in `last_info`. → the (u_per_command, nu)
        action, or (nu,) when u_per_command is 1."""
        action, self.carry, self.last_info = self._command_impl(self.carry, state0)
        if self.cfg.u_per_command == 1:
            return action[0]
        return action

    # ------------------------------------------------------------------
    def _draw_np(self, key: np.ndarray) -> np.ndarray:
        """The host draw of one command from `key`: the Cranley–Patterson
        shift (sample_dims,) of the Halton table, or the (K, n_knots, nu)
        uniforms of the normal draw."""
        if self.cfg.sampling_method == "halton":
            return prng.uniform(key, (self._sample_dims,))
        return prng.normal_uniforms(key, (self.cfg.num_samples, self._n_knots, self.nu))

    def draws(self, key: np.ndarray, n: int):
        """n commands' draws ahead, from the key chain `_command_impl`
        follows: → (the key after n commands, (n, ...) float32 on the host)."""
        rows = []
        for _ in range(n):
            key, sub = prng.split(key)
            rows.append(self._draw_np(sub))
        return key, np.stack(rows)

    def noise(self, draw: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """→ (K, H, nu) noise ε with covariance `sigma` per (sample, step),
        from one command's draw."""
        c = self.cfg
        K, nu = c.num_samples, self.nu
        L = torch.linalg.cholesky_ex(sigma + self._eye * 1e-8).L
        if c.sampling_method == "halton":
            # Cranley–Patterson rotation refreshes the deterministic table
            u01 = torch.remainder(self._halton_base + draw, 1.0)
            z = torch.special.ndtri(torch.clamp(u01, 1e-6, 1 - 1e-6))
            z = z.reshape(K, self._n_knots, nu)
        else:
            z = torch.special.erfinv(draw) * np.float32(np.sqrt(2.0))
        eps = torch.einsum("ktj,ij->kti", z, L) + self._noise_mu
        if self._interp is not None:
            eps = torch.einsum("ht,ktn->khn", self._interp, eps)
        return eps

    # ------------------------------------------------------------------
    def _command_impl(self, carry: MppiCarry, state0, eps: Optional[torch.Tensor] = None,
                      draw: Optional[torch.Tensor] = None):
        """One MPPI command. state0 = (SimState_K, ModelParams_K). eps: inject
        the (K,H,nu) noise instead of sampling it (tests). draw: this
        command's draw, made ahead by `draws` (the carry's key is then the
        caller's to advance)."""
        c = self.cfg
        K, H, nu = c.num_samples, c.horizon, self.nu
        key = carry.key
        if eps is None and draw is None:
            with span("solver.draw"):
                key, d = self.draws(carry.key, 1)
                draw = torch.as_tensor(d[0], device=self.device)
        with span("solver.noise"):
            if eps is None:
                eps = self.noise(draw, carry.sigma)
            u_min, u_max = self._u_min, self._u_max
            # the special samples (null action, tape or prior) occupy the last
            # global sample slots: on the last rank only when sharded
            edge = self.rank == self.n_shards - 1
            V = torch.clamp(carry.U[None] + eps, u_min, u_max)            # (K,H,nu)
            if c.sample_null_action and edge:
                V[K - 1] = 0.0
            if self.tape_prior is not None and c.use_priors:
                # one sample rolls the prior's full tape; eps_eff below uses the
                # actual controls, so a winning tape drags U toward the tape
                with span("solver.tape"), tape_part():
                    tape = torch.clamp(self.tape_prior(state0, carry.t0).to(torch.float32),
                                       u_min, u_max)
                if c.prior_blend > 0.0:
                    # biased MPPI: the sampling mean moves toward the tape, while
                    # the importance term still measures deviation from U
                    a = self._prior_blend
                    V = torch.clamp((1 - a) * carry.U[None] + a * tape[None] + eps, u_min, u_max)
                    if c.sample_null_action and edge:
                        V[K - 1] = 0.0
                if edge:
                    V[K - 2] = tape
                    type(self).tape_injections += 1
            eps_eff = V - carry.U[None]
        if self.fused is not None:
            sim_state_K, params_K = state0
            costs, vis = self.fused.rollout(sim_state_K, params_K, V * c.u_scale)
        else:
            use_prior = self.prior is not None and c.use_priors
            with span("solver.rollout"):
                costs, vis, u_seq = self._rollout(state0, V, use_prior and edge)
            if use_prior:
                # the prior sample applies closed-loop actions, not its drawn
                # noise: the update uses the controls actually applied
                eps_eff = u_seq - carry.U[None]

        with span("solver.update"):
            sigma_inv = torch.linalg.inv_ex(carry.sigma + self._eye * 1e-8).inverse

            # action (control-noise) cost — MPPI information-theoretic term
            if c.noise_abs_cost:
                act_cost = carry.lambda_ * torch.einsum("khj,ij->khi", eps_eff.abs(),
                                                        sigma_inv.abs())
                action_cost = torch.sum(carry.U.abs()[None] * act_cost, dim=(-1, -2))
            else:
                act_cost = carry.lambda_ * torch.einsum("khj,ij->khi", eps_eff, sigma_inv)
                action_cost = torch.sum(carry.U[None] * act_cost, dim=(-1, -2))

            S = torch.sum(costs * self._gamma[None], dim=1) + action_cost      # (K,)
            beta = self._reduce(torch.min(S), dist.ReduceOp.MIN)
            scaled = -(S - beta) / torch.clamp(carry.lambda_, min=1e-6)
            eta = self._reduce(torch.sum(torch.exp(scaled)))
            w = torch.exp(scaled) / eta                                   # global weights

            dU = self._reduce(torch.einsum("k,khn->hn", w, eps_eff))
            U_new = carry.U + dU
            if self._sg is not None:
                # the Savitzky–Golay window over the edge-padded sequence, as
                # one (H, H) matrix
                U_new = self._sg @ U_new
            U_new = torch.clamp(U_new, u_min, u_max)

            action = U_new[: c.u_per_command] * c.u_scale                 # (u_per_command, nu)
            U_shift = torch.cat([U_new[c.u_per_command:],
                                 self._u_init.expand(c.u_per_command, nu)])

            lam = carry.lambda_
            if c.update_lambda:
                lam = torch.where(eta > c.eta_u_bound, lam * 0.9,
                                  torch.where(eta < c.eta_l_bound, lam * 1.1, lam))
                lam = torch.clamp(lam, 1e-4, 1e2)

            sigma = carry.sigma
            if c.update_cov:
                weighted = self._reduce(torch.einsum("k,khi,khj->ij", w, eps_eff, eps_eff) / H)
                sigma = 0.9 * sigma + 0.1 * weighted
                sigma = sigma + self._eye * 1e-5

            new_carry = MppiCarry(U=U_shift, lambda_=lam, sigma=sigma,
                                  t0=carry.t0 + c.u_per_command, key=key)
            info = {"costs": S, "weights": w, "eta": eta, "vis": vis, "best_cost": beta,
                    "rollout_costs": costs}
            if self.fused is None:
                info["applied"] = u_seq          # (K,H,nu) the controls each sample applied
        return action, new_carry, info

    # ------------------------------------------------------------------
    def _reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """x reduced over the ranks of `group` (x itself on one device)."""
        if self.group is not None:
            x = x.contiguous()
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def _rollout(self, state0, V: torch.Tensor, use_prior: bool):
        """The unfused rollout of the K samples from state0 under controls V
        (K,H,nu): → (costs (K,H), vis (H,K,d), the applied controls (K,H,nu)).
        With use_prior, sample K−2 applies the clipped prior command of its
        own state at each step."""
        c = self.cfg
        st = state0
        costs, vis, applied = [], [], []
        for t in range(c.horizon):
            u_t = V[:, t]
            if use_prior:
                pu = torch.clamp(self.prior(st, t), self._u_min, self._u_max)
                u_t = torch.where(self._prior_row[:, None], pu.to(u_t.dtype), u_t)
            st = self.dynamics(st, u_t * c.u_scale, t)
            costs.append(self.running_cost(st, t))
            if self.vis_fn is not None:
                vis.append(self.vis_fn(st))
            applied.append(u_t)
        K = V.shape[0]
        vis = torch.stack(vis) if vis else V.new_zeros(c.horizon, K, 0)
        return torch.stack(costs, 1), vis, torch.stack(applied, 1)

    def update_noise_sigma(self, sigma):
        """Online re-tuning: the covariance is one carry field."""
        self.cfg.noise_sigma = np.asarray(sigma, dtype=np.float64)
        self.carry = dataclasses.replace(
            self.carry, sigma=torch.as_tensor(np.asarray(sigma, np.float32), device=self.device))
