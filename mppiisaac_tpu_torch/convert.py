"""Converters from the JAX package's state objects to the port's.

Each function takes the JAX object (a NamedTuple of arrays) and reads its
fields through `numpy.asarray`, so this module needs numpy and torch only.
Tests use them to feed both packages identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .mppi.solver import MppiCarry
from .physics.types import SIM_STATE_FIELDS, ModelParams, SimState


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def sim_state_from_jax(state, device="cpu") -> SimState:
    """JAX `SimState` (13 leaves; contact_lam may be None) → port SimState."""
    return SimState(**{
        f: (None if getattr(state, f) is None else _t(getattr(state, f), device))
        for f in SIM_STATE_FIELDS
    })


def model_params_from_jax(params, device="cpu") -> ModelParams:
    return ModelParams(
        body_mass_scale=_t(params.body_mass_scale, device),
        geom_friction=_t(params.geom_friction, device),
    )


def carry_from_jax(carry, device="cpu") -> MppiCarry:
    """JAX `MppiCarry` → port carry: U, λ, Σ, the step clock and the PRNG
    key."""
    return MppiCarry(
        U=_t(carry.U, device),
        lambda_=_t(carry.lambda_, device),
        sigma=_t(carry.sigma, device),
        t0=int(np.asarray(carry.t0)),
        key=np.array(carry.key, np.uint32),
    )
