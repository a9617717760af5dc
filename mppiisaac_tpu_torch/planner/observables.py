"""SimView — the state-access API of objectives, success checks and tests:
one view over (scene, batched SimState) whose getters return K-batched
tensors (parity: the JAX package's `planner/observables.py`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..physics.types import SimState
from ..scene.builder import BuiltScene


class SimView:
    def __init__(self, built: BuiltScene, state: SimState):
        self.built = built
        self.scene = built.scene
        self.state = state

    def _ai(self, name: str) -> int:
        return self.scene.actor_index(name)

    def actor_position(self, name: str) -> torch.Tensor:       # (K,3)
        return self.state.root_pos[..., self._ai(name), :]

    def link_position(self, link: str, actor: Optional[str] = None) -> torch.Tensor:
        return self.state.body_pos[..., self.scene.body_index(link, actor), :]

    def link_state(self, link: str, actor: Optional[str] = None) -> torch.Tensor:
        """(K,13) rigid-body state of a link (pose + velocities)."""
        return self.state.rigid_body_state[..., self.scene.body_index(link, actor), :]

    def link_contact_force(self, link: str, actor: Optional[str] = None) -> torch.Tensor:
        """(K,3) net contact force on a link."""
        return self.state.net_contact_force[..., self.scene.body_index(link, actor), :]

    def get_actor_contact_forces_by_name(self, actor_name: str, link_name: Optional[str] = None) -> torch.Tensor:
        """(K,3) net contact force of an actor's link; the actor's root body
        when the link is not found (primitives are single-body actors)."""
        try:
            if link_name is not None:
                return self.link_contact_force(link_name, actor_name)
        except KeyError:
            pass
        return self.state.net_contact_force[..., self.scene.body_offset[self._ai(actor_name)], :]
