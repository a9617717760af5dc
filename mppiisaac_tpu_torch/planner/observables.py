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

    # raw tensors (reference layout)
    @property
    def root_state(self) -> torch.Tensor:           # (K,A,13)
        return self.state.root_state

    @property
    def dof_state(self) -> torch.Tensor:            # (K,D,2)
        return self.state.dof_state

    @property
    def rigid_body_state(self) -> torch.Tensor:     # (K,B,13)
        return self.state.rigid_body_state

    @property
    def net_cf(self) -> torch.Tensor:               # (K,B,3)
        return self.state.net_contact_force

    @property
    def num_bodies(self) -> int:
        return self.scene.nbody

    def _ai(self, name: str) -> int:
        return self.scene.actor_index(name)

    def actor_position(self, name: str) -> torch.Tensor:       # (K,3)
        return self.state.root_pos[..., self._ai(name), :]

    def actor_orientation(self, name: str) -> torch.Tensor:    # (K,4) xyzw
        return self.state.root_quat[..., self._ai(name), :]

    def actor_linvel(self, name: str) -> torch.Tensor:         # (K,3)
        return self.state.root_linvel[..., self._ai(name), :]

    def actor_angvel(self, name: str) -> torch.Tensor:        # (K,3)
        return self.state.root_angvel[..., self._ai(name), :]

    # reference-style aliases
    get_actor_position_by_name = actor_position
    get_actor_orientation_by_name = actor_orientation
    get_actor_velocity_by_name = actor_linvel

    def actor_q(self, name: str) -> torch.Tensor:              # (K,ndof of the actor)
        return self.state.q[..., self.scene.actor_dof_slice(name)]

    def actor_qd(self, name: str) -> torch.Tensor:             # (K,ndof of the actor)
        return self.state.qd[..., self.scene.actor_dof_slice(name)]

    def actor_contact_forces(self, name: str) -> torch.Tensor:  # (K,nbody of the actor,3)
        ai = self._ai(name)
        o = self.scene.body_offset[ai]
        return self.state.net_contact_force[..., o: o + self.scene.actors[ai].nbody, :]

    def link_position(self, link: str, actor: Optional[str] = None) -> torch.Tensor:
        return self.state.body_pos[..., self.scene.body_index(link, actor), :]

    def link_orientation(self, link: str, actor: Optional[str] = None) -> torch.Tensor:
        return self.state.body_quat[..., self.scene.body_index(link, actor), :]

    def link_velocity(self, link: str, actor: Optional[str] = None) -> torch.Tensor:
        return self.state.body_linvel[..., self.scene.body_index(link, actor), :]

    def link_state(self, link: str, actor: Optional[str] = None) -> torch.Tensor:
        """(K,13) rigid-body state of a link (pose + velocities)."""
        return self.state.rigid_body_state[..., self.scene.body_index(link, actor), :]

    def get_actor_link_by_name(self, actor: str, link: str) -> torch.Tensor:
        """The reference's argument order: (actor, link) → (K,13)."""
        return self.link_state(link, actor)

    def get_dof_state(self) -> torch.Tensor:
        """(K, 2·D) interleaved flat dof state."""
        ds = self.state.dof_state
        return ds.reshape(ds.shape[:-2] + (-1,))

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

    # robot shorthand (single-robot scenes)
    @property
    def robot_name(self) -> str:
        return self.built.robot_names[0]

    def ee_position(self) -> torch.Tensor:
        """(K,3) position of the first visualize link."""
        return self.state.body_pos[..., self.built.visualize_bodies[0], :]
