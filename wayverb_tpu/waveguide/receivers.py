"""Receiver postprocessors: per-step taps on the pressure field.

Parity: reference ``waveguide/postprocessor/node.h`` (single-node pressure)
and ``postprocessor/directional_receiver.cpp:29-69`` (6-neighbour pressure
gradient → discrete velocity integrator → instantaneous intensity vector).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from wayverb_tpu.waveguide.descriptor import (DIRECTION_OFFSETS,
                                              MeshDescriptor)


class SeqTapView:
    """Sequential flat-field stand-in for replaying ``receiver.tap`` over a
    (k,) row of pre-gathered pressures.

    Receivers read the field with one or more ``field[idx]`` gathers whose
    index arrays, concatenated in read order, equal ``tap_nodes()``; each
    ``__getitem__`` hands out the next segment of the row.  The sharded
    solvers gather the tap nodes across shards with one psum and replay the
    receiver's arithmetic through this view.
    """

    def __init__(self, row):
        self._row = row
        self._pos = 0

    def __getitem__(self, idx):
        n = int(np.prod(np.shape(idx))) if np.ndim(idx) else 1
        seg = self._row[self._pos:self._pos + n]
        self._pos += n
        return seg.reshape(np.shape(idx))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class NodeReceiver:
    node_idx: Any

    def tree_flatten(self):
        return (self.node_idx,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def init_state(self, dtype=jnp.float32):
        return ()

    def tap_nodes(self):
        """Flat indices this receiver reads, in ``tap`` read order (the
        sharded solvers gather exactly these per step, see ``SeqTapView``)."""
        return jnp.reshape(self.node_idx, (1,))

    def tap(self, field_flat, state):
        return state, field_flat[self.node_idx]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MultiNodeReceiver:
    """Pressure taps at several nodes at once (reference
    ``bin/waveguide_distance_test`` builds one ``postprocessor::node`` per
    receiver; here one gather serves them all)."""

    node_idx: Any          # (N,) flat indices

    def tree_flatten(self):
        return (self.node_idx,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def init_state(self, dtype=jnp.float32):
        return ()

    def tap_nodes(self):
        return jnp.reshape(self.node_idx, (-1,))

    def tap(self, field_flat, state):
        return state, field_flat[self.node_idx]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DirectionalReceiver:
    """Velocity-integrating intensity probe at one mesh node."""

    node_idx: Any          # scalar flat index
    neighbor_idx: Any      # (6,) flat indices
    spacing: Any           # mesh spacing
    inv_density_dt: Any    # 1/(ambient_density · sample_rate)

    def tree_flatten(self):
        return (self.node_idx, self.neighbor_idx, self.spacing,
                self.inv_density_dt), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def init_state(self, dtype=jnp.float32):
        return jnp.zeros(3, dtype=dtype)

    def tap_nodes(self):
        return jnp.concatenate([jnp.reshape(self.node_idx, (1,)),
                                jnp.reshape(self.neighbor_idx, (-1,))])

    def tap(self, field_flat, velocity):
        """Returns (new_velocity, (intensity (3,), pressure ()))."""
        p = field_flat[self.node_idx]
        surrounding = (field_flat[self.neighbor_idx] - p) / self.spacing
        gradient = 0.5 * jnp.stack([
            surrounding[1] - surrounding[0],
            surrounding[3] - surrounding[2],
            surrounding[5] - surrounding[4],
        ])
        velocity = velocity - gradient * self.inv_density_dt
        intensity = velocity * p
        return velocity, (intensity, p)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class InterpolatedReceiver:
    """Trilinear pressure tap at a CONTINUOUS position — differentiable
    w.r.t. ``position`` (BASELINE: gradients w.r.t. receiver positions).

    The 8-corner cell is fixed at construction (the cell containing the
    nominal position); within it the interpolation — and its position
    gradient — is exact.
    """

    corner_idx: Any      # (8,) flat indices (binary corner order zyx)
    base_position: Any   # (3,) position of corner 0
    position: Any        # (3,) continuous tap position — differentiable
    spacing: Any

    def tree_flatten(self):
        return (self.corner_idx, self.base_position, self.position,
                self.spacing), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def init_state(self, dtype=jnp.float32):
        return ()

    def tap_nodes(self):
        return jnp.reshape(self.corner_idx, (-1,))

    def tap(self, field_flat, state):
        vals = field_flat[self.corner_idx]               # (8,)
        f = jnp.clip((self.position - self.base_position) / self.spacing,
                     0.0, 1.0)                            # (3,)
        bits = jnp.asarray([[(c >> a) & 1 for a in range(3)]
                            for c in range(8)], dtype=jnp.float32)
        w = jnp.prod(jnp.where(bits > 0, f[None, :], 1.0 - f[None, :]),
                     axis=-1)
        return state, jnp.sum(w * vals)


def make_interpolated_receiver(desc: MeshDescriptor, position
                               ) -> InterpolatedReceiver:
    loc = desc.locator(position)
    base = np.asarray(desc.position(loc))
    if np.any(base > np.asarray(position)):
        loc = loc - (base > np.asarray(position)).astype(loc.dtype)
        base = np.asarray(desc.position(loc))
    dims = np.asarray(desc.dimensions)
    corners = np.stack([loc + [(c >> a) & 1 for a in range(3)]
                        for c in range(8)])
    if np.any(corners < 0) or np.any(corners >= dims):
        raise RuntimeError("interpolation cell leaves the mesh")
    flat = np.ravel_multi_index(
        (corners[:, 0], corners[:, 1], corners[:, 2]),
        desc.dimensions).astype(np.int32)
    return InterpolatedReceiver(
        corner_idx=jnp.asarray(flat),
        base_position=jnp.asarray(base.astype(np.float32)),
        position=jnp.asarray(position, dtype=jnp.float32),
        spacing=jnp.float32(desc.spacing))


def make_directional_receiver(desc: MeshDescriptor, sample_rate: float,
                              ambient_density: float, position
                              ) -> DirectionalReceiver:
    loc = desc.locator(position)
    dims = np.asarray(desc.dimensions)
    neighbors = loc[None, :] + DIRECTION_OFFSETS
    if np.any(neighbors < 0) or np.any(neighbors >= dims):
        raise RuntimeError(
            "can't place directional receiver adjacent to the mesh edge")
    flat = lambda l: np.ravel_multi_index(            # noqa: E731
        (l[..., 0], l[..., 1], l[..., 2]), desc.dimensions).astype(np.int32)
    return DirectionalReceiver(
        node_idx=jnp.asarray(flat(loc)),
        neighbor_idx=jnp.asarray(flat(neighbors)),
        spacing=jnp.float32(desc.spacing),
        inv_density_dt=jnp.float32(1.0 / (ambient_density * sample_rate)),
    )
