"""Impulse batches: the common currency between the geometric solvers and IR
assembly.

A batch is struct-of-arrays (accelerator-first: everything vectorizes over the
impulse axis): ``volume`` (N, bands) per-band pressure/energy, ``position``
(N, 3), ``distance`` (N,) path length in metres.  Masked-out entries carry
zero volume (static shapes instead of the reference's dynamic vectors).

Parity: reference ``raytracer/cl/structs.h`` (``impulse<8>``,
``attenuated_impulse``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Impulses:
    volume: Any     # (N, bands)
    position: Any   # (N, 3)
    distance: Any   # (N,)

    def tree_flatten(self):
        return (self.volume, self.position, self.distance), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def count(self) -> int:
        return self.volume.shape[0]

    def concatenate(self, other: "Impulses") -> "Impulses":
        return Impulses(
            jnp.concatenate([self.volume, other.volume], axis=0),
            jnp.concatenate([self.position, other.position], axis=0),
            jnp.concatenate([self.distance, other.distance], axis=0),
        )


def apply_distance_pressure(impulses: Impulses, acoustic_impedance):
    """Scale volumes by √(Z/4π)/d — spherical spreading in pressure terms.

    Parity: ``reflection_processor/image_source.cpp:61-65``.
    """
    scale = jnp.sqrt(acoustic_impedance / (4.0 * jnp.pi)) / \
        jnp.maximum(impulses.distance, 1e-8)
    return dataclasses.replace(
        impulses, volume=impulses.volume * scale[:, None])
