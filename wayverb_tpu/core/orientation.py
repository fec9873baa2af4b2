"""Orientations, azimuth/elevation math, random unit vectors.

Parity: reference ``core/orientation.h``, ``core/az_el.h``,
``core/azimuth_elevation.h`` (sphere_point convention: y is the polar axis —
``sphere_point(z, theta) = (t cos θ, z, t sin θ)`` with ``t = √(1-z²)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def sphere_point(z, theta):
    """Unit vector from height z ∈ [-1,1] and angle θ ∈ [-π,π]."""
    t = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([t * jnp.cos(theta), z, t * jnp.sin(theta)], axis=-1)


def random_unit_vectors(key, n: int, dtype=jnp.float32):
    """(n, 3) uniformly distributed unit vectors (stateless jax.random)."""
    kz, kt = jax.random.split(key)
    z = jax.random.uniform(kz, (n,), dtype=dtype, minval=-1.0, maxval=1.0)
    theta = jax.random.uniform(
        kt, (n,), dtype=dtype, minval=-jnp.pi, maxval=jnp.pi)
    return sphere_point(z, theta)


def azimuth(v):
    """Azimuth angle of (..., 3) vectors: atan2(x, z)."""
    return jnp.arctan2(v[..., 0], v[..., 2])


def elevation(v):
    """Elevation angle of (..., 3) vectors: asin(y / |v|)."""
    n = jnp.linalg.norm(v, axis=-1)
    return jnp.arcsin(jnp.clip(v[..., 1] / jnp.maximum(n, 1e-20), -1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class Orientation:
    """A pointing direction with an up vector — builds a rotation basis."""

    pointing: Any = (0.0, 0.0, 1.0)
    up: Any = (0.0, 1.0, 0.0)

    def matrix(self):
        """3x3 rotation: world → orientation-local coordinates."""
        z = jnp.asarray(self.pointing, dtype=jnp.float32)
        z = z / jnp.maximum(jnp.linalg.norm(z), 1e-20)
        up = jnp.asarray(self.up, dtype=jnp.float32)
        x = jnp.cross(up, z)
        x = x / jnp.maximum(jnp.linalg.norm(x), 1e-20)
        y = jnp.cross(z, x)
        return jnp.stack([x, y, z], axis=0)

    def transform(self, v):
        """Rotate world vectors (..., 3) into the local frame."""
        # HIGHEST: a GPU may run an f32 matmul in TF32 (~3 digits), which
        # would move directions across capsule/HRTF bin edges
        return jnp.matmul(v, self.matrix().T,
                          precision=jax.lax.Precision.HIGHEST)


def angle_lut_indices(v, num_az: int, num_el: int):
    """Bin directions (..., 3) into an az×el look-up table.

    Matches the reference ``vector_look_up_table`` convention
    (``core/vector_look_up_table.h``): azimuth wraps over ``num_az`` equal
    bins; elevation spans (-π/2, π/2) over ``num_el`` bins, with the poles
    clamped into the extreme bins.
    """
    az = azimuth(v)
    el = elevation(v)
    az_bin = jnp.floor(
        (az / (2.0 * jnp.pi) + 1.0) * num_az + 0.5).astype(jnp.int32) % num_az
    el_span = jnp.pi / num_el
    el_bin = jnp.clip(
        jnp.floor(el / el_span + 0.5).astype(jnp.int32) + num_el // 2,
        0, num_el - 1)
    return az_bin, el_bin
