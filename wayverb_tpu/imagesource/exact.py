"""Exact image-source solver for shoebox rooms.

For a cuboid the image lattice is closed-form (aretz p.71): image (i,j,k)
mirrors the source i times in x, j in y, k in z; angle-dependent wall
reflectance accumulates per axis.  This doubles as the validation oracle for
the general-geometry image-source machinery, exactly as in the reference.

Vectorized: the whole lattice is one (L, 3) batch — per-image attenuation is
a closed-form power, no recursion.  Differentiable w.r.t. source/receiver
positions and surface absorption.

Parity: reference ``raytracer/image_source/exact.h:50-100`` + ``exact.cpp``
(lattice position via odd/even fold, reflectance = Π_axis
r(z, cosθ_axis)^|order_axis|), ``get_direct.h`` (line-of-sight impulse).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from wayverb_tpu.core.geometry import Box, TriangleSoup, line_of_sight
from wayverb_tpu.core.impulse import Impulses
from wayverb_tpu.core.surfaces import (
    absorption_to_pressure_reflectance,
    pressure_reflectance_at_angle,
)


def image_source_positions(orders, source, dim):
    """Lattice positions for integer orders (L, 3).

    Even order along an axis keeps the source coordinate, odd order folds it
    to ``dim - source``; every order adds ``order · dim``.
    """
    folded = jnp.where(orders % 2 == 0, source, dim - source)
    return orders * dim + folded


def find_impulses(box: Box, source, receiver, surface_absorption,
                  max_distance: float) -> Impulses:
    """All image-source impulses within ``max_distance``.

    ``surface_absorption``: (bands,) shared by all six walls (the reference
    oracle supports exactly this).  Images beyond range carry zero volume
    (static shapes under jit).  Returned volumes do NOT include 1/r — apply
    ``core.impulse.apply_distance_pressure`` for pressure IRs.
    """
    lo = jnp.asarray(box.min_corner, dtype=jnp.float32)
    dim = jnp.asarray(box.max_corner, dtype=jnp.float32) - lo
    src = jnp.asarray(source, dtype=jnp.float32) - lo
    rcv = jnp.asarray(receiver, dtype=jnp.float32) - lo

    shells = [int(math.ceil(max_distance / float(d))) for d in dim]
    axes = [jnp.arange(-s, s + 1) for s in shells]
    gi, gj, gk = jnp.meshgrid(*axes, indexing="ij")
    orders = jnp.stack(
        [gi.reshape(-1), gj.reshape(-1), gk.reshape(-1)], axis=-1)  # (L, 3)

    positions = image_source_positions(orders, src, dim)            # (L, 3)
    diff = positions - rcv
    distance = jnp.linalg.norm(diff, axis=-1)
    cos_theta = jnp.abs(diff) / jnp.maximum(distance[:, None], 1e-8)  # (L, 3)

    r0 = absorption_to_pressure_reflectance(
        jnp.asarray(surface_absorption))                            # (bands,)
    # per-axis angle-dependent reflectance, then |order| reflections per axis
    refl = pressure_reflectance_at_angle(
        r0[None, None, :], cos_theta[:, :, None])                   # (L,3,b)
    volume = jnp.prod(refl ** jnp.abs(orders)[:, :, None], axis=1)  # (L,b)

    in_range = distance < max_distance
    volume = jnp.where(in_range[:, None], volume, 0.0)
    return Impulses(volume=volume, position=positions + lo,
                    distance=distance)


def get_direct(source, receiver, soup: TriangleSoup, bands: int = 8
               ) -> Impulses:
    """Line-of-sight impulse (unit volume) — zero volume when occluded."""
    source = jnp.asarray(source, dtype=jnp.float32)
    receiver = jnp.asarray(receiver, dtype=jnp.float32)
    visible = line_of_sight(source[None, :], receiver[None, :], soup)[0]
    dist = jnp.linalg.norm(receiver - source)
    nonzero = dist > 0
    volume = jnp.where(visible & nonzero, 1.0, 0.0) * jnp.ones((1, bands))
    return Impulses(volume=volume, position=source[None, :],
                    distance=dist[None])
