"""Stochastic ray tracer: the whole bounce loop lives on-device in one scan.

Where the reference launches a kernel per bounce and reads every reflection
batch back to the host (``raytracer.h:188-266``, §3.2 of SURVEY.md), here a
``lax.scan`` over reflection depth carries the full ray state — positions,
directions, per-band energies, RNG key — and deposits energy into the
directional histogram with masked scatter-adds.  Rays are a pure batch axis
(vmapped / shardable across chips).

Physics parity:
 * reflection kernel ``src/program.cpp:51-153``: closest hit (excluding the
   launching triangle), receiver visibility, specular direction, Lambert
   scattering mix ``normalize(l·s̄ + spec·(1−s̄))`` with the mean scattering
   coefficient.
 * stochastic kernel ``src/stochastic/program.cpp:58-152``: per-band energy
   × (1−absorption); specular detection via segment–sphere crossing (volume
   BEFORE this bounce's wall loss, path from the previous position);
   diffuse rain per schroder2011 eq 5.20:
   ``(1−√(1−sin²γ))·2·cosθ·scattered``.
 * initial energy ``finder.h:18-25``: 2/(4π·N·d²·(1−cosγ)).
 * reflection count ``optimum_reflection_number.h:37-40``:
   ⌈−6/log₁₀(1−a_min)⌉.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from wayverb_tpu.core.environment import Environment
from wayverb_tpu.core.geometry import (TriangleSoup,
                                       line_of_sight,
                                       line_segment_sphere_intersection,
                                       scene_intersection, triangle_normals)
from wayverb_tpu.core.orientation import angle_lut_indices, \
    random_unit_vectors
from wayverb_tpu.core.surfaces import Surface

DEFAULT_RECEIVER_RADIUS = 0.1      # simulation_parameters.h:25-33
DEFAULT_HISTOGRAM_SR = 1000.0
DIRECTIONAL_AZ = 20                # stochastic_histogram.h:210
DIRECTIONAL_EL = 9


def compute_optimum_reflection_number(min_absorption: float) -> int:
    return int(math.ceil(-6.0 / math.log10(1.0 - min_absorption)))


def compute_ray_energy(total_rays: int, source, receiver,
                       receiver_radius: float):
    """Initial per-ray energy (traceable: source/receiver may be tracers)."""
    dist = jnp.linalg.norm(jnp.asarray(receiver) - jnp.asarray(source))
    # a source inside the receiver sphere would give infinite energy; the
    # engine validates placements, this clamp keeps the math finite anyway
    dist = jnp.maximum(dist, receiver_radius)
    sin_y = receiver_radius / jnp.maximum(receiver_radius, dist)
    cos_y = jnp.sqrt(1.0 - sin_y * sin_y)
    return 2.0 / (4.0 * jnp.pi * total_rays * dist * dist * (1.0 - cos_y))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TraceResults:
    """Everything one trace produces."""

    histogram: Any          # (bins, az, el, bands) directional energy
    triangle_history: Any   # (depth, R) int32 — hit triangle or -1
    histogram_sample_rate: float
    positions: Any = None   # (depth, R, 3) reflection points (visual mode)

    def tree_flatten(self):
        return ((self.histogram, self.triangle_history, self.positions),
                self.histogram_sample_rate)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux, children[2])

    def summed_histogram(self):
        """(bins, bands) energy histogram (directional summed out)."""
        return jnp.sum(self.histogram, axis=(1, 2))

    def max_time(self) -> float:
        """Time of the last nonzero histogram bin (max_stochastic_time)."""
        energy = jnp.sum(self.summed_histogram(), axis=-1)
        nz = jnp.nonzero(energy > 0, size=energy.shape[0],
                         fill_value=-1)[0]
        last = int(jnp.max(nz))
        return (last + 1) / self.histogram_sample_rate


def trace(soup: TriangleSoup, surfaces: Surface, source, receiver, key,
          num_rays: int, depth: int, max_time: float,
          environment: Environment = Environment(),
          receiver_radius: float = DEFAULT_RECEIVER_RADIUS,
          histogram_sample_rate: float = DEFAULT_HISTOGRAM_SR,
          max_image_source_order: int = 0,
          capture_positions: bool = False,
          accel=None, active_depth=None, time_cutoff=None) -> TraceResults:
    """Trace ``num_rays`` rays for ``depth`` bounces.

    ``surfaces``: (S, bands) material table indexed by ``soup.surfaces``.
    Specular (non-scattered) receiver crossings only contribute from bounce
    ``max_image_source_order`` on — below that the image-source solver
    covers them deterministically.

    ``accel``: optional ``accel.RayGrid`` — intersection and visibility
    queries then run the batched voxel DDA (O(K·cells) per ray) instead of
    the dense (R, T) broadcast; build one with ``accel.build_ray_grid``
    for scenes beyond a few hundred triangles.

    ``active_depth``/``time_cutoff``: optional TRACED limits under padded
    static ``depth``/``max_time`` — bounces past ``active_depth`` are
    masked dead and deposits past ``time_cutoff`` dropped, so
    ``trace_jit`` can pad the static shape knobs to coarse buckets and
    changing absorption/geometry (which moves the optimum reflection
    count, ``optimum_reflection_number``) does NOT retrigger compilation
    (VERDICT r3/r4: recompile cliffs).
    """
    source = jnp.asarray(source, dtype=jnp.float32)
    receiver = jnp.asarray(receiver, dtype=jnp.float32)
    bands = surfaces.absorption.shape[-1]
    bins = int(math.ceil(max_time * histogram_sample_rate)) + 1

    starting_energy = compute_ray_energy(num_rays, source, receiver,
                                         receiver_radius)
    normals = triangle_normals(soup)                        # (T, 3)
    speed = environment.speed_of_sound

    init_dirs = random_unit_vectors(key, num_rays)
    carry0 = dict(
        key=jax.random.fold_in(key, 0xFACE),
        pos=jnp.tile(source[None, :], (num_rays, 1)),
        dirs=init_dirs,
        alive=jnp.ones((num_rays,), dtype=bool),
        volume=jnp.full((num_rays, bands), starting_energy),
        path_pos=jnp.tile(source[None, :], (num_rays, 1)),
        path_dist=jnp.zeros((num_rays,)),
        prev_tri=jnp.full((num_rays,), -1, dtype=jnp.int32),
        hist=jnp.zeros((bins, DIRECTIONAL_AZ, DIRECTIONAL_EL, bands)),
    )

    def deposit(hist, positions, distances, volumes, mask):
        """Masked scatter-add of impulses into the directional histogram."""
        times = distances / speed
        if time_cutoff is not None:
            mask = mask & (times <= time_cutoff)
        bin_idx = jnp.floor(times * histogram_sample_rate).astype(jnp.int32)
        bin_idx = jnp.where(mask, bin_idx, bins + 1)   # dropped by mode
        pointing = positions - receiver
        az, el = angle_lut_indices(pointing, DIRECTIONAL_AZ, DIRECTIONAL_EL)
        vols = jnp.where(mask[:, None], volumes, 0.0)
        # scatter-add: on a GPU colliding deposits sum in an order that
        # changes from run to run (atomics), so histograms agree with the
        # CPU to f32 rounding of each bin's sum, not bitwise
        return hist.at[bin_idx, az, el].add(vols, mode="drop")

    if accel is not None:
        from wayverb_tpu.raytracer.accel import (grid_intersection,
                                                 grid_line_of_sight)
        intersect = lambda p, d, ex: grid_intersection(    # noqa: E731
            p, d, accel, soup, exclude_triangle=ex)
        los = lambda a, b, ex: grid_line_of_sight(         # noqa: E731
            a, b, accel, soup, exclude_triangle=ex)
    else:
        intersect = lambda p, d, ex: scene_intersection(   # noqa: E731
            p, d, soup, exclude_triangle=ex)
        los = lambda a, b, ex: line_of_sight(              # noqa: E731
            a, b, soup, exclude_triangle=ex)

    def body(carry, step):
        key = carry["key"]
        pos, dirs = carry["pos"], carry["dirs"]

        t, tri, hit = intersect(pos, dirs, carry["prev_tri"])
        alive = carry["alive"] & hit
        if active_depth is not None:
            # padded-depth masking: bounces past the traced limit are
            # dead (monotone — once masked, rays never revive)
            alive = alive & (step < active_depth)
        ipt = pos + dirs * t[:, None]

        tri_surface = soup.surfaces[tri]
        absorption = surfaces.absorption[tri_surface]       # (R, bands)
        scattering = surfaces.scattering[tri_surface]
        reflectance = 1.0 - absorption

        last_volume = carry["volume"]
        outgoing = last_volume * reflectance

        last_pos = carry["path_pos"]
        last_dist = carry["path_dist"]
        this_dist = last_dist + jnp.linalg.norm(ipt - last_pos, axis=-1)

        hist = carry["hist"]

        # specular detection: the segment from the previous reflection point
        # crosses the receiver sphere; energy BEFORE this wall's absorption
        crosses = line_segment_sphere_intersection(
            last_pos, ipt, receiver, receiver_radius)
        spec_dist = last_dist + jnp.linalg.norm(receiver - last_pos, axis=-1)
        spec_mask = alive & crosses & (step >= max_image_source_order)
        hist = deposit(hist, last_pos, spec_dist, last_volume, spec_mask)

        # diffuse rain toward the visible receiver
        visible = los(ipt, jnp.tile(receiver[None, :],
                                    (ipt.shape[0], 1)), tri)
        to_recv = receiver - ipt
        to_recv_dist = jnp.linalg.norm(to_recv, axis=-1)
        n = normals[tri]
        cos_angle = jnp.abs(jnp.sum(
            n * to_recv / jnp.maximum(to_recv_dist[:, None], 1e-12), axis=-1))
        sin_y = receiver_radius / jnp.maximum(receiver_radius, to_recv_dist)
        angle_correction = 1.0 - jnp.sqrt(jnp.maximum(1.0 - sin_y ** 2, 0.0))
        rain_volume = (angle_correction * 2.0 * cos_angle)[:, None] * \
            outgoing * scattering
        hist = deposit(hist, ipt, this_dist + to_recv_dist, rain_volume,
                       alive & visible)

        # next ray: lambert-mixed scattering around the specular direction
        spec_dir = dirs - 2.0 * jnp.sum(dirs * n, axis=-1, keepdims=True) * n
        # flip normal to the side the specular leaves from
        n_oriented = n * jnp.sign(
            jnp.sum(n * spec_dir, axis=-1, keepdims=True))
        key, sub = jax.random.split(key)
        rand = random_unit_vectors(sub, pos.shape[0])
        lambert = rand * jnp.sign(
            jnp.sum(rand * n_oriented, axis=-1, keepdims=True))
        s_mean = jnp.mean(scattering, axis=-1, keepdims=True)
        new_dir = lambert * s_mean + spec_dir * (1.0 - s_mean)
        new_dir = new_dir / jnp.maximum(
            jnp.linalg.norm(new_dir, axis=-1, keepdims=True), 1e-12)

        new_carry = dict(
            key=key,
            pos=jnp.where(alive[:, None], ipt, pos),
            dirs=jnp.where(alive[:, None], new_dir, dirs),
            alive=alive,
            volume=jnp.where(alive[:, None], outgoing, carry["volume"]),
            path_pos=jnp.where(alive[:, None], ipt, last_pos),
            path_dist=jnp.where(alive, this_dist, last_dist),
            prev_tri=jnp.where(alive, tri, carry["prev_tri"]),
            hist=hist,
        )
        record = jnp.where(alive, tri, -1).astype(jnp.int32)
        if capture_positions:
            # per-bounce reflection points for visualisation (reference
            # reflection_processor/visual.h); dead rays freeze in place
            return new_carry, (record, new_carry["pos"])
        return new_carry, record

    carry, ys = jax.lax.scan(body, carry0, jnp.arange(depth))
    if capture_positions:
        triangle_history, positions = ys
    else:
        triangle_history, positions = ys, None
    return TraceResults(histogram=carry["hist"],
                        triangle_history=triangle_history,
                        histogram_sample_rate=histogram_sample_rate,
                        positions=positions)


_trace_jit = jax.jit(
    trace,
    static_argnames=("num_rays", "depth", "max_time", "environment",
                     "receiver_radius", "histogram_sample_rate",
                     "max_image_source_order", "capture_positions"))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def trace_jit(soup, surfaces, source, receiver, key, num_rays: int,
              depth: int, max_time: float, **kwargs) -> TraceResults:
    """``trace`` under jit with RECOMPILE-STABLE static shapes.

    ``depth`` is padded to the next power of two and ``max_time`` to the
    next power-of-two multiple of 0.25 s; the requested values pass as
    TRACED limits (``active_depth``/``time_cutoff``), so sweeping
    absorption or geometry — which moves ``optimum_reflection_number``
    and the stochastic horizon — reuses one compiled executable per
    bucket instead of recompiling the bounce scan every call (VERDICT
    r3/r4 recompile-cliff item).  The returned histogram is padded with
    trailing zero bins (silence) past ``max_time``; consumers already
    handle arbitrary tail lengths.
    """
    import math as _m
    pad_depth = _next_pow2(max(int(depth), 1))
    pad_time = 0.25 * _next_pow2(
        max(int(_m.ceil(float(max_time) / 0.25)), 1))
    return _trace_jit(soup, surfaces, source, receiver, key,
                      num_rays=num_rays, depth=pad_depth,
                      max_time=pad_time,
                      active_depth=jnp.asarray(depth, jnp.int32),
                      time_cutoff=jnp.asarray(max_time, jnp.float32),
                      **kwargs)
