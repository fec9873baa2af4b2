"""Device-side voxel acceleration for ray–scene queries.

The reference marches a voxel grid per ray inside its OpenCL kernels
(``src/core/src/cl/voxel.cpp:85-156`` DDA, ``:197-258`` traversal +
intersection); round 1/2 intersected every ray against every triangle
(O(R·T) broadcast, fine for 12-triangle shoeboxes, hopeless for halls).

Here: an Amanatides–Woo DDA over ALL rays at once inside a
``lax.while_loop`` — each iteration gathers the (padded, fixed-K) triangle
list of every ray's current cell, runs one batched Möller–Trumbore over the
(R, K) block, and advances the not-yet-done rays to their next cell.  Work
per bounce is O(R · K · cells-visited) instead of O(R · T); all control
flow is mask-based (no per-ray divergence — rays that finish early ride
along as masked lanes until the loop converges).

The grid is built host-side at setup with conservative AABB binning
(a superset of the reference's tri-cube overlap test — extra tests cost
a little speed, never correctness).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from wayverb_tpu.core.geometry import (EPSILON, TriangleSoup,
                                       ray_triangle_intersection)

# Scenes up to this many triangles trace with the dense broadcast
# (``auto_accel``).  On an H100 (2¹⁶ rays × 40 bounces,
# tools/bench/accel_crossover.py) the dense broadcast is 13× the DDA at 12
# triangles, 1.8× at 1,092, 1.13× at 2,376, and 0.97× at 5,448: the two
# cross near 4-5k triangles (PERF.md).
DENSE_MAX_TRIS = 4096


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RayGrid:
    """Uniform voxel grid over the scene for device-side traversal.

    ``cells``: (C, K) int32 triangle ids, padded with -1 (C = rx·ry·rz,
    flat C-order).  ``lo``/``voxel``: grid origin and per-axis voxel size.
    ``res`` is static (pytree aux) so the traversal compiles per grid
    resolution, not per scene.
    """

    cells: Any               # (C, K) int32
    lo: Any                  # (3,) f32
    voxel: Any               # (3,) f32
    res: Tuple[int, int, int]

    def tree_flatten(self):
        return (self.cells, self.lo, self.voxel), self.res

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux)

    @property
    def max_per_cell(self) -> int:
        return self.cells.shape[1]


def build_ray_grid(soup: TriangleSoup, resolution: Optional[int] = None,
                   pad: float = 1e-3) -> RayGrid:
    """Bin triangles into a uniform grid (host-side numpy, setup time).

    ``resolution``: cells per axis (default ≈ cbrt(T/4), clamped to
    [4, 32] — a few triangles per cell on typical scenes).
    """
    verts = np.asarray(soup.vertices)
    tris = np.asarray(soup.triangles)
    T = len(tris)
    if resolution is None:
        resolution = int(np.clip(round((T / 4.0) ** (1.0 / 3.0)), 4, 32))
    res = (resolution, resolution, resolution)

    lo = verts.min(axis=0) - pad
    hi = verts.max(axis=0) + pad
    voxel = (hi - lo) / np.asarray(res)

    corners = verts[tris]                       # (T, 3, 3)
    tmin = corners.min(axis=1)                  # (T, 3)
    tmax = corners.max(axis=1)
    cmin = np.clip(((tmin - lo) / voxel).astype(np.int64), 0,
                   np.asarray(res) - 1)
    cmax = np.clip(((tmax - lo) / voxel).astype(np.int64), 0,
                   np.asarray(res) - 1)

    buckets: dict = {}
    for t in range(T):
        for ix in range(cmin[t, 0], cmax[t, 0] + 1):
            for iy in range(cmin[t, 1], cmax[t, 1] + 1):
                for iz in range(cmin[t, 2], cmax[t, 2] + 1):
                    buckets.setdefault(
                        (ix * res[1] + iy) * res[2] + iz, []).append(t)

    K = max((len(v) for v in buckets.values()), default=1)
    C = res[0] * res[1] * res[2]
    cells = np.full((C, K), -1, dtype=np.int32)
    for c, ids in buckets.items():
        cells[c, :len(ids)] = ids
    return RayGrid(cells=jnp.asarray(cells), lo=jnp.asarray(
        lo.astype(np.float32)), voxel=jnp.asarray(
        voxel.astype(np.float32)), res=res)


def grid_intersection(origin, direction, grid: RayGrid, soup: TriangleSoup,
                      exclude_triangle=None, max_steps: Optional[int] = None):
    """Closest hit via batched voxel DDA; same contract as
    ``geometry.scene_intersection``: returns (t, tri_index, hit) each (R,).

    Parity: ``voxel.cpp:85-156`` (DDA setup/march) + ``:197-226`` (per-cell
    closest intersection with early exit once a hit lies inside the current
    cell).
    """
    R = origin.shape[0]
    res = jnp.asarray(grid.res, dtype=jnp.int32)
    if max_steps is None:
        max_steps = int(sum(grid.res)) + 2
    corners_all = soup.corners()                # (T, 3, 3)
    if exclude_triangle is None:
        exclude_triangle = jnp.full((R,), -1, dtype=jnp.int32)

    d = direction
    sgn = jnp.where(d >= 0, 1, -1).astype(jnp.int32)          # (R, 3)
    inv_d = jnp.where(jnp.abs(d) > 1e-20, 1.0 / jnp.where(
        jnp.abs(d) > 1e-20, d, 1.0), 1e20)

    rel = (origin - grid.lo) / grid.voxel
    cell0 = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0, res - 1)
    # parametric distance to the next boundary along each axis
    next_bound = (cell0 + (sgn > 0)).astype(jnp.float32) * grid.voxel \
        + grid.lo
    tmax0 = (next_bound - origin) * inv_d                      # (R, 3)
    tmax0 = jnp.where(jnp.abs(d) > 1e-20, tmax0, jnp.inf)
    tdelta = jnp.abs(grid.voxel * inv_d)

    big = jnp.float32(jnp.inf)
    state = dict(
        cell=cell0, tmax=tmax0,
        best_t=jnp.full((R,), big), best_tri=jnp.zeros((R,), jnp.int32),
        found=jnp.zeros((R,), bool), done=jnp.zeros((R,), bool),
        steps=jnp.int32(0),
    )

    def cond(s):
        return (~jnp.all(s["done"])) & (s["steps"] < max_steps)

    def body(s):
        cell, tmax = s["cell"], s["tmax"]
        flat = (cell[:, 0] * res[1] + cell[:, 1]) * res[2] + cell[:, 2]
        ids = grid.cells[flat]                          # (R, K)
        corners = corners_all[jnp.maximum(ids, 0)]      # (R, K, 3, 3)
        t, _, _, hit = ray_triangle_intersection(
            origin[:, None, :], d[:, None, :], corners)
        valid = hit & (ids >= 0) & (ids != exclude_triangle[:, None]) \
            & (t > EPSILON)
        t = jnp.where(valid, t, big)
        k = jnp.argmin(t, axis=-1)
        t_cell = jnp.take_along_axis(t, k[:, None], axis=-1)[:, 0]
        tri_cell = jnp.take_along_axis(ids, k[:, None], axis=-1)[:, 0]

        better = (~s["done"]) & (t_cell < s["best_t"])
        best_t = jnp.where(better, t_cell, s["best_t"])
        best_tri = jnp.where(better, tri_cell, s["best_tri"])
        found = s["found"] | (better & jnp.isfinite(t_cell))

        # a hit is final once it lies within the current cell (closer cells
        # along the ray have all been visited)
        t_exit = jnp.min(tmax, axis=-1)
        done_hit = found & (best_t <= t_exit + 1e-5)

        # advance: step the axis with the smallest tmax
        axis = jnp.argmin(tmax, axis=-1)                # (R,)
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        new_cell = cell + onehot * sgn
        new_tmax = tmax + onehot.astype(tmax.dtype) * tdelta
        out = jnp.any((new_cell < 0) | (new_cell >= res), axis=-1)

        done = s["done"] | done_hit | out
        keep = s["done"] | done_hit | out
        return dict(
            cell=jnp.where(keep[:, None], cell, new_cell),
            tmax=jnp.where(keep[:, None], tmax, new_tmax),
            best_t=best_t, best_tri=best_tri, found=found, done=done,
            steps=s["steps"] + 1,
        )

    s = jax.lax.while_loop(cond, body, state)
    hit = s["found"]
    t = jnp.where(hit, s["best_t"], big)
    return t, s["best_tri"], hit


def grid_line_of_sight(start, end, grid: RayGrid, soup: TriangleSoup,
                       exclude_triangle=None):
    """(R,) bool: segment start→end unobstructed (DDA closest-hit based)."""
    seg = end - start
    dist = jnp.linalg.norm(seg, axis=-1)
    direction = seg / jnp.maximum(dist[:, None], 1e-20)
    t, _, any_hit = grid_intersection(start, direction, grid, soup,
                                      exclude_triangle=exclude_triangle)
    return (~any_hit) | (t >= dist * (1.0 - 1e-4))


def auto_accel(soup: TriangleSoup):
    """Intersection backend for this scene: None (the dense (R, T)
    broadcast) for tiny scenes, the voxel DDA above ``DENSE_MAX_TRIS``.

    The dense broadcast is exact and fuses well, but its work and its
    (R, T) intermediates grow with the triangle count; the DDA visits only
    the voxels a ray crosses (reference ``cl/voxel.cpp:197-258``).
    """
    if soup.num_triangles <= DENSE_MAX_TRIS:
        return None
    return build_ray_grid(soup)
