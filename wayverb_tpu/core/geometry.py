"""Batched geometric primitives: rays, triangles, boxes.

Accelerator-first design: everything is vectorized over a rays axis and a
triangles axis simultaneously (an ``(R, T)`` broadcast), so ray-scene queries
become a handful of large fused elementwise ops — no per-ray loops, no octree
pointer chasing on the hot path.  A voxel accelerator exists for the CPU-side
setup path in ``wayverb_tpu.core.voxel``.

Parity: reference ``core/geo/*`` and ``core/src/cl/geometry.cpp`` (ray/tri
intersection, mirror, inside-by-parity with fixed random ray directions),
``core/geo/tri_cube_intersection`` (voxelization overlap test).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

EPSILON = 1e-6


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TriangleSoup:
    """Scene geometry: vertex positions + per-triangle vertex/surface indices.

    ``vertices``: (V, 3) float, ``triangles``: (T, 3) int vertex indices,
    ``surfaces``: (T,) int material indices.
    """

    vertices: Any
    triangles: Any
    surfaces: Any

    def tree_flatten(self):
        return (self.vertices, self.triangles, self.surfaces), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    def corners(self):
        """(T, 3, 3): the three vertex positions of each triangle."""
        return self.vertices[self.triangles]


def triangle_normals(soup: TriangleSoup, normalize: bool = True):
    """(T, 3) per-triangle normals (right-handed winding)."""
    c = soup.corners()
    n = jnp.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
    if normalize:
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return n


def triangle_areas(soup: TriangleSoup):
    c = soup.corners()
    return 0.5 * jnp.linalg.norm(
        jnp.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]), axis=-1)


def mirror_point(point, tri_corners):
    """Reflect ``point`` (..., 3) in the plane of a triangle (..., 3, 3)."""
    v0 = tri_corners[..., 0, :]
    n = jnp.cross(tri_corners[..., 1, :] - v0, tri_corners[..., 2, :] - v0)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    d = jnp.sum(n * (point - v0), axis=-1, keepdims=True)
    return point - 2.0 * d * n


def ray_triangle_intersection(origin, direction, corners):
    """Möller–Trumbore, fully broadcast.

    origin/direction: (..., 3); corners: (..., 3, 3) broadcastable against
    them.  Returns ``(t, u, v, hit)`` where ``hit`` is a bool mask of valid
    front/back hits with ``t > EPSILON``.
    """
    v0 = corners[..., 0, :]
    e1 = corners[..., 1, :] - v0
    e2 = corners[..., 2, :] - v0
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) > EPSILON
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    # small barycentric slack: rays crossing exactly on a shared edge must
    # hit at least one of the adjacent triangles, or they leak out of
    # watertight scenes and die (visible as spurious energy decay)
    slack = 1e-4
    hit = ok & (u >= -slack) & (v >= -slack) & (u + v <= 1.0 + slack) \
        & (t > EPSILON)
    return t, u, v, hit


def scene_intersection(origin, direction, soup: TriangleSoup,
                       exclude_triangle=None):
    """Closest hit of rays (R, 3) against the whole scene.

    Returns ``(t, tri_index, hit)`` each of shape (R,).  ``exclude_triangle``
    (R,) int skips self-intersection with the launching triangle (reference
    passes ``previous_triangle`` into ``voxel_traversal``).
    """
    corners = soup.corners()  # (T, 3, 3)
    t, _, _, hit = ray_triangle_intersection(
        origin[:, None, :], direction[:, None, :], corners[None, :, :, :])
    if exclude_triangle is not None:
        tri_ids = jnp.arange(soup.num_triangles)[None, :]
        hit = hit & (tri_ids != exclude_triangle[:, None])
    big = jnp.asarray(jnp.inf, dtype=t.dtype)
    t_masked = jnp.where(hit, t, big)
    idx = jnp.argmin(t_masked, axis=-1)
    t_best = jnp.take_along_axis(t_masked, idx[:, None], axis=-1)[:, 0]
    any_hit = jnp.any(hit, axis=-1)
    return t_best, idx, any_hit


def count_intersections(origin, direction, soup: TriangleSoup):
    """(R,) number of triangles each ray passes through (t > 0)."""
    corners = soup.corners()
    _, _, _, hit = ray_triangle_intersection(
        origin[:, None, :], direction[:, None, :], corners[None, :, :, :])
    return jnp.sum(hit, axis=-1)


# Fixed direction table for the point-in-mesh parity vote.  The reference
# (``core/src/cl/voxel.cpp:156-226``) uses 32 fixed pseudo-random unit
# vectors and a majority vote over odd crossing counts; we generate our own
# deterministic table the same size.
_NUM_PARITY_RAYS = 32


def _parity_directions(dtype=jnp.float32):
    key = jax.random.PRNGKey(0x5EED)
    z = jax.random.uniform(key, (_NUM_PARITY_RAYS,), minval=-1.0, maxval=1.0)
    theta = jax.random.uniform(
        jax.random.fold_in(key, 1), (_NUM_PARITY_RAYS,),
        minval=-jnp.pi, maxval=jnp.pi)
    t = jnp.sqrt(1.0 - z * z)
    return jnp.stack(
        [t * jnp.cos(theta), z, t * jnp.sin(theta)], axis=-1).astype(dtype)


def points_inside(points, soup: TriangleSoup):
    """(P,) bool: is each point inside the (closed) mesh?

    Casts 32 fixed-direction rays per point and majority-votes on crossing
    parity — robust to rays grazing edges, matching the reference approach.
    """
    dirs = _parity_directions(points.dtype)                     # (D, 3)
    P = points.shape[0]
    origins = jnp.repeat(points, _NUM_PARITY_RAYS, axis=0)      # (P*D, 3)
    directions = jnp.tile(dirs, (P, 1))                         # (P*D, 3)
    counts = count_intersections(origins, directions, soup)
    odd = (counts % 2).reshape(P, _NUM_PARITY_RAYS)
    return jnp.sum(odd, axis=-1) * 2 > _NUM_PARITY_RAYS


def line_of_sight(start, end, soup: TriangleSoup, exclude_triangle=None):
    """(R,) bool: is the segment start→end unobstructed?

    start/end: (R, 3).  ``exclude_triangle`` skips the triangle the segment
    starts on (for visibility tests from a reflection point).
    """
    seg = end - start
    dist = jnp.linalg.norm(seg, axis=-1)
    direction = seg / jnp.maximum(dist[:, None], 1e-20)
    t, _, any_hit = scene_intersection(
        start, direction, soup, exclude_triangle=exclude_triangle)
    return (~any_hit) | (t >= dist * (1.0 - 1e-4))


def line_segment_sphere_intersection(p0, p1, centre, radius):
    """bool (...,): does segment p0→p1 pass within ``radius`` of ``centre``?"""
    d = p1 - p0
    f = p0 - centre
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(f * d, axis=-1)
    c = jnp.sum(f * f, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
    denom = jnp.where(a > 0, 2.0 * a, 1.0)
    t1 = (-b - sq) / denom
    t2 = (-b + sq) / denom
    in_range = ((t1 >= 0.0) & (t1 <= 1.0)) | ((t2 >= 0.0) & (t2 <= 1.0))
    return ok & in_range & (a > 0)


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box (host-side metadata; corners are plain tuples)."""

    min_corner: Any
    max_corner: Any

    def dimensions(self):
        return jnp.asarray(self.max_corner) - jnp.asarray(self.min_corner)

    def centre(self):
        return 0.5 * (jnp.asarray(self.max_corner)
                      + jnp.asarray(self.min_corner))

    def volume(self) -> float:
        d = self.dimensions()
        return float(d[0] * d[1] * d[2])

    def surface_area(self) -> float:
        d = self.dimensions()
        return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def scene_aabb(soup: TriangleSoup) -> Box:
    v = soup.vertices
    return Box(tuple(map(float, jnp.min(v, axis=0))),
               tuple(map(float, jnp.max(v, axis=0))))


def box_scene(box: Box, surface_index: int = 0,
              per_wall_surfaces=None) -> TriangleSoup:
    """A 12-triangle shoebox with inward-facing geometry.

    Mirrors the reference's ``geo::get_scene_data(box)`` used by all the
    shoebox validation experiments.  ``per_wall_surfaces``: optional (6,)
    material indices in wall order (x-lo, x-hi, y-lo, y-hi, z-lo, z-hi) —
    the multi-material variant (reference scenes attach a surface per
    face via the model loader).
    """
    lo = jnp.asarray(box.min_corner, dtype=jnp.float32)
    hi = jnp.asarray(box.max_corner, dtype=jnp.float32)
    # 8 corners, bit i of index = axis i at max
    corners = jnp.stack([
        jnp.where(jnp.asarray([(i >> a) & 1 for a in range(3)], bool), hi, lo)
        for i in range(8)
    ])
    quads = [
        (0, 2, 6, 4),  # -y? (z fixed) actually y faces below; windings fixed
        (1, 5, 7, 3),
        (0, 4, 5, 1),
        (2, 3, 7, 6),
        (0, 1, 3, 2),
        (4, 6, 7, 5),
    ]
    tris = []
    for (a, b, c, d) in quads:
        tris.append((a, b, c))
        tris.append((a, c, d))
    triangles = jnp.asarray(tris, dtype=jnp.int32)
    if per_wall_surfaces is not None:
        surfaces = jnp.repeat(
            jnp.asarray(per_wall_surfaces, dtype=jnp.int32), 2)
    else:
        surfaces = jnp.full((len(tris),), surface_index, dtype=jnp.int32)
    return TriangleSoup(corners, triangles, surfaces)


def tetrahedron_volume_sum(soup: TriangleSoup) -> Any:
    """Signed-volume room estimate (zhang2001; reference reverb_time.h:107)."""
    c = soup.corners()
    six_v = jnp.sum(c[:, 0] * jnp.cross(c[:, 1], c[:, 2]), axis=-1)
    return jnp.abs(jnp.sum(six_v)) / 6.0
