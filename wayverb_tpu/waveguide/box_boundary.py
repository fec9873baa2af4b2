"""Region-based boundary update: boundary work as dense slice arithmetic.

Element gathers and scatters are far slower per element than a dense
streaming pass, so a compact gather-based boundary pass can dominate the
whole step.  For shoebox meshes every boundary node belongs
to one of 26 rectangular regions — 6 faces (1D nodes), 12 edges (2D), 8
corners (3D) — whose updates are expressible entirely as STATIC slices of
the pressure fields: no gathers, no scatters, just small dynamic slices.

Each region is a contiguous block of nodes sharing the same inner-direction
set and per-slot surface; the update follows exactly the same equations as
``stencil.boundary_step`` (same oracle: the naive per-node transcription).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from wayverb_tpu.waveguide.descriptor import (COURANT, COURANT_SQ,
                                              DIRECTION_OFFSETS)

_AXIS_OF_DIR = (0, 0, 1, 1, 2, 2)


@dataclasses.dataclass(frozen=True)
class Region:
    """Static description of one rectangular boundary region."""

    start: Tuple[int, int, int]     # block start (x, y, z)
    size: Tuple[int, int, int]      # block extent
    inner_dirs: Tuple[int, ...]     # port indices toward the room
    slot_coefs: Tuple[int, ...]     # surface index per inner slot

    @property
    def surrounding_dirs(self) -> Tuple[int, ...]:
        inner_axes = {_AXIS_OF_DIR[d] for d in self.inner_dirs}
        return tuple(d for d in range(6)
                     if d not in self.inner_dirs
                     and _AXIS_OF_DIR[d] not in inner_axes)

    def state_shape(self, order: int) -> Tuple[int, ...]:
        return self.size + (len(self.inner_dirs), order)


def _block(field, start, size, offset=(0, 0, 0)):
    s = tuple(slice(st + o, st + o + sz)
              for st, o, sz in zip(start, offset, size))
    return field[s]


def region_step(cur, prev, state, region: Region, coef_b, coef_a):
    """Update one region.  Returns (new_pressures (block), new_state)."""
    total = jnp.zeros(region.size, dtype=cur.dtype)
    for d in region.inner_dirs:
        total = total + 2.0 * _block(cur, region.start, region.size,
                                     tuple(DIRECTION_OFFSETS[d]))
    for d in region.surrounding_dirs:
        total = total + _block(cur, region.start, region.size,
                               tuple(DIRECTION_OFFSETS[d]))
    csw = COURANT_SQ * total

    bs = [coef_b[c] for c in region.slot_coefs]       # each (order+1,)
    as_ = [coef_a[c] for c in region.slot_coefs]
    m0 = state[..., 0]                                # (block, slots)
    fw = COURANT_SQ * sum(
        m0[..., s] / bs[s][0] for s in range(len(bs)))
    cw = COURANT * sum(as_[s][0] / bs[s][0] for s in range(len(bs)))

    node_prev = _block(prev, region.start, region.size)
    new_p = (csw + fw + (cw - 1.0) * node_prev) / (1.0 + cw)

    new_slots = []
    for s in range(len(bs)):
        b, a = bs[s], as_[s]
        m = state[..., s, :]                          # (block, order)
        filt_in = -((a[0] * (node_prev - new_p)) / (b[0] * COURANT)
                    + m[..., 0] / b[0])
        out = (filt_in * b[0] + m[..., 0]) / a[0]
        shifted = jnp.concatenate(
            [m[..., 1:], jnp.zeros_like(m[..., :1])], axis=-1)
        new_m = shifted + b[1:] * filt_in[..., None] \
            - a[1:] * out[..., None]
        new_slots.append(new_m)
    new_state = jnp.stack(new_slots, axis=-2)
    return new_p, new_state


def apply_regions(nxt, cur, prev, states: List[Any],
                  regions: List[Region], coef_b, coef_a):
    """Write every region's update into ``nxt``; returns (nxt, new_states)."""
    new_states = []
    for region, state in zip(regions, states):
        new_p, new_state = region_step(cur, prev, state, region,
                                       coef_b, coef_a)
        s = tuple(slice(st, st + sz)
                  for st, sz in zip(region.start, region.size))
        nxt = nxt.at[s].set(new_p)
        new_states.append(new_state)
    return nxt, new_states


def initial_region_states(regions: List[Region], order: int,
                          dtype=jnp.float32):
    return [jnp.zeros(r.state_shape(order), dtype=dtype) for r in regions]


# ---------------------------------------------------------------------------
# shoebox decomposition

def shoebox_regions(inside: np.ndarray, face_surfaces=None
                    ) -> List[Region]:
    """26 regions for a box interior.

    ``inside`` must be a solid axis-aligned box of True values.
    ``face_surfaces``: surface index per face in port order
    (nx, px, ny, py, nz, pz); default all 0.  Edge/corner slots inherit the
    surfaces of their adjacent faces (matching the reference's 2D/3D
    coefficient inheritance).
    """
    if face_surfaces is None:
        face_surfaces = [0] * 6
    idx = np.argwhere(inside)
    lo = idx.min(axis=0)        # first inside node per axis
    hi = idx.max(axis=0)        # last inside node
    # sanity: solid box
    expect = np.prod(hi - lo + 1)
    if expect != len(idx):
        raise ValueError("inside mask is not a solid box; use the general "
                         "gather-based boundary path")

    regions: List[Region] = []
    # per axis: (negative-side boundary coord, positive-side boundary coord)
    b = [(lo[a] - 1, hi[a] + 1) for a in range(3)]
    span = [(lo[a], hi[a] - lo[a] + 1) for a in range(3)]

    # inner dir pointing back into the room from a boundary at side s of
    # axis a: s=0 (low side) → positive dir of that axis
    def inner_dir(axis, side):
        return axis * 2 + (1 if side == 0 else 0)

    def face_dir(axis, side):
        """Port index naming the face (nx for low-x wall, etc.)."""
        return axis * 2 + (0 if side == 0 else 1)

    # 6 faces
    for axis in range(3):
        for side in range(2):
            start = [span[0][0], span[1][0], span[2][0]]
            size = [span[0][1], span[1][1], span[2][1]]
            start[axis] = b[axis][side]
            size[axis] = 1
            regions.append(Region(
                start=tuple(int(x) for x in start),
                size=tuple(int(x) for x in size),
                inner_dirs=(inner_dir(axis, side),),
                slot_coefs=(int(face_surfaces[face_dir(axis, side)]),)))

    # 12 edges (two axes pinned)
    for a1 in range(3):
        for a2 in range(a1 + 1, 3):
            for s1 in range(2):
                for s2 in range(2):
                    start = [span[0][0], span[1][0], span[2][0]]
                    size = [span[0][1], span[1][1], span[2][1]]
                    start[a1] = b[a1][s1]
                    size[a1] = 1
                    start[a2] = b[a2][s2]
                    size[a2] = 1
                    regions.append(Region(
                        start=tuple(int(x) for x in start),
                        size=tuple(int(x) for x in size),
                        inner_dirs=(inner_dir(a1, s1), inner_dir(a2, s2)),
                        slot_coefs=(
                            int(face_surfaces[face_dir(a1, s1)]),
                            int(face_surfaces[face_dir(a2, s2)]))))

    # 8 corners
    for s0 in range(2):
        for s1 in range(2):
            for s2 in range(2):
                start = (int(b[0][s0]), int(b[1][s1]), int(b[2][s2]))
                regions.append(Region(
                    start=start, size=(1, 1, 1),
                    inner_dirs=(inner_dir(0, s0), inner_dir(1, s1),
                                inner_dir(2, s2)),
                    slot_coefs=(int(face_surfaces[face_dir(0, s0)]),
                                int(face_surfaces[face_dir(1, s1)]),
                                int(face_surfaces[face_dir(2, s2)]))))
    return regions
