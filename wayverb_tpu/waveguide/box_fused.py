"""Fused shoebox waveguide step: plane boundaries + one stencil pass.

Gather-based boundary paths dominate the step time on a shoebox, because
boundary work goes through gathers or many sequential full-field
dynamic-update-slices.  This module restructures the whole update around
two observations:

1. For a shoebox, every boundary node lies in one of SIX grid planes
   (x = ilo−1, x = ihi+1, y = …, z = …), and a node's inner direction set is
   exactly the set of planes it belongs to (faces → 1 plane, edges → 2,
   corners → 3).  Each plane's pressures, IIR ghost-point filter states and
   update equations are dense 2-D arrays — O(n²) work with **no gathers or
   scatters at all**.  Edge/corner coupling between planes is a handful of
   static row/column adds.  (Same equations as the reference
   ``src/waveguide/src/program.cpp:331-388``; oracle: ``waveguide.naive``.)

2. The interior update, the *placement* of the six boundary planes into
   the next field, and the *extraction* of the six inner planes (the next
   step's boundary inputs) are one elementwise expression over the field
   (``_jnp_forward``): per-step memory traffic |cur| + |prev| + |next| —
   the 12 B/node model used by bench.py.  On an NVIDIA GPU the field part
   runs as one Pallas kernel through Triton (``box_triton.py``): XLA's
   own fusion of this expression transposes the fields between layouts
   every step and takes about twice as long (PERF.md).  The inside mask
   comes from the box bounds plus the traced x offset in ``geom``, so one
   compiled step serves shards of a larger mesh.

The boundary-plane math stays small and differentiable w.r.t. the filter
coefficients; the stencil+splice step is linear with a hand-written VJP
(the adjoint of a masked stencil is the stencil of the masked cotangent).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from wayverb_tpu.waveguide.descriptor import COURANT, COURANT_SQ

# planes in port order: (axis, side) with side 0 = low wall, 1 = high wall.
# Plane index == face index in the (nx, px, ny, py, nz, pz) convention used
# by run.compute_mesh's face_surfaces.
PLANES: Tuple[Tuple[int, int], ...] = (
    (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))


def _other_axes(axis: int) -> Tuple[int, int]:
    return tuple(a for a in range(3) if a != axis)


@dataclasses.dataclass(frozen=True)
class BoxSpec:
    """Static shoebox mesh geometry (node-coordinate box bounds).

    ``ilo``/``ihi``: first/last INSIDE node per axis.  Boundary planes sit at
    ``ilo−1`` and ``ihi+1``.  The construction in ``descriptor.
    compute_adjusted_boundary`` guarantees at least one all-outside plane at
    each grid extreme (ilo ≥ 2, ihi ≤ dim−3), so the zero-filled shifts at
    the grid ends only ever read all-outside planes.
    """

    dims: Tuple[int, int, int]
    ilo: Tuple[int, int, int]
    ihi: Tuple[int, int, int]
    face_surface: Tuple[int, int, int, int, int, int]

    def __post_init__(self):
        for a in range(3):
            if not (1 <= self.ilo[a] - 1 and
                    self.ihi[a] + 1 <= self.dims[a] - 2):
                raise ValueError(
                    f"axis {a}: boundary planes [{self.ilo[a]-1}, "
                    f"{self.ihi[a]+1}] must leave one outside plane at each "
                    f"grid end (dims {self.dims})")
            if self.ihi[a] - self.ilo[a] < 2:
                raise ValueError("box interior too thin for the plane path")

    def plane_shape(self, plane_idx: int) -> Tuple[int, int]:
        a1, a2 = _other_axes(PLANES[plane_idx][0])
        return (self.dims[a1], self.dims[a2])

    def initial_states(self, order: int, dtype=jnp.float32):
        return tuple(jnp.zeros(self.plane_shape(p) + (order,), dtype=dtype)
                     for p in range(6))

    def geom_array(self, x_offset=0, y_offset=0, z_offset=0) -> jnp.ndarray:
        """int32 geometry vector for ``fused_step`` (offsets may be traced)."""
        return jnp.asarray(
            [x_offset, y_offset, z_offset,
             self.ilo[0], self.ihi[0], self.ilo[1], self.ihi[1],
             self.ilo[2], self.ihi[2]], dtype=jnp.int32)


def spec_from_inside(inside: np.ndarray, face_surfaces=None) -> BoxSpec:
    """Build a BoxSpec from a solid-box inside mask."""
    idx = np.argwhere(inside)
    lo = idx.min(axis=0)
    hi = idx.max(axis=0)
    if int(np.prod(hi - lo + 1)) != len(idx):
        raise ValueError("inside mask is not a solid box")
    if face_surfaces is None:
        face_surfaces = (0,) * 6
    return BoxSpec(dims=tuple(int(d) for d in inside.shape),
                   ilo=tuple(int(v) for v in lo),
                   ihi=tuple(int(v) for v in hi),
                   face_surface=tuple(int(s) for s in face_surfaces))


# ---------------------------------------------------------------------------
# boundary planes (pure JAX, differentiable)

def _take_plane(field, axis: int, coord: int):
    """2-D slice of a 3-D field at ``coord`` along ``axis``."""
    return jax.lax.index_in_dim(field, coord, axis, keepdims=False)


def _shift(arr2d, axis: int, delta: int):
    """arr[i] = arr_old[i + delta] with zero fill (delta ∈ {−1, +1})."""
    if delta == -1:
        pad = [(1, 0), (0, 0)] if axis == 0 else [(0, 0), (1, 0)]
        sl = (slice(0, -1), slice(None)) if axis == 0 \
            else (slice(None), slice(0, -1))
    else:
        pad = [(0, 1), (0, 0)] if axis == 0 else [(0, 0), (0, 1)]
        sl = (slice(1, None), slice(None)) if axis == 0 \
            else (slice(None), slice(1, None))
    return jnp.pad(arr2d[sl], pad)


def _plane_line(state0, q_axis: int, fixed_axis: int, coord: int):
    """Extract the line of plane q's m₀ at ``fixed_axis == coord``.

    ``state0``: (U, V) array of plane q (axes = _other_axes(q_axis)).
    """
    qa = _other_axes(q_axis)
    return state0[coord, :] if fixed_axis == qa[0] else state0[:, coord]


def plane_boundary_step(cur, prev, states: Sequence[Any], spec: BoxSpec,
                        face_b, face_a):
    """Boundary-plane updates, extracting plane slices from the 3-D fields.

    Test/oracle convenience wrapper around ``plane_boundary_step_planes``
    (the production scan carries the plane values instead of slicing the
    3-D field every step).
    """
    blo = tuple(spec.ilo[a] - 1 for a in range(3))
    bhi = tuple(spec.ihi[a] + 1 for a in range(3))
    cur_pl, cur_in, prev_pl = [], [], []
    for (a, side) in PLANES:
        pc = blo[a] if side == 0 else bhi[a]
        pci = pc + 1 if side == 0 else pc - 1
        cur_pl.append(_take_plane(cur, a, pc))
        cur_in.append(_take_plane(cur, a, pci))
        prev_pl.append(_take_plane(prev, a, pc))
    return plane_boundary_step_planes(tuple(cur_pl), tuple(cur_in),
                                      tuple(prev_pl), states, spec,
                                      face_b, face_a)


def stacked_plane_shape(spec: BoxSpec) -> Tuple[int, int]:
    """Uniform (Umax, Vmax) every plane pads to for the stacked update."""
    shapes = [spec.plane_shape(p) for p in range(6)]
    return (max(s[0] for s in shapes), max(s[1] for s in shapes))


def stack_planes(planes6, spec: BoxSpec, dtype=None):
    """6-tuple of (U_p, V_p[, ...]) planes → one (6, Umax, Vmax[, ...])."""
    Umax, Vmax = stacked_plane_shape(spec)

    def pad(x, p):
        U, V = spec.plane_shape(p)
        if dtype is not None:
            x = x.astype(dtype)
        widths = ((0, Umax - U), (0, Vmax - V)) + ((0, 0),) * (x.ndim - 2)
        return jnp.pad(x, widths)

    return jnp.stack([pad(planes6[p], p) for p in range(6)])


def unstack_planes(stack, spec: BoxSpec, dtype=None):
    """(6, Umax, Vmax[, ...]) → 6-tuple of true-shape planes."""
    out = []
    for p in range(6):
        U, V = spec.plane_shape(p)
        x = stack[p, :U, :V]
        out.append(x.astype(dtype) if dtype is not None else x)
    return tuple(out)


def _stacked_masks(spec: BoxSpec, Umax: int, Vmax: int):
    """Static per-plane masks for the stacked update (compile-time consts).

    act: active-region mask; w_um/up/vm/vp: neighbour weights encoding the
    2×-ghost closure at in-plane box edges (program.cpp:331-388)."""
    blo = tuple(spec.ilo[a] - 1 for a in range(3))
    bhi = tuple(spec.ihi[a] + 1 for a in range(3))
    act = np.zeros((6, Umax, Vmax), np.float32)
    w = {k: np.zeros((6, Umax, Vmax), np.float32)
         for k in ("um", "up", "vm", "vp")}
    u = np.arange(Umax)[:, None]
    v = np.arange(Vmax)[None, :]
    for pi, (a, side) in enumerate(PLANES):
        a1, a2 = _other_axes(a)
        act[pi] = ((u >= blo[a1]) & (u <= bhi[a1]) &
                   (v >= blo[a2]) & (v <= bhi[a2]))
        w["um"][pi] = np.where(u == blo[a1], 0, np.where(u == bhi[a1], 2, 1))
        w["up"][pi] = np.where(u == blo[a1], 2, np.where(u == bhi[a1], 0, 1))
        w["vm"][pi] = np.where(v == blo[a2], 0, np.where(v == bhi[a2], 2, 1))
        w["vp"][pi] = np.where(v == blo[a2], 2, np.where(v == bhi[a2], 0, 1))
    return act, w


def _shift_s(arr, axis: int, delta: int):
    """Stacked variant of _shift on (6, U, V): axis ∈ {1, 2}."""
    z = jnp.zeros_like(jax.lax.slice_in_dim(arr, 0, 1, axis=axis))
    if delta == -1:
        body = jax.lax.slice_in_dim(arr, 0, arr.shape[axis] - 1, axis=axis)
        return jnp.concatenate([z, body], axis=axis)
    body = jax.lax.slice_in_dim(arr, 1, arr.shape[axis], axis=axis)
    return jnp.concatenate([body, z], axis=axis)


def plane_boundary_step_stacked(pl_s, in_s, prev_s, st_s, spec: BoxSpec,
                                face_b, face_a):
    """All six boundary-plane updates on stacked (6, Umax, Vmax) arrays.

    One batched formulation of the per-plane math (reference
    ``program.cpp:331-388`` boundary update + ``filters.cpp`` canonical DF2T
    ghost-point advance): every elementwise op covers all six planes at
    once, the edge/corner cross-plane coupling is static one-hot masks times
    broadcast lines (no dynamic-update-slices — round 2's 24 `.at[]` ops per
    step were the dominant XLA residue), and the padded region provably
    stays zero (act = 0 there and the filter input is zero whenever
    m0 = prev = new_p = 0).

    ``face_b``/``face_a``: (6, order+1), traced (material gradients flow
    through).  Returns (pplus_s (6, Umax, Vmax), new_st_s (6, U, V, order)).
    """
    sdtype = st_s.dtype
    Umax, Vmax = pl_s.shape[1], pl_s.shape[2]
    blo = tuple(spec.ilo[a] - 1 for a in range(3))
    bhi = tuple(spec.ihi[a] + 1 for a in range(3))

    act_np, w_np = _stacked_masks(spec, Umax, Vmax)
    act = jnp.asarray(act_np, dtype=sdtype)
    w = {k: jnp.asarray(v, dtype=sdtype) for k, v in w_np.items()}

    pl_s = pl_s.astype(sdtype)
    in_s = in_s.astype(sdtype)
    prev_s = prev_s.astype(sdtype)

    csw = COURANT_SQ * (2.0 * in_s
                        + w["um"] * _shift_s(pl_s, 1, -1)
                        + w["up"] * _shift_s(pl_s, 1, +1)
                        + w["vm"] * _shift_s(pl_s, 2, -1)
                        + w["vp"] * _shift_s(pl_s, 2, +1))

    b0 = face_b[:, 0].astype(sdtype)           # (6,)
    a0 = face_a[:, 0].astype(sdtype)
    m0 = st_s[..., 0]                           # (6, Umax, Vmax)

    # per-plane fw/cw with edge/corner coupling as static masks × lines
    fw_planes, cw_planes = [], []
    u1 = np.arange(Umax)[:, None]
    v1 = np.arange(Vmax)[None, :]
    for pi, (a, side) in enumerate(PLANES):
        pc = blo[a] if side == 0 else bhi[a]
        a1, a2 = _other_axes(a)
        fw_p = m0[pi] / b0[pi]
        cw_p = jnp.broadcast_to((a0[pi] / b0[pi])[None, None],
                                (Umax, Vmax))
        for edge_axis, addr in ((a1, "row"), (a2, "col")):
            for s2 in (0, 1):
                q = PLANES.index((edge_axis, s2))
                qc = blo[edge_axis] if s2 == 0 else bhi[edge_axis]
                qa = _other_axes(edge_axis)
                raw = m0[q, pc, :] if a == qa[0] else m0[q, :, pc]
                if addr == "row":
                    mask = jnp.asarray((u1 == qc) & (v1 >= 0), dtype=sdtype)
                    tgt = Vmax
                    line = raw if raw.shape[0] == tgt else (
                        jnp.pad(raw[:tgt], (0, max(0, tgt - raw.shape[0]))))
                    line_b = line[None, :]
                else:
                    mask = jnp.asarray((v1 == qc) & (u1 >= 0), dtype=sdtype)
                    tgt = Umax
                    line = raw if raw.shape[0] == tgt else (
                        jnp.pad(raw[:tgt], (0, max(0, tgt - raw.shape[0]))))
                    line_b = line[:, None]
                fw_p = fw_p + mask * (line_b / b0[q])
                cw_p = cw_p + mask * (a0[q] / b0[q])
        fw_planes.append(fw_p)
        cw_planes.append(cw_p)
    fw = jnp.stack(fw_planes)
    cw = COURANT * jnp.stack(cw_planes)

    new_p = act * (csw + COURANT_SQ * fw + (cw - 1.0) * prev_s) / (1.0 + cw)

    # ghost-point DF2T state advance (each plane advances its own slot)
    a0b = a0[:, None, None]
    b0b = b0[:, None, None]
    delta = prev_s - new_p
    filt_in = -((a0b * delta) / (b0b * COURANT) + m0 / b0b)
    out = (filt_in * b0b + m0) / a0b
    bq = face_b[:, 1:].astype(sdtype)[:, None, None, :]
    aq = face_a[:, 1:].astype(sdtype)[:, None, None, :]
    shifted = jnp.concatenate(
        [st_s[..., 1:], jnp.zeros_like(st_s[..., :1])], axis=-1)
    new_st = shifted + bq * filt_in[..., None] - aq * out[..., None]
    return new_p, new_st


def plane_boundary_step_planes(cur_pl6, cur_in6, prev_pl6,
                               states: Sequence[Any], spec: BoxSpec,
                               face_b, face_a):
    """Tuple-API wrapper around the stacked update (oracle/tests).

    ``face_b``/``face_a``: (6, order+1) per-face impedance filter
    coefficients (traced — gradients w.r.t. materials flow through here).
    Returns (pplus: 6-tuple of (U, V) pressures, new_states: 6-tuple).

    Parity: reference ``program.cpp:331-388`` boundary update +
    ``filters.cpp`` canonical DF2T ghost-point state advance, with the 2-D /
    3-D nodes (edges/corners) expressed as membership in 2 / 3 planes.
    """
    sdtype = states[0].dtype
    out_dtype = cur_pl6[0].dtype
    pl_s = stack_planes(cur_pl6, spec, dtype=sdtype)
    in_s = stack_planes(cur_in6, spec, dtype=sdtype)
    prev_s = stack_planes(prev_pl6, spec, dtype=sdtype)
    st_s = stack_planes(states, spec)
    pplus_s, new_st_s = plane_boundary_step_stacked(
        pl_s, in_s, prev_s, st_s, spec, face_b, face_a)
    return (unstack_planes(pplus_s, spec, dtype=out_dtype),
            unstack_planes(new_st_s, spec))


# ---------------------------------------------------------------------------
# fused stencil + splice + inner-plane extraction
#
# The production step never slices the 3-D field for the boundary planes:
# the step extracts the six INNER planes (first inside layer per wall —
# next step's ``cur_in``) as outputs, and the six boundary-plane pressures
# of the next field are by construction the spliced ``pplus`` (carried
# forward).  Reads |cur| + |prev|, writes |next|: the 12 B/node model of
# bench.py.

def _inside_mask(gx, gy, gz, geom):
    return ((gx >= geom[3]) & (gx <= geom[4]) &
            (gy >= geom[5]) & (gy <= geom[6]) &
            (gz >= geom[7]) & (gz <= geom[8]))


def _jnp_forward(geom, cur, prev, planes, inj_idx=None, inj_val=None,
                 halos=None):
    """The fused step as one XLA expression (forward of ``fused_step``)."""
    from wayverb_tpu.waveguide.stencil import _neighbor_sum
    X, Y, Z = cur.shape
    gx = geom[0] + jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 0)
    gy = geom[1] + jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 1)
    gz = geom[2] + jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 2)
    if inj_idx is not None:
        oh = ((gx == inj_idx[0]) & (gy == inj_idx[1]) & (gz == inj_idx[2])
              & (inj_idx[3] > 0))
        cur = jnp.where(oh, jnp.where(inj_idx[3] == 1, inj_val[0],
                                      cur + inj_val[0]), cur)
        prev = jnp.where(oh, jnp.where(inj_idx[3] == 1, inj_val[1],
                                       prev + inj_val[1]), prev)
    ns = _neighbor_sum(cur)
    if halos is not None:
        ns = ns.at[0].add(halos[0][0]).at[-1].add(halos[1][0])
    res = jnp.where(_inside_mask(gx, gy, gz, geom),
                    COURANT_SQ * ns - prev, 0.0)
    pxlo, pxhi, pylo, pyhi, pzlo, pzhi = planes
    res = jnp.where(gy == geom[5] - 1, pylo[:, None, :], res)
    res = jnp.where(gy == geom[6] + 1, pyhi[:, None, :], res)
    res = jnp.where(gz == geom[7] - 1, pzlo[:, :, None], res)
    res = jnp.where(gz == geom[8] + 1, pzhi[:, :, None], res)
    res = jnp.where(gx == geom[3] - 1, pxlo[None, :, :], res)
    res = jnp.where(gx == geom[4] + 1, pxhi[None, :, :], res)
    return res, _inner_planes(res, geom)


def _inner_planes(res, geom):
    # inner-plane coords are GLOBAL; local array index subtracts the shard
    # offset (geom[0..2]) — y/z offsets are 0 today, but the x offset is
    # live under shard_map
    return tuple(
        jax.lax.dynamic_index_in_dim(res, geom[3 + 2 * a + s_] - geom[a], a,
                                     keepdims=False)
        for (a, s_) in PLANES)


def _triton_forward(geom, cur, prev, planes, inj_idx, inj_val, halos):
    # Under shard_map with checked varying axes the kernel's refs would
    # carry the mesh axis, which Pallas cannot trace; the sharded solvers
    # keep the XLA step
    if any(jax.typeof(a).vma for a in (geom, cur, prev, *planes, *halos)):
        return _jnp_forward(geom, cur, prev, planes, inj_idx, inj_val, halos)
    from wayverb_tpu.waveguide.box_triton import fused_field
    res = fused_field(geom, cur, prev, planes, inj_idx, inj_val, halos)
    return res, _inner_planes(res, geom)


NO_INJECT = (np.zeros(4, np.int32), np.zeros(2, np.float32))


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _fused_core(spec, geom, cur, prev, planes, inj_idx, inj_val, halos):
    # the Triton kernel where the step is compiled for an NVIDIA GPU, the
    # XLA expression everywhere else (chosen when lowering)
    return jax.lax.platform_dependent(
        geom, cur, prev, planes, inj_idx, inj_val, halos,
        cuda=_triton_forward, default=_jnp_forward)


def fused_step(spec, geom, cur, prev, planes, inj_idx=NO_INJECT[0],
               inj_val=NO_INJECT[1], halos=None):
    """(next, inner_planes) = stencil+splice+extract.

    Linear in (cur, prev, planes, halos); hand-written VJP (one dense
    masked-stencil pass instead of autodiff's chain of where/pad
    transposes).  ``spec`` provides the static y/z box
    geometry; ``geom`` is the int32 vector from ``BoxSpec.geom_array``
    whose x offset may be traced (shard_map).  y/z offsets must be zero.

    ``inj_idx`` = (x, y, z, mode) with mode 0 none / 1 hard / 2 soft and
    ``inj_val`` = (value_now, value_prev) fold the point-source injection
    into the step's elementwise pass (an ``.at[].set`` on the field would
    cost a full copy).
    The VJP treats the injection VALUES as constant but zeroes the cur/prev
    cotangent at a hard-set node — differentiate through the XLA-level
    injection path (``make_box_body(kernel_inject=False)``) for gradients
    w.r.t. the source signal.

    ``halos``: optional (hlo, hhi) pair of (1, Y, Z) cur rows at local
    x = −1 / x = X for shard_map domain decomposition (zeros when omitted;
    the global mesh guarantees all-outside rows at the grid ends).
    """
    if halos is None:
        z = jnp.zeros((1,) + cur.shape[1:], cur.dtype)
        halos = (z, z)
    return _fused_core(spec, geom, cur, prev, planes, inj_idx, inj_val,
                       halos)


def _fused_fwd(spec, geom, cur, prev, planes, inj_idx, inj_val, halos):
    return _fused_core(spec, geom, cur, prev, planes, inj_idx, inj_val,
                       halos), (geom, inj_idx)


def _fused_bwd(spec, res, cot):
    geom, inj_idx = res
    g, ginner = cot
    from wayverb_tpu.waveguide.stencil import _neighbor_sum
    X, Y, Z = g.shape
    gx = geom[0] + jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 0)
    gy = geom[1] + jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 1)
    gz = geom[2] + jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 2)
    G = g
    G = G + jnp.where(gx == geom[3], ginner[0][None, :, :], 0.0)
    G = G + jnp.where(gx == geom[4], ginner[1][None, :, :], 0.0)
    G = G + jnp.where(gy == geom[5], ginner[2][:, None, :], 0.0)
    G = G + jnp.where(gy == geom[6], ginner[3][:, None, :], 0.0)
    G = G + jnp.where(gz == geom[7], ginner[4][:, :, None], 0.0)
    G = G + jnp.where(gz == geom[8], ginner[5][:, :, None], 0.0)
    Gtot = G
    G = jnp.where(_inside_mask(gx, gy, gz, geom), G, 0.0)
    gcur = COURANT_SQ * _neighbor_sum(G)
    gprev = -G
    ghalos = (COURANT_SQ * G[0:1], COURANT_SQ * G[-1:])

    blo = (geom[3] - 1, geom[5] - 1, geom[7] - 1)
    bhi = (geom[4] + 1, geom[6] + 1, geom[8] + 1)

    def plane_grad(axis, coord, kill):
        # localize; planes whose coordinate lies outside this shard get
        # ZERO cotangent (dynamic_index clamps, so without the mask a
        # non-owner shard would emit garbage — the sharded-grad bug)
        c = coord - geom[axis]
        valid = (c >= 0) & (c < Gtot.shape[axis])
        sl = jax.lax.dynamic_index_in_dim(Gtot, c, axis,
                                          keepdims=False)
        U, V = sl.shape
        iu = jax.lax.broadcasted_iota(jnp.int32, (U, V), 0)
        iv = jax.lax.broadcasted_iota(jnp.int32, (U, V), 1)
        keep = jnp.full((U, V), True) & valid
        for k_axis, k_coord in kill:
            it = iu if k_axis == 0 else iv
            keep = keep & (it != k_coord)
        return jnp.where(keep, sl, 0.0)

    # kill coords on the slice's x axis are localized (x offset under
    # shard_map); y/z offsets are always 0
    xlo_l, xhi_l = blo[0] - geom[0], bhi[0] - geom[0]
    gplanes = (
        plane_grad(0, blo[0], ()),
        plane_grad(0, bhi[0], ()),
        plane_grad(1, blo[1], ((0, xlo_l), (0, xhi_l),
                               (1, blo[2]), (1, bhi[2]))),
        plane_grad(1, bhi[1], ((0, xlo_l), (0, xhi_l),
                               (1, blo[2]), (1, bhi[2]))),
        plane_grad(2, blo[2], ((0, xlo_l), (0, xhi_l))),
        plane_grad(2, bhi[2], ((0, xlo_l), (0, xhi_l))),
    )
    # a hard-set (mode 1) injection overwrites cur/prev at the source node,
    # so no cotangent flows through the pre-injection values there (ADVICE
    # r2: without this, HardSource gradients through the default box path
    # leak through the clamped node).  Soft (mode 2) adds — pass-through.
    sx = inj_idx[0] - geom[0]
    keep = jnp.where(inj_idx[3] == 1, 0.0, 1.0).astype(gcur.dtype)
    gcur = gcur.at[sx, inj_idx[1], inj_idx[2]].mul(keep)
    gprev = gprev.at[sx, inj_idx[1], inj_idx[2]].mul(keep)
    ggeom = np.zeros(geom.shape, dtype=jax.dtypes.float0)
    ginj_idx = np.zeros(4, dtype=jax.dtypes.float0)
    ginj_val = jnp.zeros(2, dtype=jnp.float32)
    return ggeom, gcur, gprev, gplanes, ginj_idx, ginj_val, ghalos


_fused_core.defvjp(_fused_fwd, _fused_bwd)


# ---------------------------------------------------------------------------
# scan-body machinery shared by run.run_waveguide_box and checkpoint

class _InjectedView:
    """Read-only view of the flat field with the pending fused injection
    applied to every read.

    In kernel-inject mode the field array the receiver taps is
    PRE-injection (the fused step applies the source while computing the
    next field), so taps at the source node would diverge from the XLA-inject /
    gather / region paths.  Receivers only read via ``field[idx]``; routing
    those reads through ``source.patch_tap`` restores post-injection
    semantics for any node set (ADVICE r2).
    """

    def __init__(self, field_flat, source, t):
        self._field = field_flat
        self._source = source
        self._t = t

    def __getitem__(self, idx):
        return self._source.patch_tap(idx, self._field[idx], self._t)


def initial_box_boundary(spec: BoxSpec, order: int, dtype=jnp.float32,
                         state_dtype=None):
    """Boundary carry: (pl_s, in6, prev_pl_s, st_s).

    ``pl_s``: stacked (6, Umax, Vmax) field values at the six boundary
    planes (== last step's pplus); ``in6``: 6-tuple of field values at the
    inner planes (kernel-extracted, true shapes); ``prev_pl_s``: previous
    field's boundary-plane values (stacked); ``st_s``: stacked
    (6, Umax, Vmax, order) IIR ghost-point state.
    """
    sdtype = state_dtype if state_dtype is not None else dtype
    Umax, Vmax = stacked_plane_shape(spec)
    zstack = jnp.zeros((6, Umax, Vmax), dtype=dtype)
    in6 = tuple(jnp.zeros(spec.plane_shape(p), dtype=dtype)
                for p in range(6))
    return (zstack, in6, zstack,
            jnp.zeros((6, Umax, Vmax, order), dtype=sdtype))


def make_box_body(structure, spec: BoxSpec, source, receiver,
                  geom=None, kernel_inject: bool = True):
    """Scan body for the fused box solver.

    carry: (cur, prev, (pl_s, in6, prev_pl_s, st_s), rstate, ok)

    ``kernel_inject``: point sources (Hard/Soft) inject INSIDE the fused
    step (an ``.at[].set`` on the field costs a full copy per step).
    The fused injection treats the injection as constant in the VJP, but the
    VJP zeroes the cur/prev cotangent at a hard-set node, so material
    gradients through the default path are exact; for gradients w.r.t. the
    source signal itself pass ``kernel_inject=False`` (the XLA injection
    differentiates w.r.t. everything).
    """
    dims = spec.dims
    num_nodes = dims[0] * dims[1] * dims[2]
    face_idx = jnp.asarray(spec.face_surface, dtype=jnp.int32)
    face_b = structure.coef_b[face_idx]
    face_a = structure.coef_a[face_idx]
    if geom is None:
        geom = spec.geom_array()
    use_kernel_inject = kernel_inject and hasattr(source,
                                                  "kernel_injection")

    def body(carry, t):
        current, previous, bcarry, rstate, ok = carry
        pl_s, in6, prev_pl_s, st_s = bcarry
        fdtype = current.dtype

        if use_kernel_inject:
            inj_idx, inj_val = source.kernel_injection(dims, t)
            tap_field = _InjectedView(current.reshape(num_nodes), source, t)
        else:
            inj_idx, inj_val = NO_INJECT
            cur_flat = source.inject(current.reshape(num_nodes), t)
            current = cur_flat.reshape(dims)
            tap_field = current.reshape(num_nodes)

        # mirror the injection onto the carried inner planes (a source at
        # an inner-layer node must be visible to the boundary update)
        in_s = stack_planes(in6, spec, dtype=fdtype)
        if hasattr(source, "patch_planes_stacked"):
            in_s = source.patch_planes_stacked(in_s, spec, dims, t)
        else:
            in6 = tuple(
                source.patch_plane(in6[pi], a,
                                   spec.ilo[a] if s == 0 else spec.ihi[a],
                                   dims, t)
                for pi, (a, s) in enumerate(PLANES))
            in_s = stack_planes(in6, spec, dtype=fdtype)
        rstate, outputs = receiver.tap(tap_field, rstate)

        pplus_s, st_s = plane_boundary_step_stacked(
            pl_s, in_s, prev_pl_s, st_s, spec, face_b, face_a)
        pplus_s = pplus_s.astype(fdtype)
        pplus = unstack_planes(pplus_s, spec)
        nxt, in6_next = fused_step(spec, geom, current, previous, pplus,
                                   inj_idx, inj_val)
        # instability in the filtered-boundary FDTD mesh manifests at the
        # boundary planes first (the interior update is marginally stable at
        # the Courant limit), so a plane-sum check is an O(n²) stand-in for
        # the reference's per-node error flag; run_waveguide_box adds a
        # full-field isfinite on the final state (an interior NaN persists)
        ok = ok & jnp.isfinite(jnp.sum(pplus_s))
        new_carry = (nxt, current, (pplus_s, in6_next, pl_s, st_s),
                     rstate, ok)
        return new_carry, outputs

    return body


def initial_box_carry(structure, spec: BoxSpec, receiver,
                      dtype=jnp.float32, state_dtype=None):
    dims = spec.dims
    return (jnp.zeros(dims, dtype=dtype), jnp.zeros(dims, dtype=dtype),
            initial_box_boundary(spec, structure.filter_order, dtype,
                                 state_dtype),
            receiver.init_state(dtype), jnp.asarray(True))
