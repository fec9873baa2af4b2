"""Multi-chip shoebox waveguide: the FUSED solver under shard_map.

Round 3 decomposed the grid along x and ran the fused step
(box_fused.fused_step) per shard with halo ppermutes — but kept the
O(n²) boundary-plane update REPLICATED, psum-ing the full (6, Umax,
Vmax) inner-plane stack every step (~1.4 MB at 224³; at a (16, 48, 128)
per-shard block the replicated plane update is ~100% extra elementwise
work per shard) — the structural limiter on weak scaling.

Round 4 shards the plane update itself:

 * the four y/z planes (whose u axis IS the grid x axis) are decomposed
   over the same x shards as the field: each shard updates only its own
   (xl, V) rows, with a one-row ppermute halo for the in-plane u shift —
   the plane subsystem now weak-scales like the field.
 * the two x planes (O(Y·Z), not x-decomposable) stay replicated; their
   inputs are one masked psum of the owner shard's step-extracted
   inner plane (2·Y·Z·4 B) plus an 8 KB psum of the cross-plane coupling
   lines at the two x-end rows.
 * per-step collective payload drops from ~1.9 MB to ~0.93 MB at 224³
   (2 field-halo rows + 2 x inner planes + 4 plane-halo rows + lines),
   and the halo ppermutes are issued BEFORE the plane math so XLA can
   overlap them with boundary compute.

Cross-plane coupling lines (program.cpp:331-388 edge/corner closure):
for an x plane, the needed y/z-plane m₀ rows live on the x-end owner
shards → psum of (4, 2, V) lines; for a y/z plane, the needed x-plane
m₀ lines are replicated (free) and the other y/z planes' m₀ columns are
row-local (free).

Sources inject locally (out-of-shard scatters dropped); receivers read
through a psum'd view, so NodeReceiver / MultiNodeReceiver /
DirectionalReceiver work unchanged.  Everything differentiates:
ppermute/psum transpose natively and fused_step's hand VJP emits halo
cotangents.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from wayverb_tpu.waveguide import sources as src_mod
from wayverb_tpu.waveguide.box_fused import (PLANES, _other_axes,
                                             fused_step)
from wayverb_tpu.waveguide.descriptor import COURANT, COURANT_SQ


class _ShardView:
    """Flat-field view over a local x block: reads at GLOBAL flat indices
    resolve via gather-where-psum, so any receiver works unchanged."""

    def __init__(self, flat_local, off, xl, dims, axis_name):
        self._flat = flat_local
        self._off = off
        self._xl = xl
        self._yz = dims[1] * dims[2]
        self._axis = axis_name

    def __getitem__(self, idx):
        idx = jnp.asarray(idx)
        xl = idx // self._yz - self._off
        ok = (xl >= 0) & (xl < self._xl)
        lidx = jnp.where(ok, xl * self._yz + idx % self._yz, 0)
        v = jnp.where(ok, self._flat[lidx], 0.0)
        return jax.lax.psum(v, self._axis)


def _inject_local(source, flat_local, t, off, xl, dims):
    """Apply a source to a local x block (global indices out of the shard
    are dropped by the scatter)."""
    yz = dims[1] * dims[2]
    size = xl * yz

    def localize(idx):
        xloc = idx // yz - off
        ok = (xloc >= 0) & (xloc < xl)
        return jnp.where(ok, xloc * yz + idx % yz, size)

    if isinstance(source, src_mod.GaussianSource):
        return flat_local.at[localize(source.node_indices)].add(
            source.weights * source.signal[t], mode="drop")
    if isinstance(source, src_mod.SoftSource):
        return flat_local.at[localize(source.node_idx)].add(
            source.signal[t], mode="drop")
    if isinstance(source, src_mod.HardSource):
        return flat_local.at[localize(source.node_idx)].set(
            source.signal[t], mode="drop")
    raise TypeError(f"unsupported sharded source {type(source)}")


def _source_nodes_values(source, t):
    """(idx (K,), val (K,), hard?) for the inner-plane patch."""
    if isinstance(source, src_mod.GaussianSource):
        return (jnp.atleast_1d(source.node_indices),
                jnp.atleast_1d(source.weights * source.signal[t]), False)
    if isinstance(source, src_mod.SoftSource):
        return (jnp.atleast_1d(source.node_idx),
                jnp.atleast_1d(source.signal[t]), False)
    if isinstance(source, src_mod.HardSource):
        return (jnp.atleast_1d(source.node_idx),
                jnp.atleast_1d(source.signal[t]), True)
    raise TypeError(f"unsupported sharded source {type(source)}")


def _patch_inner_yz(source, in_yz, spec, dims, t, off, xl):
    """Mirror the injection onto the carried y/z inner planes
    ((4, xl, Vmax) local rows).  The x inner planes need no patch — they
    are sliced from the already-injected resident field each step."""
    from wayverb_tpu.waveguide.sources import _inner_plane_targets
    idx, val, hard = _source_nodes_values(source, t)
    pis, us, vs, ons = _inner_plane_targets(idx, spec, dims)  # (6, K)
    # y/z planes: u is the GLOBAL x coordinate → localize, drop unowned
    for pi in range(2, 6):
        q = pi - 2
        u = us[pi] - off
        owned = (u >= 0) & (u < xl)
        u = jnp.where(owned, u, xl)           # dropped by mode="drop"
        v, on = vs[pi], ons[pi]
        if hard:
            old = in_yz[q, jnp.minimum(u, xl - 1), v]
            in_yz = in_yz.at[q, u, v].set(
                jnp.where(on, val.astype(in_yz.dtype), old), mode="drop")
        else:
            in_yz = in_yz.at[q, u, v].add(
                jnp.where(on & owned, val, 0.0).astype(in_yz.dtype),
                mode="drop")
    return in_yz


def _exchange_halos(cur, axis_name, n):
    """(hlo, hhi) x-neighbour slices (zeros at the grid ends)."""
    if n == 1:
        z = jnp.zeros_like(cur[:1])
        return z, z
    hlo = jax.lax.ppermute(cur[-1:], axis_name,
                           [(i, i + 1) for i in range(n - 1)])
    hhi = jax.lax.ppermute(cur[:1], axis_name,
                           [(i + 1, i) for i in range(n - 1)])
    return hlo, hhi


def _shift_u(rows, halo_lo, halo_hi, delta):
    """Shift a (xl, V) row block along u with shard halo rows."""
    if delta == -1:
        return jnp.concatenate([halo_lo, rows[:-1]], axis=0)
    return jnp.concatenate([rows[1:], halo_hi], axis=0)


def _shift_v(rows, delta):
    z = jnp.zeros_like(rows[:, :1])
    if delta == -1:
        return jnp.concatenate([z, rows[:, :-1]], axis=1)
    return jnp.concatenate([rows[:, 1:], z], axis=1)


def yz_line_contrib(spec, st_yz, off, xl):
    """This shard's contribution to the (4, 2, Vmax) m₀ lines of the four
    y/z planes at the two x-end coordinates (psum across shards gives the
    full lines; non-owner rows contribute zero)."""
    blo0, bhi0 = spec.ilo[0] - 1, spec.ihi[0] + 1

    def owned_row(q, coord):
        c = coord - off
        ok = (c >= 0) & (c < xl)
        row = jax.lax.dynamic_slice_in_dim(
            st_yz[0, q], jnp.clip(c, 0, xl - 1), 1, axis=0)[0]
        return jnp.where(ok, row, 0.0)

    return jnp.stack([jnp.stack([owned_row(q, blo0), owned_row(q, bhi0)])
                      for q in range(4)])


def _plane_rows_update(spec, pi, u, v, pl_p, s_um, s_up, in_p, prev_p,
                       st_src, st_x, lines_yz, yz_col, fb, fa):
    """One plane's update on an arbitrary row block at explicit global
    coordinates (the shared core of the full sharded plane step AND the
    post-halo edge-row recompute — one source of truth for the physics).

    ``u``/``v``: global in-plane coordinate grids (broadcastable to the
    row block); ``pl_p``/``in_p``/``prev_p``: (R, V) pressures;
    ``s_um``/``s_up``: (R, V) pre-shifted u-neighbour pressures (halo
    handling is the CALLER's); ``st_src``: (order, R, V) DF2T state;
    ``st_x``: (2, Y, Z) x-plane m₀ pair (zero off the owner shards);
    ``lines_yz``: the (4, 2, Vmax) y/z m₀ lines at the x ends (x planes
    only); ``yz_col(qi, pc) -> (R,)``: opposite-type y/z plane m₀ column
    at this plane's own coordinate.

    Same equations as box_fused.plane_boundary_step_stacked
    (program.cpp:331-388 + canonical DF2T).  Returns ``(new_p, newst)``.
    """
    X, Y, Z = spec.dims
    a, side = PLANES[pi]
    a1, a2 = _other_axes(a)
    order = st_src.shape[0]
    blo = tuple(spec.ilo[x] - 1 for x in range(3))
    bhi = tuple(spec.ihi[x] + 1 for x in range(3))
    b0 = [fb[p, 0] for p in range(6)]
    a0 = [fa[p, 0] for p in range(6)]
    Vq = {2: Z, 3: Z, 4: Y, 5: Y}
    pc = blo[a] if side == 0 else bhi[a]
    m0 = st_src[0]

    act = ((u >= blo[a1]) & (u <= bhi[a1]) &
           (v >= blo[a2]) & (v <= bhi[a2])).astype(pl_p.dtype)
    w_um = jnp.where(u == blo[a1], 0.0,
                     jnp.where(u == bhi[a1], 2.0, 1.0))
    w_up = jnp.where(u == blo[a1], 2.0,
                     jnp.where(u == bhi[a1], 0.0, 1.0))
    w_vm = jnp.where(v == blo[a2], 0.0,
                     jnp.where(v == bhi[a2], 2.0, 1.0))
    w_vp = jnp.where(v == blo[a2], 2.0,
                     jnp.where(v == bhi[a2], 0.0, 1.0))

    csw = COURANT_SQ * (2.0 * in_p
                        + w_um * s_um + w_up * s_up
                        + w_vm * _shift_v(pl_p, -1)
                        + w_vp * _shift_v(pl_p, +1))

    fw = m0 / b0[pi]
    cw = jnp.zeros_like(m0) + a0[pi] / b0[pi]
    for edge_axis, on_rows in ((a1, True), (a2, False)):
        for s2 in (0, 1):
            qi = PLANES.index((edge_axis, s2))
            qc = blo[edge_axis] if s2 == 0 else bhi[edge_axis]
            qa = _other_axes(edge_axis)
            if qi < 2:
                m0q = st_x[qi]
                raw = m0q[pc, :] if a == qa[0] else m0q[:, pc]
            elif a == 0:
                # x plane pi coupling to y/z plane qi: the m0 row at
                # x = pc lives on the owner shard — over qi's v axis
                # (== pi's matching in-plane axis)
                raw = lines_yz[qi - 2, side, :Vq[qi]]
            else:
                # y/z ↔ y/z coupling: column over local u rows
                raw = yz_col(qi, pc)
            if on_rows:
                mask = (u == qc).astype(pl_p.dtype)
                line = raw[None, :]
            else:
                mask = (v == qc).astype(pl_p.dtype)
                line = raw[:, None]
            fw = fw + mask * (line / b0[qi])
            cw = cw + mask * (a0[qi] / b0[qi])
    cw = COURANT * cw

    new_p = act * (csw + COURANT_SQ * fw + (cw - 1.0) * prev_p) \
        / (1.0 + cw)
    delta = prev_p - new_p
    filt_in = -((a0[pi] * delta) / (b0[pi] * COURANT) + m0 / b0[pi])
    out = (filt_in * b0[pi] + m0) / a0[pi]

    slots = [(st_src[j + 1] if j + 1 < order
              else jnp.zeros_like(filt_in))
             + fb[pi, j + 1] * filt_in - fa[pi, j + 1] * out
             for j in range(order)]
    return new_p, jnp.stack(slots)


def plane_step_sharded(spec, off, xl,
                       pl_x, in_x, prev_x, st_x,
                       pl_yz, in_yz, prev_yz, st_yz,
                       halo_lo, halo_hi, lines_yz, fb, fa):
    """Sharded boundary-plane update.

    x planes (axes (y,z)) replicated: ``pl_x``/``in_x``/``prev_x``
    (2, Y, Z), ``st_x`` (order, 2, Y, Z).  y/z planes (u axis = grid x)
    row-sharded: ``pl_yz``/``in_yz``/``prev_yz`` (4, xl, Vmax), ``st_yz``
    (order, 4, xl, Vmax); ``halo_lo``/``halo_hi``: (4, 1, Vmax) neighbour
    rows of ``pl_yz`` for the in-plane u shift.

    Same equations as box_fused.plane_boundary_step_stacked
    (program.cpp:331-388 + canonical DF2T), with the cross-plane coupling
    lines routed per the sharded layout: x-plane m₀ lines are replicated;
    y/z m₀ rows at the two x-end coordinates live on the x-end owner
    shards; y/z↔y/z column lines are row-local.
    """
    X, Y, Z = spec.dims
    Vmax = pl_yz.shape[-1]

    pplus_x, newst_x = [], []
    pplus_yz, newst_yz = [], []

    for pi, (a, side) in enumerate(PLANES):
        U, V = spec.plane_shape(pi)
        if pi < 2:
            pl_p, in_p, prev_p = pl_x[pi], in_x[pi], prev_x[pi]
            st_src = st_x[:, pi]
            u = jax.lax.broadcasted_iota(jnp.int32, (U, V), 0)
            v = jax.lax.broadcasted_iota(jnp.int32, (U, V), 1)
            s_um = _shift_rows_full(pl_p, -1)
            s_up = _shift_rows_full(pl_p, +1)
            yz_col = None
        else:
            q = pi - 2
            pl_p = pl_yz[q, :, :V]
            in_p = in_yz[q, :, :V]
            prev_p = prev_yz[q, :, :V]
            st_src = st_yz[:, q, :, :V]
            u = off + jax.lax.broadcasted_iota(jnp.int32, (xl, V), 0)
            v = jax.lax.broadcasted_iota(jnp.int32, (xl, V), 1)
            s_um = _shift_u(pl_p, halo_lo[q, :, :V], halo_hi[q, :, :V],
                            -1)
            s_up = _shift_u(pl_p, halo_lo[q, :, :V], halo_hi[q, :, :V],
                            +1)
            yz_col = lambda qi, pc: st_yz[0, qi - 2, :, pc]  # noqa: E731

        new_p, newst = _plane_rows_update(
            spec, pi, u, v, pl_p, s_um, s_up, in_p, prev_p, st_src,
            st_x[0], lines_yz, yz_col, fb, fa)

        if pi < 2:
            pplus_x.append(new_p)
            newst_x.append(newst)
        else:
            pplus_yz.append(jnp.pad(new_p, ((0, 0), (0, Vmax - V))))
            newst_yz.append(jnp.pad(newst, ((0, 0), (0, 0),
                                            (0, Vmax - V))))
    return (jnp.stack(pplus_x), jnp.stack(newst_x, axis=1),
            jnp.stack(pplus_yz), jnp.stack(newst_yz, axis=1))


def yz_edge_rows_fix(spec, off, xl, pl_yz, in_yz, prev_yz, st_yz, st_x0,
                     ph_lo, ph_hi, fb, fa):
    """Recompute the four y/z planes' SHARD-EDGE rows (local u = 0 and
    xl−1) with the REAL neighbour halo rows.

    The overlapped step computes the full plane block with ZERO u-halos
    so it need not wait for the exchange; only these two rows read the
    halo, and this helper redoes them through the same
    :func:`_plane_rows_update` core once the ppermute lands.  Returns
    ``(new_rows (4, 2, Vmax), newst_rows (order, 4, 2, Vmax))`` ordered
    (row 0, row xl−1).

    Requires the x-coupling masks to miss the edge rows, which holds
    whenever ``off ∈ {0, xl, 2xl, …}`` can equal neither ``blo_x`` nor
    ``bhi_x`` (checked statically by the caller via
    :func:`overlap_supported`).
    """
    Y, Z = spec.dims[1], spec.dims[2]
    Vmax = pl_yz.shape[-1]
    order = st_yz.shape[0]
    new_rows, newst_rows = [], []
    for q in range(4):
        pi = q + 2
        V = Z if pi < 4 else Y
        two = lambda arr: jnp.stack([arr[0], arr[xl - 1]])  # noqa: E731
        pl_p = two(pl_yz[q])[:, :V]
        in_p = two(in_yz[q])[:, :V]
        prev_p = two(prev_yz[q])[:, :V]
        st_src = jnp.stack([st_yz[:, q, 0, :V],
                            st_yz[:, q, xl - 1, :V]], axis=1)
        s_um = jnp.stack([ph_lo[q, 0, :V], pl_yz[q, xl - 2, :V]])
        s_up = jnp.stack([pl_yz[q, 1, :V], ph_hi[q, 0, :V]])
        u = jnp.stack([jnp.full((1,), off, jnp.int32),
                       jnp.full((1,), off + xl - 1, jnp.int32)])
        v = jax.lax.broadcasted_iota(jnp.int32, (2, V), 1)
        yz_col = lambda qi, pc, q=q: jnp.stack(  # noqa: E731
            [st_yz[0, qi - 2, 0, pc], st_yz[0, qi - 2, xl - 1, pc]])
        new_p, newst = _plane_rows_update(
            spec, pi, u, v, pl_p, s_um, s_up, in_p, prev_p, st_src,
            st_x0, None, yz_col, fb, fa)
        new_rows.append(jnp.pad(new_p, ((0, 0), (0, Vmax - V))))
        newst_rows.append(jnp.pad(newst, ((0, 0), (0, 0),
                                          (0, Vmax - V))))
    return jnp.stack(new_rows), jnp.stack(newst_rows, axis=1)


def overlap_supported(spec, xl: int) -> bool:
    """Static eligibility for the overlapped (halo-hiding) step order.

    The overlapped order computes the x planes and the field kernel
    BEFORE the exchange completes, which requires (a) the x inner/
    boundary planes to never straddle a shard boundary and (b) the
    x-plane splice/coupling rows to never be shard-edge rows — all
    decidable from the static geometry.  Standard descriptor alignment
    (ilo = 2, xl a multiple of 8) always qualifies; padded grids whose
    ihi+1 lands exactly on a shard boundary fall back to the serial
    order.
    """
    ilo0, ihi0 = spec.ilo[0], spec.ihi[0]
    blo0, bhi0 = ilo0 - 1, ihi0 + 1
    if xl < 3:
        return False
    for coord in (ilo0, blo0):
        if coord % xl == 0 and coord >= xl:      # straddle / own row 0
            return False
    for coord in (ihi0, bhi0):
        if (coord + 1) % xl == 0:                # own row xl−1
            return False
        if coord % xl == 0 and coord >= xl:      # own row 0
            return False
    return True


def _shift_rows_full(arr, delta):
    """Zero-fill row shift for the replicated (Y, Z) x planes."""
    z = jnp.zeros_like(arr[:1])
    if delta == -1:
        return jnp.concatenate([z, arr[:-1]], axis=0)
    return jnp.concatenate([arr[1:], z], axis=0)


def run_waveguide_box_sharded(device_mesh: Mesh, structure, spec, source,
                              receiver, num_steps: int,
                              dtype=jnp.float32, state_dtype=None,
                              axis_name: Optional[str] = None,
                              band_stacks=None) -> dict:
    """Sharded equivalent of run.run_waveguide_box (same outputs contract).

    ``device_mesh``: 1-D jax.sharding.Mesh; the grid x axis divides over
    it.  Requires ``spec.dims[0] % n == 0`` (``Engine`` pads x to a
    multiple of the device count).

    ``band_stacks``: optional ``(coef_b, coef_a)`` PER-BAND material
    tables, each (bands, S, order+1) — the whole solve then vmaps over
    the band axis INSIDE shard_map (SURVEY §2.6 "vmap/pmap over bands"
    under a device mesh; collectives batch natively) and the outputs
    gain a leading band dimension.
    """
    if axis_name is None:
        axis_name = device_mesh.axis_names[0]
    n = int(np.prod([device_mesh.shape[a] for a in device_mesh.axis_names]))
    dims = spec.dims
    X, Y, Z = dims
    if X % n:
        raise ValueError(f"grid x dim {X} not divisible by {n} shards")
    xl = X // n

    face_idx = jnp.asarray(spec.face_surface, dtype=jnp.int32)
    if band_stacks is not None:
        face_b = jnp.asarray(band_stacks[0])[:, face_idx]   # (bands, 6, o+1)
        face_a = jnp.asarray(band_stacks[1])[:, face_idx]
    else:
        face_b = structure.coef_b[face_idx]
        face_a = structure.coef_a[face_idx]
    sdtype = state_dtype if state_dtype is not None else dtype
    order = structure.filter_order
    Vmax = max(Y, Z)

    def shard_body(face_b, face_a, source, receiver):
        off = jax.lax.axis_index(axis_name) * xl
        geom = spec.geom_array(x_offset=off)
        # Everything in the scan carry except the receiver state is marked
        # device-VARYING (pcast to='varying'), even values that are in
        # fact replicated: a uniform vma type keeps the forward scan carry
        # stable AND makes the transposed (backward) scan's cotangent
        # carries uniform — mixed carries trip a JAX transpose limitation.
        vary = lambda x: jax.lax.pcast(x, axis_name,       # noqa: E731
                                       to="varying")
        cur0 = vary(jnp.zeros((xl, Y, Z), dtype=dtype))
        px0 = vary(jnp.zeros((2, Y, Z), dtype=dtype))
        pyz0 = vary(jnp.zeros((4, xl, Vmax), dtype=dtype))
        stx0 = vary(jnp.zeros((order, 2, Y, Z), dtype=sdtype))
        styz0 = vary(jnp.zeros((order, 4, xl, Vmax), dtype=sdtype))
        face_b = vary(face_b)
        face_a = vary(face_a)
        rstate0 = receiver.init_state(dtype)

        tap_nodes = (receiver.tap_nodes()
                     if hasattr(receiver, "tap_nodes") else None)
        yz = Y * Z

        def local_taps(cur_flat):
            """This shard's masked contribution to the receiver's tap
            pressures (psum'd with everything else in the ONE fused
            all-reduce below)."""
            idx = jnp.reshape(tap_nodes, (-1,))
            xloc = idx // yz - off
            okm = (xloc >= 0) & (xloc < xl)
            lidx = jnp.where(okm, xloc * yz + idx % yz, 0)
            return jnp.where(okm, cur_flat[lidx], 0.0)

        def exchange(cur, pl_yz):
            """ONE ppermute pair: the field edge row (post-injection)
            and the four y/z plane-halo rows ride together."""
            if n > 1:
                send_dn = jnp.concatenate(
                    [cur[-1:].reshape(1, -1),
                     pl_yz[:, -1:, :].reshape(1, -1)], axis=1)
                send_up = jnp.concatenate(
                    [cur[:1].reshape(1, -1),
                     pl_yz[:, :1, :].reshape(1, -1)], axis=1)
                got_dn = jax.lax.ppermute(
                    send_dn, axis_name,
                    [(i, i + 1) for i in range(n - 1)])
                got_up = jax.lax.ppermute(
                    send_up, axis_name,
                    [(i + 1, i) for i in range(n - 1)])
                halos = (got_dn[:, :yz].reshape(1, Y, Z),
                         got_up[:, :yz].reshape(1, Y, Z))
                ph_lo = got_dn[:, yz:].reshape(4, 1, Vmax)
                ph_hi = got_up[:, yz:].reshape(4, 1, Vmax)
                return halos, ph_lo, ph_hi
            halos = (jnp.zeros((1, Y, Z), dtype),
                     jnp.zeros((1, Y, Z), dtype))
            ph = jnp.zeros((4, 1, Vmax), dtype)
            return halos, ph, ph

        def taps_psum(cur_flat, rstate):
            # ONE psum: the receiver tap values — that is ALL.  The x
            # planes' inputs are local to the x-end owner shards: their
            # coupling lines (yz_line_contrib) live on the owner, their
            # inner-plane row comes from the local cur (or the halo row
            # just exchanged when blo0/ilo0 straddle a shard boundary),
            # and non-owner shards' x-plane state is identically zero.
            if tap_nodes is not None:
                tv = local_taps(cur_flat)
                tap_vals = jax.lax.psum(tv, axis_name)
                from wayverb_tpu.waveguide.receivers import SeqTapView
                return receiver.tap(SeqTapView(tap_vals), rstate)
            view = _ShardView(cur_flat, off, xl, dims, axis_name)
            return receiver.tap(view, rstate)

        def plane_updates(cur, pl_x, pl_yz, in_yz, prev_x, prev_yz,
                          st_x, st_yz, halos, ph_lo, ph_hi, t):
            # x inner planes from the resident rows (post-injection):
            # owned row, or the neighbour's exchanged edge row when the
            # inner plane is the first row of the next shard
            def x_row(coord, halo, halo_cond):
                c = coord - off
                owned = (c >= 0) & (c < xl)
                row = jax.lax.dynamic_slice_in_dim(
                    cur, jnp.clip(c, 0, xl - 1), 1, axis=0)[0]
                return jnp.where(owned, row,
                                 jnp.where(halo_cond, halo[0], 0.0))

            in_x = jnp.stack([
                x_row(spec.ilo[0], halos[1], spec.ilo[0] == off + xl),
                x_row(spec.ihi[0], halos[0], spec.ihi[0] == off - 1)])
            lines_yz = yz_line_contrib(spec, st_yz, off,
                                       xl).astype(dtype)
            in_yz_p = _patch_inner_yz(source, in_yz, spec, dims, t, off,
                                      xl)
            px_new, stx_new, pyz_new, styz_new = plane_step_sharded(
                spec, off, xl,
                pl_x, in_x, prev_x, st_x,
                pl_yz, in_yz_p, prev_yz, st_yz,
                ph_lo, ph_hi, lines_yz, face_b, face_a)
            return (px_new.astype(dtype), stx_new,
                    pyz_new.astype(dtype), styz_new, in_yz_p)

        pad_v = lambda a, V: jnp.pad(a, ((0, 0),            # noqa: E731
                                         (0, Vmax - V)))

        def step_serial(carry, t):
            """Round-4 order: exchange first, everything downstream of
            the halos — kept for geometries where the overlapped order's
            static preconditions fail (overlap_supported)."""
            (cur, prev, (pl_x, pl_yz, in_yz, prev_x, prev_yz,
                         st_x, st_yz), rstate, ok) = carry
            cur_flat = _inject_local(source, cur.reshape(-1), t, off, xl,
                                     dims)
            cur = cur_flat.reshape(xl, Y, Z)
            halos, ph_lo, ph_hi = exchange(cur, pl_yz)
            rstate, outputs = taps_psum(cur_flat, rstate)
            px_new, stx_new, pyz_new, styz_new, _ = plane_updates(
                cur, pl_x, pl_yz, in_yz, prev_x, prev_yz, st_x, st_yz,
                halos, ph_lo, ph_hi, t)
            local_planes = (px_new[0], px_new[1],
                            pyz_new[0, :, :Z], pyz_new[1, :, :Z],
                            pyz_new[2, :, :Y], pyz_new[3, :, :Y])
            nxt, in6_local = fused_step(spec, geom, cur, prev,
                                        local_planes, halos=halos)
            # next inner planes: y/z stay LOCAL (the x planes are read
            # straight from the resident field rows next step)
            in_yz_next = jnp.stack([
                pad_v(in6_local[2], Z), pad_v(in6_local[3], Z),
                pad_v(in6_local[4], Y), pad_v(in6_local[5], Y)])
            ok = ok & jnp.isfinite(jnp.sum(px_new)) \
                & jnp.isfinite(jnp.sum(pyz_new))
            bstate = (px_new, pyz_new, in_yz_next,
                      pl_x, pl_yz, stx_new.astype(sdtype),
                      styz_new.astype(sdtype))
            return (nxt, cur, bstate, rstate, ok), outputs

        def step_overlap(carry, t):
            """Overlapped order: the bulk field kernel and the plane
            update run with ZERO halos and no data dependence on the
            exchange, so XLA's latency-hiding scheduler can run the
            ppermute DURING the kernel; only the two shard-edge field
            rows and the two shard-edge plane rows are recomputed after
            the halos land (O(Y·Z) work).  Preconditions are checked
            statically by overlap_supported (x planes never straddle,
            x-coupling masks never hit edge rows)."""
            (cur, prev, (pl_x, pl_yz, in_yz, prev_x, prev_yz,
                         st_x, st_yz), rstate, ok) = carry
            cur_flat = _inject_local(source, cur.reshape(-1), t, off, xl,
                                     dims)
            cur = cur_flat.reshape(xl, Y, Z)

            # issue the exchange; nothing below reads it until the
            # edge-row fix-ups
            halos, ph_lo, ph_hi = exchange(cur, pl_yz)

            zero_h = (jnp.zeros((1, Y, Z), dtype),
                      jnp.zeros((1, Y, Z), dtype))
            zero_ph = jnp.zeros((4, 1, Vmax), dtype)
            px_new, stx_new, pyz_new, styz_new, in_yz_p = plane_updates(
                cur, pl_x, pl_yz, in_yz, prev_x, prev_yz, st_x, st_yz,
                zero_h, zero_ph, zero_ph, t)

            rstate, outputs = taps_psum(cur_flat, rstate)

            local_planes = (px_new[0], px_new[1],
                            pyz_new[0, :, :Z], pyz_new[1, :, :Z],
                            pyz_new[2, :, :Y], pyz_new[3, :, :Y])
            nxt, in6_local = fused_step(spec, geom, cur, prev,
                                        local_planes, halos=None)

            # ---- post-halo skin fix-ups -------------------------------
            # 1. recompute the four y/z planes' shard-edge rows with the
            #    REAL plane halos (same _plane_rows_update core)
            pyz_fix, styz_fix = yz_edge_rows_fix(
                spec, off, xl, pl_yz, in_yz_p, prev_yz, st_yz, st_x[0],
                ph_lo, ph_hi, face_b, face_a)
            pyz_fix = pyz_fix.astype(dtype)
            d_lo = pyz_fix[:, 0] - pyz_new[:, 0]          # (4, Vmax)
            d_hi = pyz_fix[:, 1] - pyz_new[:, xl - 1]

            # 2. field edge rows: the halo term of the interior stencil
            #    plus the splice-lane corrections from the fixed plane
            #    rows (splice precedence y < z; x splices never land on
            #    shard-edge rows under overlap_supported)
            iy2 = jnp.arange(Y)[:, None]
            iz2 = jnp.arange(Z)[None, :]
            ilo_, ihi_ = spec.ilo, spec.ihi
            blo_ = tuple(v - 1 for v in ilo_)
            bhi_ = tuple(v + 1 for v in ihi_)
            yz_int = ((iy2 >= ilo_[1]) & (iy2 <= ihi_[1]) &
                      (iz2 >= ilo_[2]) & (iz2 <= ihi_[2]))
            keep_z = (iz2 != blo_[2]) & (iz2 != bhi_[2])

            def row_fix(g_row, halo_row, d):
                m = ((g_row >= ilo_[0]) & (g_row <= ihi_[0]) & yz_int)
                add = jnp.where(m, COURANT_SQ * halo_row[0], 0.0)
                add = add + jnp.where((iy2 == blo_[1]) & keep_z,
                                      d[0][None, :Z], 0.0)
                add = add + jnp.where((iy2 == bhi_[1]) & keep_z,
                                      d[1][None, :Z], 0.0)
                add = add + jnp.where(iz2 == blo_[2], d[2][:Y, None],
                                      0.0)
                add = add + jnp.where(iz2 == bhi_[2], d[3][:Y, None],
                                      0.0)
                return add

            add_lo = row_fix(off, halos[0], d_lo)
            add_hi = row_fix(off + xl - 1, halos[1], d_hi)
            nxt = nxt.at[0].add(add_lo).at[xl - 1].add(add_hi)

            # 3. splice the fixed plane rows / state rows into the
            #    carried plane blocks
            pyz_new = pyz_new.at[:, 0].set(pyz_fix[:, 0]) \
                             .at[:, xl - 1].set(pyz_fix[:, 1])
            styz_new = styz_new.at[:, :, 0].set(styz_fix[:, :, 0]) \
                               .at[:, :, xl - 1].set(styz_fix[:, :, 1])

            # 4. next inner planes, with the edge-row corrections
            in_yz_next = jnp.stack([
                pad_v(in6_local[2], Z), pad_v(in6_local[3], Z),
                pad_v(in6_local[4], Y), pad_v(in6_local[5], Y)])
            edge_vals = jnp.stack([
                jnp.stack([pad_v(add_lo[ilo_[1], :][None], Z)[0],
                           pad_v(add_hi[ilo_[1], :][None], Z)[0]]),
                jnp.stack([pad_v(add_lo[ihi_[1], :][None], Z)[0],
                           pad_v(add_hi[ihi_[1], :][None], Z)[0]]),
                jnp.stack([pad_v(add_lo[:, ilo_[2]][None], Y)[0],
                           pad_v(add_hi[:, ilo_[2]][None], Y)[0]]),
                jnp.stack([pad_v(add_lo[:, ihi_[2]][None], Y)[0],
                           pad_v(add_hi[:, ihi_[2]][None], Y)[0]]),
            ])                                            # (4, 2, Vmax)
            in_yz_next = in_yz_next.at[:, 0].add(edge_vals[:, 0]) \
                                   .at[:, xl - 1].add(edge_vals[:, 1])

            ok = ok & jnp.isfinite(jnp.sum(px_new)) \
                & jnp.isfinite(jnp.sum(pyz_new))
            bstate = (px_new, pyz_new, in_yz_next,
                      pl_x, pl_yz, stx_new.astype(sdtype),
                      styz_new.astype(sdtype))
            return (nxt, cur, bstate, rstate, ok), outputs

        step = (step_overlap
                if n > 1 and overlap_supported(spec, xl) else step_serial)

        init = (cur0, cur0, (px0, pyz0, pyz0, px0, pyz0,
                             stx0, styz0), rstate0,
                vary(jnp.asarray(True)))
        carry, outputs = jax.lax.scan(step, init, jnp.arange(num_steps))
        # final full-field isfinite (see run.run_waveguide_box); one psum
        # replicates the verdict across shards
        bad = (1 - carry[4].astype(jnp.int32)) + \
            (1 - jnp.all(jnp.isfinite(carry[0])).astype(jnp.int32))
        stable = jax.lax.psum(bad, axis_name) == 0
        return outputs, stable

    if band_stacks is not None:
        body = lambda fb, fa, src, rcv: jax.vmap(             # noqa: E731
            lambda b, a: shard_body(b, a, src, rcv))(fb, fa)
    else:
        body = shard_body
    # check_vma=True is load-bearing: with it off, the transpose of the
    # per-step psum is unsound and reverse-mode silently returns garbage
    # (caught by test_gradient_through_sharded_fused)
    fn = shard_map(body, mesh=device_mesh,
                   in_specs=(P(), P(), P(), P()),
                   out_specs=(P(), P()),
                   check_vma=True)
    outputs, stable = fn(face_b, face_a, source, receiver)
    return {"outputs": outputs, "stable": stable}


def canonical_sharded(mesh, source_position, receiver_position,
                      simulation_time: float, device_mesh: Mesh,
                      environment=None, dtype=jnp.float32):
    """Sharded twin of run.canonical: calibrated impulse → directional
    receiver, on the fused solver decomposed over ``device_mesh``."""
    import math

    from wayverb_tpu.core.environment import Environment
    from wayverb_tpu.waveguide.receivers import make_directional_receiver
    from wayverb_tpu.waveguide.run import WaveguideOutput
    from wayverb_tpu.waveguide.sources import (HardSource, impulse_signal,
                                               rectilinear_calibration_factor)

    if environment is None:
        environment = Environment()
    if mesh.box_spec is None:
        raise ValueError("canonical_sharded requires a shoebox mesh "
                         "(box_spec); general meshes use parallel.sharding")
    desc = mesh.descriptor
    fs = desc.sample_rate(environment.speed_of_sound)
    num_steps = int(math.ceil(fs * simulation_time))
    src_loc = mesh.require_inside(source_position)
    rcv_loc = mesh.require_inside(receiver_position)
    amplitude = rectilinear_calibration_factor(
        desc.spacing, environment.acoustic_impedance)
    source = HardSource(
        node_idx=jnp.asarray(desc.flat_index(src_loc), dtype=jnp.int32),
        signal=impulse_signal(num_steps, amplitude))
    receiver = make_directional_receiver(
        desc, fs, environment.ambient_density, desc.position(rcv_loc))
    result = run_waveguide_box_sharded(
        device_mesh, mesh.structure, mesh.box_spec, source, receiver,
        num_steps, dtype)
    intensity, pressure = result["outputs"]
    return WaveguideOutput(pressure=pressure, intensity=intensity,
                           sample_rate=fs, stable=result["stable"])
