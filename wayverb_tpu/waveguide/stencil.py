"""The FDTD update step: dense interior stencil + compact boundary pass.

Physics (parity: reference ``waveguide/src/program.cpp``):
 * interior / reentrant:  p⁺ = (Σ₆ neighbours)/3 − p⁻        (:393-412)
 * d-dim boundary node (d = 1, 2, 3) with inner directions D (:331-388):
     csw = λ²·( Σ_{i∈D} 2·p[inner_i] + Σ_{surrounding} p[s] )
     fw  = λ²·Σ_{i∈D} m_i[0]/b0_i
     cw  = λ ·Σ_{i∈D} a0_i/b0_i
     p⁺  = (csw + fw + (cw−1)·p⁻) / (1 + cw)
   then per inner slot the ghost-point filter state advances with input
   −( a0·(p⁻ − p⁺)/(b0·λ) + m0/b0 ) through the canonical DF2T step
   (:150-174, filters.cpp), output discarded.
 * λ = 1/√3 (Courant number, :12-13); outside nodes stay at 0.

The interior term is six shifted views of a zero-padded field — XLA fuses
them into one bandwidth-bound pass; the irregular boundary work is a
compact gather → arithmetic → scatter, O(surface) not O(volume), instead of
the reference's per-node switch.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.dtypes import float0

from wayverb_tpu.waveguide.descriptor import (COURANT, COURANT_SQ,
                                              DIRECTION_OFFSETS)
from wayverb_tpu.waveguide.setup import MeshStructure


def _neighbor_sum(field):
    """Σ of the six face neighbours, zero outside the grid."""
    total = jnp.zeros_like(field)
    for axis in range(3):
        n = field.shape[axis]
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, n - 1)
        hi[axis] = slice(1, n)
        pad = [(0, 0)] * 3
        pad_lo = list(pad)
        pad_lo[axis] = (1, 0)
        pad_hi = list(pad)
        pad_hi[axis] = (0, 1)
        # neighbour at -axis: value of field[i-1]
        total = total + jnp.pad(field[tuple(lo)], pad_lo)
        # neighbour at +axis: value of field[i+1]
        total = total + jnp.pad(field[tuple(hi)], pad_hi)
    return total


def interior_step(current, previous, interior_mask):
    """Masked 7-point update (includes reentrant nodes)."""
    return (COURANT_SQ * _neighbor_sum(current) - previous) * interior_mask


# ---------------------------------------------------------------------------
# fused general-mesh step: weighted neighbour sum driven by a packed
# per-node bitfield (MeshStructure.weight_code).  One dense pass yields the
# interior update AND every boundary node's weighted neighbour sum (csw),
# replacing a (B, 6) flat gather.
#
#   out[x] = λ²·Σ_d w_d(x)·p[x+e_d] − interior(x)·p⁻[x]
#   w_d(x) = bit(d) + bit(6+d) of weight_code[x]   ∈ {0, 1, 2}
#
# Direction order d = 0..5 ↔ (−x, +x, −y, +y, −z, +z), matching
# descriptor.DIRECTION_OFFSETS.

_OPPOSITE = (1, 0, 3, 2, 5, 4)


def _weight(weight_code, d, dtype):
    return (((weight_code >> d) & 1)
            + ((weight_code >> (6 + d)) & 1)).astype(dtype)


def _shifted(field, d):
    """field[x + e_d] with zero fill beyond the grid."""
    off = DIRECTION_OFFSETS[d]
    ax = int(np.argmax(np.abs(np.asarray(off))))
    n = field.shape[ax]
    src = [slice(None)] * 3
    pad = [(0, 0)] * 3
    if int(off[ax]) == 1:
        src[ax] = slice(1, n)
        pad[ax] = (0, 1)
    else:
        src[ax] = slice(0, n - 1)
        pad[ax] = (1, 0)
    return jnp.pad(field[tuple(src)], pad)


def weighted_step_jnp(current, previous, weight_code):
    """Forward of ``weighted_step`` (plain autodiff-able expression)."""
    acc = jnp.zeros_like(current)
    for d in range(6):
        acc = acc + _weight(weight_code, d, current.dtype) * \
            _shifted(current, d)
    is_int = ((weight_code >> 12) & 1).astype(current.dtype)
    return COURANT_SQ * acc - is_int * previous


def _weighted_transpose(weight_code, g):
    """cur̄ of ``weighted_step_jnp``: shift the product w_d·ḡ the other way
    (a read at y+e_dd uses w_opp(dd) at the shifted site)."""
    acc = jnp.zeros_like(g)
    for dd in range(6):
        acc = acc + _shifted(_weight(weight_code, _OPPOSITE[dd], g.dtype) * g,
                             dd)
    return COURANT_SQ * acc


@jax.custom_vjp
def weighted_step(current, previous, weight_code):
    """Dense fused step: interior update + boundary csw in one pass.

    The hand VJP keeps only ``weight_code`` as the residual (autodiff would
    keep the six decoded weight fields)."""
    return weighted_step_jnp(current, previous, weight_code)


def _weighted_fwd(current, previous, weight_code):
    return weighted_step(current, previous, weight_code), weight_code


def _weighted_bwd(weight_code, g):
    is_int = ((weight_code >> 12) & 1).astype(g.dtype)
    return (_weighted_transpose(weight_code, g), -is_int * g,
            np.zeros(weight_code.shape, dtype=float0))


weighted_step.defvjp(_weighted_fwd, _weighted_bwd)


def _halo_weights(weight_code, dtype):
    """Weights of the −x read of local row 0 and the +x read of the last
    row: the only reads that cross a shard boundary."""
    return (_weight(weight_code[:1], 0, dtype),
            _weight(weight_code[-1:], 1, dtype))


def _weighted_sharded_jnp(current, previous, weight_code, halos):
    out = weighted_step_jnp(current, previous, weight_code)
    w0, w1 = _halo_weights(weight_code, current.dtype)
    out = out.at[:1].add(COURANT_SQ * w0 * halos[0])
    out = out.at[-1:].add(COURANT_SQ * w1 * halos[1])
    return out


@jax.custom_vjp
def weighted_step_sharded(current, previous, weight_code, halos):
    """``weighted_step`` for one x-shard of a decomposed grid.

    ``halos``: (hlo, hhi) pair of (1, Y, Z) ``current`` rows at local
    x = −1 / x = X from the neighbouring shards (zeros at the global grid
    ends).  Linear in (current, previous, halos); hand VJP emits halo
    cotangents so the shard_map ppermute transposes correctly."""
    return _weighted_sharded_jnp(current, previous, weight_code, halos)


def _weighted_sharded_fwd(current, previous, weight_code, halos):
    return weighted_step_sharded(current, previous, weight_code,
                                 halos), weight_code


def _weighted_sharded_bwd(weight_code, g):
    cur_bar, prev_bar, gcode = _weighted_bwd(weight_code, g)
    w0, w1 = _halo_weights(weight_code, g.dtype)
    ghalos = (COURANT_SQ * w0 * g[:1], COURANT_SQ * w1 * g[-1:])
    return cur_bar, prev_bar, gcode, ghalos


weighted_step_sharded.defvjp(_weighted_sharded_fwd, _weighted_sharded_bwd)


def expand_boundary_coefficients(s: MeshStructure):
    """Per-node (B, 3, order+1) coefficient tables.

    Hoist this OUT of the time loop: the (S, o+1) → (B, 3, o+1) gather is
    constant across a run, and doing it per step re-reads the tables every
    iteration.  Gradients w.r.t. ``coef_b``/``coef_a``
    still flow (the gather transposes to one scatter-add per run).
    """
    return s.coef_b[s.b_slot_coef], s.coef_a[s.b_slot_coef]


def prepare_boundary_tables(s: MeshStructure, expanded=None):
    """Per-node derived coefficient tables, hoisted OUT of the time loop.

    Everything here is constant across a run (but still a traced function
    of ``coef_b``/``coef_a`` so coefficient gradients flow); computing the
    divisions and the static ``cw`` once instead of per step removes
    most of the compact boundary pass's elementwise work.
    """
    bc, ac = expanded if expanded is not None \
        else expand_boundary_coefficients(s)                    # (B, 3, o+1)
    b0 = bc[..., 0]
    a0 = ac[..., 0]
    mask = s.b_slot_mask                                        # (B, 3)
    inv_b0m = mask / b0                                         # (B, 3)
    cw = COURANT * jnp.sum(mask * a0 / b0, axis=-1)             # (B,) static
    k_delta = a0 / (b0 * COURANT)                               # (B, 3)
    r_out = b0 / a0                                             # (B, 3)
    inv_a0 = 1.0 / a0
    return (bc, ac, inv_b0m, cw, k_delta, r_out, inv_a0, mask)


def boundary_update(csw, prev, filter_state, s: MeshStructure,
                    expanded=None, tables=None
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Boundary-node pressures + advanced filter state, given each node's
    weighted neighbour sum ``csw`` (B,) and previous pressure ``prev`` (B,).

    ``expanded``: optional precomputed ``expand_boundary_coefficients(s)``;
    ``tables``: optional precomputed ``prepare_boundary_tables`` (hoist it
    out of the scan — see there).
    Returns (new_pressures (B,), new_filter_state (B, 3, order)).
    """
    if tables is None:
        tables = prepare_boundary_tables(s, expanded)
    bc, ac, inv_b0m, cw, k_delta, r_out, inv_a0, mask = tables
    m0 = filter_state[..., 0]                                   # (B, 3)

    fw = COURANT_SQ * jnp.sum(m0 * inv_b0m, axis=-1)
    new_p = (csw + fw + (cw - 1.0) * prev) / (1.0 + cw)

    # ghost-point filter update per slot (output discarded)
    filt_in = -(k_delta * (prev - new_p)[:, None] + m0 * inv_b0m)
    out = filt_in * r_out + m0 * inv_a0                         # (B, 3)
    shifted = jnp.concatenate(
        [filter_state[..., 1:], jnp.zeros_like(filter_state[..., :1])],
        axis=-1)
    new_state = shifted + bc[..., 1:] * filt_in[..., None] \
        - ac[..., 1:] * out[..., None]
    new_state = jnp.where(mask[..., None] > 0, new_state, filter_state)
    return new_p, new_state


def boundary_step(current_flat, previous_flat, filter_state,
                  s: MeshStructure) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather-based boundary pass (the original slow path, kept as the
    oracle for ``waveguide_step``'s fused formulation)."""
    neigh = current_flat[s.b_neighbor_idx]                      # (B, 6)
    csw = COURANT_SQ * jnp.sum(neigh * s.b_neighbor_w, axis=-1)
    prev = previous_flat[s.b_node_idx]                          # (B,)
    return boundary_update(csw, prev, filter_state, s)


def waveguide_step_reference(current, previous, filter_state,
                             s: MeshStructure):
    """One full mesh update via the (B, 6) gather boundary pass.

    Kept as a parity oracle; ``waveguide_step`` below is the fast path.
    """
    nxt = interior_step(current, previous, s.interior_mask)
    flat_shape = current.shape[0] * current.shape[1] * current.shape[2]
    cur_flat = current.reshape(flat_shape)
    prev_flat = previous.reshape(flat_shape)
    bp, new_state = boundary_step(cur_flat, prev_flat, filter_state, s)
    nxt_flat = nxt.reshape(flat_shape).at[s.b_node_idx].set(bp)
    return nxt_flat.reshape(current.shape), new_state


def waveguide_step(current, previous, filter_state, s: MeshStructure,
                   expanded=None):
    """One full mesh update (fused general path).

    The dense weighted pass (``weighted_step``, driven by the packed
    ``s.weight_code`` bitfield) yields the interior update AND every
    boundary node's weighted neighbour sum in one pass; the compact pass
    then only gathers one value per boundary node, advances the impedance
    filters, and scatters the corrected pressures — the (B, 6) neighbour
    gather of ``waveguide_step_reference`` disappears (VERDICT r2 #8; the
    reference's one-kernel-per-step treatment is ``program.cpp:393-487``).

    ``b_node_idx`` comes from np.argwhere, so it is sorted and unique —
    the gather/scatter hints below let XLA skip its out-of-bounds and
    collision handling on the hot path.

    Returns (next_field, new_filter_state).
    """
    nxt, new_state, _ = waveguide_step_carried(
        current, previous, None, filter_state, s, expanded)
    return nxt, new_state


def boundary_pressures(field, s: MeshStructure):
    """(B,) pressures at the boundary nodes of a dense field."""
    n = field.shape[0] * field.shape[1] * field.shape[2]
    return field.reshape(n).at[s.b_node_idx].get(
        indices_are_sorted=True, unique_indices=True,
        mode="promise_in_bounds")


def waveguide_step_carried(current, previous, prev_b, filter_state,
                           s: MeshStructure, expanded=None, tables=None):
    """``waveguide_step`` with the boundary-node previous pressures carried
    compactly: ``prev_b`` is last step's returned ``bp`` (the values this
    step would otherwise re-gather from ``previous``), saving one sparse
    gather per step.  Pass ``prev_b=None`` to gather instead (first step /
    compatibility).

    Returns (next_field, new_filter_state, bp) — carry ``bp`` forward.
    """
    dense = weighted_step(current, previous, s.weight_code)
    flat_shape = current.shape[0] * current.shape[1] * current.shape[2]
    dense_flat = dense.reshape(flat_shape)
    csw = dense_flat.at[s.b_node_idx].get(
        indices_are_sorted=True, unique_indices=True,
        mode="promise_in_bounds")                               # (B,)
    if prev_b is None:
        prev_b = boundary_pressures(previous, s)
    bp, new_state = boundary_update(csw, prev_b, filter_state, s,
                                    expanded, tables)
    nxt_flat = dense_flat.at[s.b_node_idx].set(
        bp, indices_are_sorted=True, unique_indices=True,
        mode="promise_in_bounds")
    return nxt_flat.reshape(current.shape), new_state, bp
