"""Checkpoint/resume for long waveguide runs.

The reference has no simulation-state persistence (SURVEY.md §5); long
renders just rerun on failure.  Here the time loop can execute in chunks,
with the full solver state (pressure ping-pong, boundary filter state,
receiver integrator, step counter) snapshotted to an ``.npz`` between
chunks and restored bit-exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from wayverb_tpu.waveguide.run import Mesh
from wayverb_tpu.waveguide.stencil import waveguide_step


@dataclasses.dataclass
class WaveguideState:
    current: Any
    previous: Any
    boundary_state: Any     # compact fstate OR tuple of region states
    receiver_state: Any
    step: int
    stable: Any


def initial_state(mesh: Mesh, receiver, dtype=jnp.float32) -> WaveguideState:
    dims = mesh.descriptor.dimensions
    if mesh.box_spec is not None:
        from wayverb_tpu.waveguide.box_fused import initial_box_boundary
        bstate = initial_box_boundary(mesh.box_spec,
                                      mesh.structure.filter_order, dtype)
    elif mesh.regions is not None:
        from wayverb_tpu.waveguide.box_boundary import initial_region_states
        bstate = tuple(initial_region_states(
            list(mesh.regions), mesh.structure.filter_order, dtype))
    else:
        bstate = mesh.structure.initial_filter_state(dtype)
    return WaveguideState(
        current=jnp.zeros(dims, dtype=dtype),
        previous=jnp.zeros(dims, dtype=dtype),
        boundary_state=bstate,
        receiver_state=receiver.init_state(dtype),
        step=0,
        stable=jnp.asarray(True),
    )


def _chunk_fn(structure, dims, regions, box_spec, source, receiver, carry,
              offsets, kernel_inject=True):
    num_nodes = dims[0] * dims[1] * dims[2]

    if box_spec is not None:
        from wayverb_tpu.waveguide.box_fused import make_box_body
        box_body = make_box_body(structure, box_spec, source, receiver,
                                 kernel_inject=kernel_inject)
        return jax.lax.scan(box_body, carry, offsets)

    from wayverb_tpu.waveguide.stencil import expand_boundary_coefficients
    expanded = expand_boundary_coefficients(structure)

    def body(c, t):
        current, previous, bstate, rstate, ok = c
        cur_flat = source.inject(current.reshape(num_nodes), t)
        current = cur_flat.reshape(dims)
        rstate, outputs = receiver.tap(cur_flat, rstate)
        if regions is not None:
            from wayverb_tpu.waveguide.box_boundary import apply_regions
            from wayverb_tpu.waveguide.stencil import interior_step
            nxt = interior_step(current, previous,
                                structure.interior_mask)
            nxt, bstate = apply_regions(nxt, current, previous,
                                        list(bstate), list(regions),
                                        structure.coef_b, structure.coef_a)
            bstate = tuple(bstate)
        else:
            nxt, bstate = waveguide_step(current, previous, bstate,
                                         structure, expanded)
        ok = ok & jnp.all(jnp.isfinite(nxt))
        return (nxt, current, bstate, rstate, ok), outputs

    return jax.lax.scan(body, carry, offsets)


_chunk_jit = jax.jit(_chunk_fn,
                     static_argnames=("dims", "regions", "box_spec",
                                      "kernel_inject"))


def run_chunk(mesh: Mesh, source, receiver, state: WaveguideState,
              num_steps: int, kernel_inject: bool = True
              ) -> Tuple[WaveguideState, Any]:
    """Advance ``num_steps`` from ``state``; returns (new_state, outputs)."""
    carry = (state.current, state.previous, state.boundary_state,
             state.receiver_state, state.stable)
    offsets = jnp.arange(state.step, state.step + num_steps)
    regions = None
    if mesh.box_spec is None and mesh.regions is not None:
        regions = tuple(mesh.regions)
    carry, outputs = _chunk_jit(mesh.structure,
                                mesh.descriptor.dimensions, regions,
                                mesh.box_spec, source, receiver, carry,
                                offsets, kernel_inject=kernel_inject)
    current, previous, bstate, rstate, ok = carry
    return WaveguideState(current=current, previous=previous,
                          boundary_state=bstate, receiver_state=rstate,
                          step=state.step + num_steps, stable=ok), outputs


def save_state(path: str, state: WaveguideState) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(
        (state.current, state.previous, state.boundary_state,
         state.receiver_state, state.stable))
    np.savez(path, step=state.step,
             num_leaves=len(leaves),
             **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})


def load_state(path: str, mesh: Mesh, receiver,
               dtype=jnp.float32) -> WaveguideState:
    """Restore a snapshot (the mesh/receiver give the pytree structure)."""
    data = np.load(path)
    template = initial_state(mesh, receiver, dtype)
    _, treedef = jax.tree_util.tree_flatten(
        (template.current, template.previous, template.boundary_state,
         template.receiver_state, template.stable))
    leaves = [jnp.asarray(data[f"leaf_{i}"])
              for i in range(int(data["num_leaves"]))]
    current, previous, bstate, rstate, stable = \
        jax.tree_util.tree_unflatten(treedef, leaves)
    return WaveguideState(current=current, previous=previous,
                          boundary_state=bstate, receiver_state=rstate,
                          step=int(data["step"]), stable=stable)


class Cancelled(Exception):
    """Raised by run_cancellable when keep_going() goes False; carries the
    resumable state and the outputs accumulated so far."""

    def __init__(self, state: WaveguideState, outputs):
        super().__init__(f"cancelled at step {state.step}")
        self.state = state
        self.outputs = outputs


def run_cancellable(mesh: Mesh, source, receiver, num_steps: int,
                    keep_going, chunk: int = 512,
                    state: Optional[WaveguideState] = None,
                    on_progress=None, dtype=jnp.float32,
                    kernel_inject: bool = True):
    """Chunked solve with COOPERATIVE CANCELLATION between chunks — the
    reference's ``std::atomic_bool keep_going`` analogue
    (``waveguide/waveguide.h:80``, ``threaded_engine.cpp:55-57``), which a
    single fused scan cannot offer (nothing re-enters Python mid-run).

    ``keep_going``: zero-arg callable (e.g. ``threading.Event().is_set``
    inverted, or a UI flag) polled before every chunk.  On False the run
    raises :class:`Cancelled` carrying the RESUMABLE state (feed it back
    via ``state=`` to continue, or ``save_state`` it) plus the outputs
    accumulated so far — matching the reference's contract that a
    cancelled render yields no final result but stays restartable.

    ``on_progress(step, num_steps)`` fires after each chunk.
    Returns ``(state, outputs)`` with outputs concatenated over chunks.
    """
    if state is None:
        state = initial_state(mesh, receiver, dtype)
    target = state.step + num_steps
    pieces = []

    def _cat(chunks):
        if not chunks:
            return None
        return jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *chunks)

    while state.step < target:
        if not keep_going():
            raise Cancelled(state, _cat(pieces))
        n = min(chunk, target - state.step)
        state, out = run_chunk(mesh, source, receiver, state, n,
                               kernel_inject=kernel_inject)
        pieces.append(out)
        if on_progress is not None:
            on_progress(state.step, target)
    return state, _cat(pieces)
