"""Waveguide execution: the on-device time loop and the canonical driver.

The reference's host-driven per-step kernel launches with per-step 4-byte
host round-trips (``waveguide.h:80-124``) become a single ``lax.scan`` whose
body injects the source, taps the receiver, and advances the mesh — nothing
leaves the device until the run finishes.  NaN/Inf detection folds into the
scan carry instead of an atomic error flag.

Canonical driver parity: ``waveguide/canonical.h:30-124`` (hard source with
calibrated impulse at the source node, directional receiver at the receiver
node, steps = ⌈time·fs⌉).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from wayverb_tpu.core.environment import Environment
from wayverb_tpu.core.geometry import Box, TriangleSoup, box_scene
from wayverb_tpu.waveguide import boundary as bdry
from wayverb_tpu.waveguide.descriptor import (MeshDescriptor,
                                              compute_adjusted_boundary,
                                              descriptor_for_box,
                                              grid_spacing)
from wayverb_tpu.waveguide.receivers import make_directional_receiver
from wayverb_tpu.waveguide.setup import (MeshStructure, build_structure,
                                         classify_inside_scene,
                                         classify_inside_shoebox,
                                         estimate_volume)
from wayverb_tpu.waveguide.sources import (HardSource, impulse_signal,
                                           rectilinear_calibration_factor)
from wayverb_tpu.waveguide.stencil import waveguide_step


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Descriptor + device structure + bookkeeping for one scene.

    ``box_spec``: for shoebox scenes, the static geometry driving the fused
    plane-boundary solver (box_fused.py) — the fast shoebox path.
    ``regions``: the older gather-free region decomposition, kept as a
    second oracle for the plane path (box_boundary.py).
    """

    descriptor: MeshDescriptor
    structure: MeshStructure
    inside: np.ndarray       # host copy for placement checks
    room_volume: float
    regions: Optional[list] = None
    box_spec: Optional[Any] = None

    def require_inside(self, position) -> np.ndarray:
        loc = self.descriptor.locator(position)
        in_bounds = np.all(loc >= 0) and np.all(
            loc < np.asarray(self.descriptor.dimensions))
        if not in_bounds or not bool(self.inside[tuple(loc)]):
            raise RuntimeError(
                f"position {position} does not map to an inside mesh node")
        return loc


def compute_mesh(soup: TriangleSoup, surface_absorption, spacing: float,
                 sample_rate: float, scene_box: Optional[Box] = None,
                 anchor=None, align=None) -> Mesh:
    """Build a mesh for a scene.

    ``surface_absorption``: (S, bands) per-material absorption →
    per-material order-6 impedance filters fitted at the mesh rate.
    ``scene_box`` enables the analytic shoebox inside-test fast path.
    ``align``: optional (ax, ay, az) multiples the grid dims are padded to
    (the sharded solvers need x divisible by the device count).
    """
    from wayverb_tpu.core.geometry import scene_aabb
    aabb = scene_box if scene_box is not None else scene_aabb(soup)
    if anchor is None:
        anchor = tuple(np.asarray(aabb.centre()))
    adjusted = compute_adjusted_boundary(aabb, anchor, spacing)
    desc = descriptor_for_box(adjusted, spacing, align=align)

    if scene_box is not None:
        inside = classify_inside_shoebox(desc, scene_box)
    else:
        inside = classify_inside_scene(desc, soup)

    surface_absorption = np.asarray(surface_absorption)
    coeffs = [bdry.compute_boundary_coefficients(surface_absorption[i],
                                                 sample_rate)
              for i in range(surface_absorption.shape[0])]
    coef_b, coef_a = bdry.coefficient_table(coeffs)
    structure = build_structure(desc, inside, soup, coef_b, coef_a)

    regions = None
    box_spec = None
    if scene_box is not None:
        from wayverb_tpu.waveguide.box_boundary import shoebox_regions
        from wayverb_tpu.waveguide.box_fused import spec_from_inside
        from wayverb_tpu.waveguide.setup import _closest_triangle_surface
        # surface per face from the closest triangle to each face centre
        centre = np.asarray(scene_box.centre())
        dims_m = np.asarray(scene_box.max_corner) - \
            np.asarray(scene_box.min_corner)
        face_centres = np.tile(centre, (6, 1))
        for axis in range(3):
            face_centres[2 * axis, axis] -= dims_m[axis] / 2
            face_centres[2 * axis + 1, axis] += dims_m[axis] / 2
        face_surfaces = _closest_triangle_surface(face_centres, soup)
        regions = shoebox_regions(inside, face_surfaces)
        try:
            box_spec = spec_from_inside(inside, face_surfaces)
        except ValueError:
            box_spec = None   # degenerate box: fall back to region path

    return Mesh(descriptor=desc, structure=structure, inside=inside,
                room_volume=estimate_volume(desc, inside), regions=regions,
                box_spec=box_spec)


@dataclasses.dataclass
class WaveguideOutput:
    pressure: Any          # (T,) at the output node
    intensity: Any         # (T, 3) directional intensity
    sample_rate: float
    stable: Any            # bool: no NaN/Inf during the run


def run_waveguide(structure: MeshStructure, dims, source, receiver,
                  num_steps: int, dtype=jnp.float32,
                  checkpoint_every: int = 0) -> dict:
    """Scan the mesh ``num_steps`` steps.  Jit-compatible core.

    ``source`` must expose ``inject(field_flat, t)``; ``receiver`` must
    expose ``init_state()`` and ``tap(field_flat, state)``.

    ``checkpoint_every``: when > 0, the scan nests into outer segments of
    that many steps with ``jax.checkpoint`` on each segment — reverse-mode
    memory drops from O(num_steps) pressure fields to
    O(num_steps/k + k) at the cost of one forward recompute (SURVEY §7
    hard part (b): differentiating through 10⁴–10⁵ timesteps).
    """
    from wayverb_tpu.waveguide.stencil import (boundary_pressures,
                                               expand_boundary_coefficients,
                                               prepare_boundary_tables,
                                               waveguide_step_carried)
    num_nodes = dims[0] * dims[1] * dims[2]
    current = jnp.zeros(dims, dtype=dtype)
    previous = jnp.zeros(dims, dtype=dtype)
    fstate = structure.initial_filter_state(dtype)
    rstate = receiver.init_state(dtype)
    expanded = expand_boundary_coefficients(structure)
    tables = prepare_boundary_tables(structure, expanded)

    # boundary previous-pressure carry: previous_t[b] equals last step's
    # computed boundary pressures plus the injection's effect, so sources
    # exposing ``patch_tap`` (exact compact injection mirror) skip one
    # sparse gather per step; others re-gather (always correct)
    patch_tap = getattr(source, "patch_tap", None)
    pb0 = boundary_pressures(previous, structure)
    bp0 = boundary_pressures(current, structure)

    def body(carry, t):
        current, previous, fstate, rstate, pb, bp_last, ok = carry
        cur_flat = source.inject(current.reshape(num_nodes), t)
        current = cur_flat.reshape(dims)
        rstate, outputs = receiver.tap(cur_flat, rstate)
        if patch_tap is not None:
            pb_next = patch_tap(structure.b_node_idx, bp_last, t)
            prev_b = pb
        else:
            pb_next = pb            # unused placeholder
            prev_b = None           # gather inside the step
        nxt, fstate, bp = waveguide_step_carried(
            current, previous, prev_b, fstate, structure, expanded,
            tables)
        ok = ok & jnp.all(jnp.isfinite(nxt))
        return (nxt, current, fstate, rstate, pb_next, bp, ok), outputs

    init = (current, previous, fstate, rstate, pb0, bp0,
            jnp.asarray(True))
    if checkpoint_every and num_steps > checkpoint_every:
        k = checkpoint_every
        num_segments = -(-num_steps // k)
        padded = num_segments * k

        @jax.checkpoint
        def segment(carry, t0):
            return jax.lax.scan(
                lambda c, i: body(c, t0 + i), carry, jnp.arange(k))

        carry, outputs = jax.lax.scan(
            segment, init, jnp.arange(num_segments) * k)
        outputs = jax.tree_util.tree_map(
            lambda o: o.reshape((padded,) + o.shape[2:])[:num_steps],
            outputs)
    else:
        carry, outputs = jax.lax.scan(body, init, jnp.arange(num_steps))
    return {"outputs": outputs, "stable": carry[6]}


def run_waveguide_regions(structure: MeshStructure, dims, source, receiver,
                          num_steps: int, regions, dtype=jnp.float32
                          ) -> dict:
    """Scan using the gather-free region boundary path (shoebox meshes).

    ``regions``: tuple of box_boundary.Region (static).
    """
    from wayverb_tpu.waveguide.box_boundary import (apply_regions,
                                                    initial_region_states)
    from wayverb_tpu.waveguide.stencil import interior_step

    num_nodes = dims[0] * dims[1] * dims[2]
    order = structure.filter_order
    current = jnp.zeros(dims, dtype=dtype)
    previous = jnp.zeros(dims, dtype=dtype)
    states = initial_region_states(list(regions), order, dtype)
    rstate = receiver.init_state(dtype)

    def body(carry, t):
        current, previous, states, rstate, ok = carry
        cur_flat = source.inject(current.reshape(num_nodes), t)
        current = cur_flat.reshape(dims)
        rstate, outputs = receiver.tap(cur_flat, rstate)
        nxt = interior_step(current, previous, structure.interior_mask)
        nxt, states = apply_regions(nxt, current, previous, states,
                                    list(regions), structure.coef_b,
                                    structure.coef_a)
        ok = ok & jnp.all(jnp.isfinite(nxt))
        return (nxt, current, states, rstate, ok), outputs

    (_, _, _, _, ok), outputs = jax.lax.scan(
        body, (current, previous, states, rstate, jnp.asarray(True)),
        jnp.arange(num_steps))
    return {"outputs": outputs, "stable": ok}


def run_waveguide_box(structure: MeshStructure, spec, source, receiver,
                      num_steps: int, dtype=jnp.float32,
                      state_dtype=None, checkpoint_every: int = 0,
                      kernel_inject: bool = True) -> dict:
    """Scan using the fused plane-boundary path (box_fused.py).

    The fastest solver: boundary work is one stacked plane update (pure
    JAX, differentiable) and the interior stencil + plane splice is one
    fused elementwise pass (``box_fused.fused_step``).  ``state_dtype`` optionally runs
    the IIR filter state in a wider dtype than the field (the reference
    mandates double for filter state, ``cl/filter_structs.h:14``; the plane
    state is O(n²) so f64 costs little here).  ``kernel_inject=False``
    routes point sources through the XLA injection (differentiable w.r.t.
    the source signal; the kernel path clamps signal gradients at a hard
    source but material gradients are exact either way).
    """
    from wayverb_tpu.waveguide.box_fused import (initial_box_carry,
                                                 make_box_body)
    body = make_box_body(structure, spec, source, receiver,
                         kernel_inject=kernel_inject)
    init = initial_box_carry(structure, spec, receiver, dtype, state_dtype)
    if checkpoint_every and num_steps > checkpoint_every:
        k = checkpoint_every
        num_segments = -(-num_steps // k)
        padded = num_segments * k

        @jax.checkpoint
        def segment(carry, t0):
            return jax.lax.scan(
                lambda c, i: body(c, t0 + i), carry, jnp.arange(k))

        carry, outputs = jax.lax.scan(
            segment, init, jnp.arange(num_segments) * k)
        outputs = jax.tree_util.tree_map(
            lambda o: o.reshape((padded,) + o.shape[2:])[:num_steps],
            outputs)
    else:
        # unroll=4: the scan carry rotates (next, current) each step, which
        # can cost a hidden field copy; unrolling lets consecutive steps
        # alias the ping-pong buffers
        carry, outputs = jax.lax.scan(body, init, jnp.arange(num_steps),
                                      unroll=4)
    # the per-step check covers the boundary planes only (O(n²)); a NaN
    # born in the interior persists in the field, so one final full-field
    # reduction catches it at O(n³)-once instead of per step
    stable = carry[4] & jnp.all(jnp.isfinite(carry[0]))
    return {"outputs": outputs, "stable": stable}


_run_waveguide_jit = jax.jit(
    run_waveguide,
    static_argnames=("dims", "num_steps", "dtype", "checkpoint_every"))

_run_waveguide_box_jit = jax.jit(
    run_waveguide_box,
    static_argnames=("spec", "num_steps", "dtype", "state_dtype",
                     "checkpoint_every", "kernel_inject"))

_run_waveguide_regions_jit = jax.jit(
    run_waveguide_regions,
    static_argnames=("dims", "num_steps", "regions", "dtype"))


def execute(mesh: Mesh, source, receiver, num_steps: int,
            dtype=jnp.float32, kernel_inject: bool = True) -> dict:
    """Run the mesh with the fastest applicable boundary path: the fused
    plane solver for shoeboxes, the weight-code solver otherwise."""
    if mesh.box_spec is not None:
        return _run_waveguide_box_jit(
            mesh.structure, mesh.box_spec, source, receiver, num_steps,
            dtype, kernel_inject=kernel_inject)
    if mesh.regions is not None:
        return _run_waveguide_regions_jit(
            mesh.structure, mesh.descriptor.dimensions, source, receiver,
            num_steps, tuple(mesh.regions), dtype)
    return _run_waveguide_jit(mesh.structure, mesh.descriptor.dimensions,
                              source, receiver, num_steps, dtype)


def canonical(mesh: Mesh, source_position, receiver_position,
              simulation_time: float, environment: Environment = Environment(),
              dtype=jnp.float32) -> WaveguideOutput:
    """Calibrated impulse → directional receiver output, one band."""
    desc = mesh.descriptor
    fs = desc.sample_rate(environment.speed_of_sound)
    num_steps = int(math.ceil(fs * simulation_time))
    if num_steps <= 0:
        raise ValueError(
            f"simulation_time {simulation_time} yields no steps at fs {fs}")

    src_loc = mesh.require_inside(source_position)
    rcv_loc = mesh.require_inside(receiver_position)

    amplitude = rectilinear_calibration_factor(
        desc.spacing, environment.acoustic_impedance)
    source = HardSource(
        node_idx=jnp.asarray(desc.flat_index(src_loc), dtype=jnp.int32),
        signal=impulse_signal(num_steps, amplitude))
    receiver = make_directional_receiver(
        desc, fs, environment.ambient_density, desc.position(rcv_loc))

    result = execute(mesh, source, receiver, num_steps, dtype)
    intensity, pressure = result["outputs"]
    return WaveguideOutput(pressure=pressure, intensity=intensity,
                           sample_rate=fs, stable=result["stable"])


def multiband_vmap_fits(num_bands: int, num_nodes: int, dtype,
                        budget_bytes: Optional[int] = None) -> bool:
    """Capacity guard for the vmapped multiband solve (VERDICT r4 #6:
    auto-fall-back instead of OOM).

    The batched scan keeps ~6 field-sized buffers per band live (cur,
    prev ping-pong ×2 aliasing slack, plane/filter state, the spliced
    next field); the budget defaults to the device's reported memory
    limit (or a conservative 4 GB when the backend reports none, e.g.
    host CPU).
    """
    if budget_bytes is None:
        try:
            stats = jax.devices()[0].memory_stats() or {}
            budget_bytes = int(stats.get("bytes_limit", 0)) or (4 << 30)
        except Exception:
            budget_bytes = 4 << 30
    need = num_bands * num_nodes * jnp.dtype(dtype).itemsize * 6
    return need <= 0.6 * budget_bytes


def canonical_multiband(mesh: Mesh, soup_surface_absorption, source_position,
                        receiver_position, simulation_time: float,
                        num_bands: int,
                        environment: Environment = Environment(),
                        dtype=jnp.float32, use_vmap: bool = True,
                        device_mesh=None):
    """Per-band runs with flat (frequency-independent) boundaries.

    Parity: reference ``canonical.h:141-177`` — band b uses
    ``to_flat_coefficients(absorption[:, b])`` per surface and covers the
    hrtf band-edge range [edge_b, edge_{b+1}] Hz.  Returns a list of
    ``postprocess.BandpassBand``.

    The mesh, source and receiver are band-INDEPENDENT — only
    the flat (S, order+1) coefficient tables change — so the reference's
    serial per-band reruns (``canonical.h:156-175``) become one
    ``jax.vmap`` over the stacked tables (SURVEY §2.6 "vmap/pmap over
    bands"): the whole multiband solve is a single compiled scan whose
    batch dimension fills the device.  Under a ``device_mesh`` the band
    axis vmaps INSIDE shard_map over the sharded shoebox solver
    (collectives batch natively).  ``use_vmap=False`` forces the
    sequential loop; with the default the runner AUTO-falls back when
    ``bands × field`` exceeds the device memory budget
    (``multiband_vmap_fits``) instead of OOMing.
    """
    from wayverb_tpu.signal.multiband import band_edges
    from wayverb_tpu.waveguide.postprocess import BandpassBand
    import dataclasses as dc

    absorption = np.asarray(soup_surface_absorption)   # (S, bands)
    edges = np.asarray(band_edges(absorption.shape[1]))

    if use_vmap and not multiband_vmap_fits(num_bands,
                                            mesh.descriptor.num_nodes,
                                            dtype):
        use_vmap = False

    def band_tables(b):
        coeffs = [bdry.to_flat_coefficients(float(absorption[s, b]))
                  for s in range(absorption.shape[0])]
        return bdry.coefficient_table(coeffs)

    if (device_mesh is not None and use_vmap
            and mesh.box_spec is not None):
        from wayverb_tpu.parallel.box_sharded import \
            run_waveguide_box_sharded
        tables = [band_tables(b) for b in range(num_bands)]
        cb_stack = jnp.stack([jnp.asarray(t[0]) for t in tables])
        ca_stack = jnp.stack([jnp.asarray(t[1]) for t in tables])
        desc = mesh.descriptor
        fs = desc.sample_rate(environment.speed_of_sound)
        num_steps = int(math.ceil(fs * simulation_time))
        src_loc = mesh.require_inside(source_position)
        rcv_loc = mesh.require_inside(receiver_position)
        amplitude = rectilinear_calibration_factor(
            desc.spacing, environment.acoustic_impedance)
        source = HardSource(
            node_idx=jnp.asarray(desc.flat_index(src_loc),
                                 dtype=jnp.int32),
            signal=impulse_signal(num_steps, amplitude))
        receiver = make_directional_receiver(
            desc, fs, environment.ambient_density, desc.position(rcv_loc))
        result = run_waveguide_box_sharded(
            device_mesh, mesh.structure, mesh.box_spec, source, receiver,
            num_steps, dtype, band_stacks=(cb_stack, ca_stack))
        intensities, pressures = result["outputs"]
        return [BandpassBand(
            pressure=pressures[b], intensity=intensities[b],
            sample_rate=fs,
            valid_hz=(float(edges[b]), float(edges[b + 1])))
            for b in range(num_bands)]

    if device_mesh is not None or not use_vmap:
        out = []
        for b in range(num_bands):
            coef_b, coef_a = band_tables(b)
            structure = dc.replace(mesh.structure,
                                   coef_b=jnp.asarray(coef_b),
                                   coef_a=jnp.asarray(coef_a))
            band_mesh = dc.replace(mesh, structure=structure)
            if device_mesh is not None and mesh.box_spec is not None:
                from wayverb_tpu.parallel.box_sharded import \
                    canonical_sharded
                result = canonical_sharded(
                    band_mesh, source_position, receiver_position,
                    simulation_time, device_mesh, environment, dtype)
            elif device_mesh is not None:
                from wayverb_tpu.parallel.general_sharded import \
                    canonical_general_sharded
                result = canonical_general_sharded(
                    band_mesh, source_position, receiver_position,
                    simulation_time, device_mesh, environment, dtype)
            else:
                result = canonical(band_mesh, source_position,
                                   receiver_position, simulation_time,
                                   environment, dtype)
            out.append(BandpassBand(
                pressure=result.pressure, intensity=result.intensity,
                sample_rate=result.sample_rate,
                valid_hz=(float(edges[b]), float(edges[b + 1]))))
        return out

    tables = [band_tables(b) for b in range(num_bands)]
    cb_stack = jnp.stack([jnp.asarray(t[0]) for t in tables])
    ca_stack = jnp.stack([jnp.asarray(t[1]) for t in tables])

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

    def run_band(coef_b, coef_a):
        import dataclasses as dc2
        structure = dc2.replace(mesh.structure, coef_b=coef_b,
                                coef_a=coef_a)
        if mesh.box_spec is not None:
            res = run_waveguide_box(structure, mesh.box_spec, source,
                                    receiver, num_steps, dtype)
        elif mesh.regions is not None:
            res = run_waveguide_regions(structure, desc.dimensions,
                                        source, receiver, num_steps,
                                        tuple(mesh.regions), dtype)
        else:
            res = run_waveguide(structure, desc.dimensions, source,
                                receiver, num_steps, dtype)
        intensity, pressure = res["outputs"]
        return pressure, intensity, res["stable"]

    run_all = jax.jit(jax.vmap(run_band))
    pressures, intensities, stables = run_all(cb_stack, ca_stack)
    return [BandpassBand(
        pressure=pressures[b], intensity=intensities[b], sample_rate=fs,
        valid_hz=(float(edges[b]), float(edges[b + 1])))
        for b in range(num_bands)]


def shoebox_mesh(box: Box, absorption, spacing: float, sample_rate: float,
                 anchor=None) -> Mesh:
    """Mesh for a rectangular room with one material on all walls."""
    soup = box_scene(box)
    absorption = np.atleast_2d(np.asarray(absorption))
    return compute_mesh(soup, absorption, spacing, sample_rate,
                        scene_box=box, anchor=anchor)
