#!/usr/bin/env python
"""Bring-up check of the renderer on NVIDIA GPUs, through the normal entry
points, at the sizes users run.

    python chip_smoke.py                # phases 1-4 on one card
    python chip_smoke.py --four-cards   # the sharded solvers on four cards

Phases (one process, one card):

1. box     — the 224×224×256 shoebox through ``run.canonical`` →
             ``run.execute`` for 1,024 steps: stable, first arrival at
             distance/c, and the first 64 receiver samples against the
             general weight-code path on the card and the box path on the
             CPU backend.
2. grad    — ``jax.grad`` w.r.t. ``coef_b`` through the checkpointed box
             scan at full width (256 steps): finite and non-zero; at
             64×64×128 against the CPU backend; the top coefficient
             against a central finite difference.
3. hall    — ``combined.complete.run_project`` on the procedural concert
             hall at the ``Project`` defaults (2¹⁶ rays, image-source order
             4, 500 Hz, usable portion 0.6) with an omni capsule and an
             HRTF pair: finite IR, direct arrival within one sample of
             distance/c, T30 against Eyring, and the waveguide band
             against the CPU backend.
4. rays    — ``tracer.trace`` on the ≈97k-triangle hall, 2¹⁶ rays × 40
             bounces through ``accel.auto_accel``: energy deposited, and a
             4,096-ray subset against the dense ``scene_intersection``.

``--four-cards`` runs only the sharded paths and their single-card twins:
the box through ``parallel.box_sharded``, the hall through
``parallel.general_sharded``, and ``parallel.sharding.sharded_trace``.

Every result line names the card.  The last line of standard output is the
JSON object ``{"ok": true, "device": {...}}``; any failed phase prints its
traceback and the script exits non-zero without that line.  It refuses to
run (non-zero, nothing printed on stdout) when JAX's first device is not a
GPU, or when the ``wayverb_tpu`` package beside this file is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SINGLE_PHASES = ("box", "grad", "hall", "rays")
FOUR_CARD_PHASES = ("sharded",)

BOX_SIDE = (224, 224, 256)
BOX_STEPS = 1024
COMPARE_STEPS = 64
GRAD_SIDE_SMALL = (64, 64, 128)
GRAD_STEPS = 256
HALL_SOURCE = (2.0, 1.7, 3.0)
# (6.0, 1.9, 9.0), the ray benchmark's receiver, is occluded from the
# source by the hall's first column, so it has no direct sound; 1 m along x
# the path clears that column by 0.7 m
HALL_RECEIVER = (7.0, 1.9, 9.0)
RAYS = 1 << 16
RAY_DEPTH = 40
RAY_SUBSET = 4096

# Tolerances, each with its reason.
# f32 elementwise solvers with no matmul: only FMA contraction and the
# order of the 6-neighbour sum differ between paths and backends.
WAVE_REL = 1e-5
# Gradient sums over 128 steps of plane cotangents (scatter-adds whose
# order differs on the GPU) against the CPU backend.
GRAD_REL = 1e-4
# f32 gradient against a float64 central difference with eps = 3e-4·|c|:
# f32 accumulation over the run plus O(eps²) curvature.
FD_REL = 1e-3
# Broadband Schroeder T30 of the hall against Eyring: Eyring assumes a
# diffuse field, the hall is a tessellated box with columns, and the tail
# is a finite-ray estimate.
T30_REL = 0.10
# Histogram totals from the voxel DDA and the dense broadcast: identical
# bounce sequences except rays that graze a triangle edge within the
# barycentric slack, where the two paths may pick different triangles.
RAY_TOTAL_REL = 2e-3


def phases_for(four_cards: bool) -> tuple:
    return FOUR_CARD_PHASES if four_cards else SINGLE_PHASES


def final_line(devices) -> str:
    """The contract's last line, from what JAX reports."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def max_rel(a, b) -> float:
    """max |a − b| / max |b| (0 when both are all zero)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = np.max(np.abs(b))
    diff = np.max(np.abs(a - b))
    return float(diff / scale) if scale > 0 else float(diff)


def first_arrival(p, threshold: float = 0.05) -> int:
    """First sample whose magnitude exceeds ``threshold`` of the peak."""
    p = np.abs(np.asarray(p))
    return int(np.argmax(p > threshold * p.max()))


def direct_peak(ir, sample_rate: float, expected: float, f_lo: float,
                after: int = 20) -> int:
    """Index of the direct sound in a rendered IR.

    The IR is high-passed above ``f_lo`` (zero phase, so peaks stay put):
    the waveguide's low band has its own grid-snapped, dispersive arrival,
    while the image-source direct path is a band-limited impulse at exactly
    distance/c.  The direct sound is then the largest magnitude before
    ``expected + after`` samples, since every reflection path is longer.
    """
    ir = np.asarray(ir, dtype=np.float64)
    spec = np.fft.rfft(ir)
    spec[np.fft.rfftfreq(ir.size, 1.0 / sample_rate) < f_lo] = 0.0
    high = np.fft.irfft(spec, ir.size)
    stop = int(math.floor(expected)) + after + 1
    return int(np.argmax(np.abs(high[:stop])))


def import_package():
    """Import ``wayverb_tpu`` from beside this file, never from elsewhere."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import wayverb_tpu
    where = os.path.dirname(os.path.abspath(wayverb_tpu.__file__))
    if os.path.dirname(where) != HERE:
        raise ImportError(f"wayverb_tpu found at {where}, not beside "
                          f"{os.path.basename(__file__)}")
    return wayverb_tpu


# ---------------------------------------------------------------------------
# shared setup

def box_mesh(side, absorption=0.1):
    from wayverb_tpu.core.environment import Environment
    from wayverb_tpu.core.geometry import Box
    from wayverb_tpu.waveguide import run as wgrun
    from wayverb_tpu.waveguide.descriptor import grid_spacing
    fs = 3333.33
    dx = grid_spacing(Environment().speed_of_sound, 1.0 / fs)
    box = Box((0.0, 0.0, 0.0), tuple(dx * (s - 4) for s in side))
    return box, wgrun.shoebox_mesh(box, np.full((1, 8), absorption), dx, fs)


def on_cpu(tree):
    import jax
    return jax.device_put(tree, jax.devices("cpu")[0])


def steps_time(desc, steps: int) -> float:
    """A simulation time that ``run.canonical`` turns into ``steps``."""
    from wayverb_tpu.core.environment import Environment
    return (steps - 0.5) / desc.sample_rate(Environment().speed_of_sound)


def canonical_on(mesh, src, rcv, steps, cpu: bool):
    import jax
    from wayverb_tpu.waveguide import run as wgrun
    if not cpu:
        out = wgrun.canonical(mesh, src, rcv, steps_time(mesh.descriptor,
                                                         steps))
        return np.asarray(out.pressure), np.asarray(out.intensity), out
    mesh = dataclasses.replace(mesh, structure=on_cpu(mesh.structure))
    with jax.default_device(jax.devices("cpu")[0]):
        out = wgrun.canonical(mesh, src, rcv, steps_time(mesh.descriptor,
                                                         steps))
        return np.asarray(out.pressure), np.asarray(out.intensity), out


# ---------------------------------------------------------------------------
# phases: each returns a dict of results and raises on a failed check

def phase_box(side=BOX_SIDE, steps=BOX_STEPS, compare=COMPARE_STEPS,
              rcv_nodes=15):
    from wayverb_tpu.core.environment import Environment
    box, mesh = box_mesh(side)
    desc = mesh.descriptor
    assert mesh.box_spec is not None, "shoebox did not take the box path"
    # receiver on the (1, 1, 1) diagonal, where the rectilinear scheme at
    # the Courant limit propagates without dispersion: the arrival is
    # exactly distance/c (3 steps per diagonal node)
    centre = np.asarray(box.centre())
    src = tuple(centre)
    rcv = tuple(centre + rcv_nodes * desc.spacing)
    p, inten, out = canonical_on(mesh, src, rcv, steps, cpu=False)
    assert p.shape == (steps,), p.shape
    assert bool(out.stable) and np.all(np.isfinite(p)), "box run unstable"
    d = np.linalg.norm(desc.position(desc.locator(src))
                       - desc.position(desc.locator(rcv)))
    expected = d / Environment().speed_of_sound * out.sample_rate
    first = first_arrival(p)
    assert abs(first - expected) <= 1, (first, expected)

    general = dataclasses.replace(mesh, box_spec=None, regions=None)
    gp, gi, _ = canonical_on(general, src, rcv, compare, cpu=False)
    cp, ci, _ = canonical_on(mesh, src, rcv, compare, cpu=True)
    errs = {"vs_general_pressure": max_rel(p[:compare], gp),
            "vs_general_intensity": max_rel(inten[:compare], gi),
            "vs_cpu_pressure": max_rel(p[:compare], cp),
            "vs_cpu_intensity": max_rel(inten[:compare], ci)}
    bad = {k: v for k, v in errs.items() if not v <= WAVE_REL}
    assert not bad, f"box parity beyond {WAVE_REL}: {bad}"
    return dict(dims=list(desc.dimensions), steps=steps,
                first_arrival=first, expected_arrival=float(expected),
                bound=WAVE_REL, **errs)


def grad_problem(side, steps, dtype=None, mesh=None):
    """(mesh, loss(coef_b, structure)) for the box gradient checks;
    ``dtype`` float64 runs the whole solve (field, state, loss) in f64 on
    ``mesh`` (built in f32: the shoebox classification is not re-run)."""
    import jax
    import jax.numpy as jnp
    from wayverb_tpu.waveguide import run as wgrun
    from wayverb_tpu.waveguide.receivers import NodeReceiver
    from wayverb_tpu.waveguide.sources import HardSource, impulse_signal
    if mesh is None:
        _, mesh = box_mesh(side)
    desc, spec = mesh.descriptor, mesh.box_spec
    dtype = dtype or jnp.float32
    if dtype != jnp.float32:
        mesh = dataclasses.replace(mesh, structure=jax.tree_util.tree_map(
            lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a,
            mesh.structure))
    # in a corner: three wall reflections reach the receiver within ~20
    # steps, so the loss depends strongly on the walls' filter coefficients
    src = tuple(spec.ilo[a] + 3 for a in range(3))
    rcv = (spec.ilo[0] + 3, spec.ilo[1] + 3, spec.ilo[2] + 8)
    source = HardSource(
        node_idx=jnp.asarray(desc.flat_index(src), dtype=jnp.int32),
        signal=impulse_signal(steps, 1.0).astype(dtype))
    receiver = NodeReceiver(
        node_idx=jnp.asarray(desc.flat_index(rcv), dtype=jnp.int32))

    def loss(coef_b, structure):
        structure = dataclasses.replace(structure, coef_b=coef_b)
        out = wgrun.run_waveguide_box(structure, spec, source, receiver,
                                      steps, dtype=dtype,
                                      checkpoint_every=max(1, steps // 8))
        return jnp.sum(out["outputs"] ** 2)

    return mesh, loss


def small_grad(side, steps, cpu: bool):
    """The gradient of the small problem, built and run on one backend."""
    import contextlib
    import jax
    ctx = jax.default_device(jax.devices("cpu")[0]) if cpu \
        else contextlib.nullcontext()
    with ctx:
        mesh, loss = grad_problem(side, steps)
        return np.asarray(jax.jit(jax.grad(loss))(mesh.structure.coef_b,
                                                  mesh.structure))


def phase_grad(side=BOX_SIDE, small=GRAD_SIDE_SMALL, steps=GRAD_STEPS,
               eps_rel=3e-4):
    import jax
    import jax.numpy as jnp
    mesh, loss = grad_problem(side, steps)
    cb = mesh.structure.coef_b
    g = np.asarray(jax.jit(jax.grad(loss))(cb, mesh.structure))
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0, g
    k = int(np.argmax(np.abs(g)))
    # the difference is taken in float64, so it measures the f32 gradient
    # and not the f32 loss's roundoff
    with jax.enable_x64(True):
        mesh64, loss64 = grad_problem(side, steps, jnp.float64, mesh)
        cb64 = mesh64.structure.coef_b
        eps = eps_rel * max(1.0, abs(float(np.asarray(cb64).ravel()[k])))
        e = jnp.zeros(cb64.size, cb64.dtype).at[k].set(eps).reshape(
            cb64.shape)
        f = jax.jit(loss64)
        fd = (float(f(cb64 + e, mesh64.structure))
              - float(f(cb64 - e, mesh64.structure))) / (2 * eps)
    fd_err = float(abs(fd - g.ravel()[k]) / max(abs(fd), 1e-30))
    assert fd_err <= FD_REL, (fd, g.ravel()[k])

    gs = small_grad(small, steps // 2, cpu=False)
    gc = small_grad(small, steps // 2, cpu=True)
    small_err = max_rel(gs, gc)
    assert small_err <= GRAD_REL, small_err
    return dict(dims=list(mesh.descriptor.dimensions), steps=steps,
                grad_max=float(np.abs(g).max()), top_index=k,
                top_grad=float(g.ravel()[k]), top_fd=fd, fd_rel=fd_err,
                fd_bound=FD_REL, small_dims=list(small),
                small_vs_cpu=small_err, small_bound=GRAD_REL)


def hall_project(out_dir, absorption=0.2):
    from wayverb_tpu.combined.model import (CapsuleModel, MaterialModel,
                                            OutputModel, Project,
                                            ReceiverModel, SourceModel)
    return Project(
        sources=[SourceModel(name="s", position=HALL_SOURCE)],
        receivers=[ReceiverModel(name="r", position=HALL_RECEIVER,
                                 capsules=[
                                     CapsuleModel(name="omni"),
                                     CapsuleModel(name="hrtf left",
                                                  kind="hrtf", channel=0),
                                     CapsuleModel(name="hrtf right",
                                                  kind="hrtf", channel=1)])],
        # flat absorption, so one broadband T30 has one Eyring prediction;
        # scattering 0.5 keeps the field diffuse, as Eyring assumes
        materials=[MaterialModel(name="hall", absorption=[absorption] * 8,
                                 scattering=[0.5] * 8)],
        output=OutputModel(output_directory=out_dir, unique_id="smoke"))


def eyring_t60(soup, volume, absorption):
    """Eyring T60 for a uniform absorption; ``volume`` from the waveguide
    mesh's inside-node count."""
    from wayverb_tpu.core import reverb
    area = float(reverb.total_area(soup))
    return float(reverb.eyring_reverb_time(volume, absorption * area,
                                           area)), area


def phase_hall(project_edit=None, hall_kwargs=None, compare=256):
    import jax
    from wayverb_tpu.combined import engine as eng
    from wayverb_tpu.combined.complete import run_project
    from wayverb_tpu.core.environment import Environment
    from wayverb_tpu.raytracer.scenes import procedural_hall
    from wayverb_tpu.signal.filters import decay_time
    soup, n_tris = procedural_hall(**(hall_kwargs or {}))
    env = Environment()
    with tempfile.TemporaryDirectory() as tmp:
        project = hall_project(tmp)
        if project_edit is not None:
            project_edit(project)
        channels = run_project(project, soup, jax.random.PRNGKey(2026))
        written = [os.path.exists(c.path) and os.path.getsize(c.path) > 0
                   for c in channels]
    assert len(channels) == 3 and all(written), written
    fs = project.output.sample_rate
    for c in channels:
        assert np.all(np.isfinite(c.signal)), f"{c.capsule}: non-finite IR"
    omni = np.asarray(channels[0].signal, dtype=np.float64)
    d = float(np.linalg.norm(np.subtract(HALL_SOURCE, HALL_RECEIVER)))
    expected = d / env.speed_of_sound * fs
    peak = direct_peak(omni, fs, expected, 4.0 * project.waveguide.cutoff)

    # the mesh the render used: its volume for Eyring, and its waveguide
    # band on the card against the CPU backend
    e = eng.Engine(soup, project.surface_table(), eng.WaveguideParameters(
        cutoff=project.waveguide.cutoff,
        usable_portion=project.waveguide.usable_portion), environment=env)
    volume = float(e.mesh.room_volume)
    t_eyring, area = eyring_t60(soup, volume,
                                project.materials[0].absorption[0])
    t30 = float(decay_time(jax.numpy.asarray(omni, dtype=np.float32), fs,
                           -5.0, -35.0))
    t30_err = abs(t30 - t_eyring) / t_eyring
    gp, gi, _ = canonical_on(e.mesh, HALL_SOURCE, HALL_RECEIVER, compare,
                             cpu=False)
    cp, ci, _ = canonical_on(e.mesh, HALL_SOURCE, HALL_RECEIVER, compare,
                             cpu=True)
    wg_err = max(max_rel(gp, cp), max_rel(gi, ci))
    checks = {"direct": abs(peak - expected) <= 1.0,
              "t30": t30_err <= T30_REL, "waveguide": wg_err <= WAVE_REL}
    assert all(checks.values()), (checks, peak, expected, t30, t_eyring,
                                  wg_err)
    return dict(triangles=n_tris, mesh_dims=list(e.mesh.descriptor.dimensions),
                rays=project.raytracer.rays,
                order=project.raytracer.maximum_image_source_order,
                cutoff=project.waveguide.cutoff,
                ir_samples=int(omni.size), direct_peak=peak,
                direct_expected=expected, t30=t30, t30_eyring=t_eyring,
                t30_rel=t30_err, t30_bound=T30_REL, volume=volume,
                area=area, waveguide_vs_cpu=wg_err, waveguide_bound=WAVE_REL)


def trace_total(soup, accel, rays, depth, key):
    import jax
    import jax.numpy as jnp
    from wayverb_tpu.core.surfaces import Surface
    from wayverb_tpu.raytracer.tracer import trace
    surfaces = Surface(absorption=jnp.full((1, 8), 0.1),
                       scattering=jnp.full((1, 8), 0.1))

    @jax.jit
    def run(accel):
        res = trace(soup, surfaces, HALL_SOURCE, HALL_RECEIVER, key,
                    num_rays=rays, depth=depth, max_time=1.0, accel=accel)
        return jnp.sum(res.histogram)

    return float(run(accel))


def phase_rays(hall_kwargs=None, rays=RAYS, depth=RAY_DEPTH,
               subset=RAY_SUBSET):
    import jax
    from wayverb_tpu.raytracer.accel import auto_accel
    from wayverb_tpu.raytracer.scenes import procedural_hall_large
    soup, n_tris = procedural_hall_large(**(hall_kwargs or {}))
    accel = auto_accel(soup)
    key = jax.random.PRNGKey(11)
    total = trace_total(soup, accel, rays, depth, key)
    assert np.isfinite(total) and total > 0, total
    sub_accel = trace_total(soup, accel, subset, depth, key)
    sub_dense = trace_total(soup, None, subset, depth, key)
    rel = abs(sub_accel - sub_dense) / abs(sub_dense)
    assert rel <= RAY_TOTAL_REL, (sub_accel, sub_dense)
    return dict(triangles=n_tris, accel=type(accel).__name__, rays=rays,
                depth=depth, total=total, subset=subset,
                subset_total=sub_accel, subset_dense_total=sub_dense,
                subset_rel=rel, bound=RAY_TOTAL_REL)


def phase_sharded(n=4, side=BOX_SIDE, steps=256, hall_kwargs=None,
                  hall_steps=512, rays_per_device=RAYS // 4, depth=RAY_DEPTH):
    """Each sharded path against the single-card run of the same inputs."""
    import jax
    import jax.numpy as jnp
    from wayverb_tpu.combined import engine as eng
    from wayverb_tpu.core.environment import Environment
    from wayverb_tpu.core.surfaces import Surface
    from wayverb_tpu.parallel.box_sharded import (overlap_supported,
                                                  run_waveguide_box_sharded)
    from wayverb_tpu.parallel.general_sharded import \
        canonical_general_sharded
    from wayverb_tpu.parallel.sharding import make_device_mesh, sharded_trace
    from wayverb_tpu.raytracer.accel import auto_accel
    from wayverb_tpu.raytracer.scenes import procedural_hall
    from wayverb_tpu.raytracer.tracer import trace
    from wayverb_tpu.waveguide import run as wgrun
    from wayverb_tpu.waveguide.receivers import make_directional_receiver
    from wayverb_tpu.waveguide.sources import HardSource, impulse_signal

    devices = jax.devices()
    assert len(devices) >= n, f"{len(devices)} devices, need {n}"
    dmesh = make_device_mesh(n)
    out = {}

    # box: the 224×224×256 shoebox, step_overlap order where supported
    box, mesh = box_mesh(side)
    desc, spec = mesh.descriptor, mesh.box_spec
    assert spec.dims[0] % n == 0, spec.dims
    centre = np.asarray(box.centre())
    src = mesh.require_inside(tuple(centre))
    rcv = mesh.require_inside(tuple(centre + [0.0, 0.0, 20 * desc.spacing]))
    source = HardSource(
        node_idx=jnp.asarray(desc.flat_index(src), dtype=jnp.int32),
        signal=impulse_signal(steps, 1.0))
    env = Environment()
    receiver = make_directional_receiver(
        desc, desc.sample_rate(env.speed_of_sound), env.ambient_density,
        desc.position(rcv))
    single = wgrun.run_waveguide_box(mesh.structure, spec, source, receiver,
                                     steps)
    sharded = run_waveguide_box_sharded(dmesh, mesh.structure, spec, source,
                                        receiver, steps)
    pairs = list(zip(jax.tree_util.tree_leaves(sharded["outputs"]),
                     jax.tree_util.tree_leaves(single["outputs"])))
    out["box_overlap_order"] = bool(overlap_supported(spec,
                                                      spec.dims[0] // n))
    out["box_rel"] = max(max_rel(a, b) for a, b in pairs)
    out["box_bitwise"] = all(np.array_equal(np.asarray(a), np.asarray(b))
                             for a, b in pairs)
    assert bool(sharded["stable"]) and out["box_rel"] <= WAVE_REL, out
    # every card held its x-slab of the fields (two f32 fields per shard);
    # the CPU backend of a rehearsal reports no memory statistics
    stats = [d.memory_stats() for d in devices[:n]]
    if all(stats):
        peaks = [st["peak_bytes_in_use"] for st in stats]
        out["peak_bytes_per_device"] = peaks
        slab = 2 * 4 * desc.num_nodes // n
        assert min(peaks) >= slab, (peaks, slab)

    # general mesh: the hall through general_sharded
    soup, _ = procedural_hall(**(hall_kwargs or {}))
    surfaces = Surface(absorption=jnp.full((1, 8), 0.2),
                       scattering=jnp.full((1, 8), 0.1))
    e = eng.Engine(soup, surfaces, device_mesh=dmesh)
    t = steps_time(e.mesh.descriptor, hall_steps)
    gs = canonical_general_sharded(e.mesh, HALL_SOURCE, HALL_RECEIVER, t,
                                   dmesh)
    g1 = wgrun.canonical(e.mesh, HALL_SOURCE, HALL_RECEIVER, t)
    out["hall_dims"] = list(e.mesh.descriptor.dimensions)
    out["hall_rel"] = max(max_rel(gs.pressure, g1.pressure),
                          max_rel(gs.intensity, g1.intensity))
    out["hall_bitwise"] = bool(
        np.array_equal(np.asarray(gs.pressure), np.asarray(g1.pressure)))
    assert bool(gs.stable) and out["hall_rel"] <= WAVE_REL, out

    # rays: data-parallel trace vs the same per-device folds on one card
    key = jax.random.PRNGKey(5)
    accel = auto_accel(soup)
    hist = sharded_trace(dmesh, dmesh.axis_names[0], soup, surfaces,
                         HALL_SOURCE, HALL_RECEIVER, key, rays_per_device,
                         depth, 1.0, accel=accel)
    ref = 0.0
    for i in range(n):
        res = trace(soup, surfaces, HALL_SOURCE, HALL_RECEIVER,
                    jax.random.fold_in(key, i), num_rays=rays_per_device,
                    depth=depth, max_time=1.0, accel=accel)
        ref = ref + np.asarray(res.histogram, dtype=np.float64) / n
    out["rays_rel"] = max_rel(hist, ref)
    assert out["rays_rel"] <= 1e-5, out["rays_rel"]
    return out


PHASES = {"box": phase_box, "grad": phase_grad, "hall": phase_hall,
          "rays": phase_rays, "sharded": phase_sharded}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX's first device is {devices[0].platform}, "
              "not a GPU; refusing to run", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: {len(devices)} GPU(s), need {need}",
              file=sys.stderr)
        return 2
    try:
        import_package()
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 3

    from wayverb_tpu.utils import native
    from wayverb_tpu.utils.card import card_line
    from wayverb_tpu.utils.compile_cache import configure_compile_cache
    card = card_line()
    cache = configure_compile_cache()
    import jaxlib
    print(f"card: {card}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"devices {len(devices)} × {devices[0].device_kind}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS', '')!r}")
    print(f"compile cache: {cache}")
    print(f"setup library: {json.dumps(native.status())}", flush=True)

    failed = []
    for name in phases_for(args.four_cards):
        t0 = time.perf_counter()
        try:
            result = PHASES[name]()
        except Exception:
            failed.append(name)
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
            traceback.print_exc()
            continue
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s on "
              f"{card}: {json.dumps(result)}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(card)
    print(final_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
