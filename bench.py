"""Benchmark on one NVIDIA GPU: waveguide fwd/bwd node-updates/s, the
general-mesh step and its parts, and ray·bounces/s on two halls.

    python bench.py [--trace DIR]

Prints the card's name and power limit, one line per section, and as the
LAST line one JSON object:
  {"metric": "waveguide_node_updates_per_s_per_chip", "value": N,
   "unit": "updates/s", "vs_baseline": N, "device": {...},
   "waveguide_fwd": N, "waveguide_bwd": N, "rays_per_s": N,
   "errors": {...}, "extra": {...}}

Each section runs under its own try/except so one failure still reports
the others, but any failed section makes the exit code non-zero.

``vs_baseline`` is the forward waveguide throughput over the memory-bound
bound of the stencil (the reference publishes no throughput numbers, so
the roofline share is the honest denominator): 12 B per node update (read
current + previous, write next) against the card's published HBM
bandwidth, looked up by ``device_kind``.  A card not in the table is an
error, not a default.

Timing: every timed call ends in ``jax.block_until_ready``; each section
reports the median over its repetitions and the spread (max − min) after
one warm-up call that compiles.  ``--trace DIR`` also writes a profiler
trace of a few box and general steps and prints the device time per
kernel name (``top_device_ops``).
"""

import argparse
import json
import os
import statistics
import sys
import time
import traceback

import numpy as np

# Published HBM bandwidth per card, keyed by JAX's ``device_kind``.
# Source: NVIDIA H100 Tensor Core GPU datasheet (SXM5: 80 GB HBM3 at
# 3.35 TB/s).
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
BYTES_PER_NODE = 12.0
BOX_SIDE = (224, 224, 256)
FWD_STEPS = 1024
BWD_STEPS = 256
GENERAL_STEPS = 100
HALL_SOURCE = (2.0, 1.7, 3.0)
HALL_RECEIVER = (6.0, 1.9, 9.0)


def hbm_bandwidth(device_kind: str) -> float:
    try:
        return HBM_BW[device_kind]
    except KeyError:
        raise ValueError(f"no HBM bandwidth for device kind "
                         f"{device_kind!r}; add it to bench.HBM_BW with "
                         f"its datasheet source") from None


def timed(fn, reps=5):
    """(median seconds, spread seconds, last value) of ``fn()`` after one
    warm-up call; ``fn`` returns device arrays."""
    import jax
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), max(times) - min(times), out


def box_problem(side=BOX_SIDE, steps=FWD_STEPS):
    import jax.numpy as jnp
    from wayverb_tpu.core.geometry import Box
    from wayverb_tpu.waveguide import run as wgrun
    from wayverb_tpu.waveguide.descriptor import grid_spacing
    from wayverb_tpu.waveguide.receivers import NodeReceiver
    from wayverb_tpu.waveguide.sources import HardSource, impulse_signal

    # a production-scale mesh: ~12.8 M nodes (a concert hall at the 500 Hz
    # default cutoff is of this order)
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    box = Box((0, 0, 0), tuple(dx * (s - 4) for s in side))
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), dx, fs)
    desc = mesh.descriptor
    centre = np.asarray(box.centre())
    src = mesh.require_inside(tuple(centre))
    rcv = mesh.require_inside(tuple(centre + [0.0, 0.0, dx * 4]))
    source = HardSource(
        node_idx=jnp.asarray(desc.flat_index(src), dtype=jnp.int32),
        signal=impulse_signal(steps, 1.0))
    receiver = NodeReceiver(
        node_idx=jnp.asarray(desc.flat_index(rcv), dtype=jnp.int32))
    return mesh, source, receiver


def bench_waveguide_forward(ctx):
    import jax
    from wayverb_tpu.waveguide.run import run_waveguide_box
    mesh, source, receiver = box_problem()
    n = mesh.descriptor.num_nodes
    fwd = jax.jit(lambda: run_waveguide_box(
        mesh.structure, mesh.box_spec, source, receiver, FWD_STEPS))
    dt, spread, out = timed(fwd)
    if not bool(out["stable"]):
        raise RuntimeError("box forward went unstable")
    ctx.update(mesh=mesh, source=source, receiver=receiver)
    return {"waveguide_fwd": n * FWD_STEPS / dt,
            "fwd_us_per_step": dt / FWD_STEPS * 1e6,
            "fwd_spread_us_per_step": spread / FWD_STEPS * 1e6,
            "box_dims": list(mesh.descriptor.dimensions)}


def bench_waveguide_backward(ctx):
    """jax.grad w.r.t. material filter coefficients through the
    checkpointed box scan (segments of BWD_STEPS/8 steps)."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    from wayverb_tpu.waveguide.run import run_waveguide_box
    from wayverb_tpu.waveguide.sources import HardSource, impulse_signal
    mesh = ctx["mesh"]
    source = HardSource(node_idx=ctx["source"].node_idx,
                        signal=impulse_signal(BWD_STEPS, 1.0))

    def loss(coef_b):
        structure = dc.replace(mesh.structure, coef_b=coef_b)
        out = run_waveguide_box(structure, mesh.box_spec, source,
                                ctx["receiver"], BWD_STEPS,
                                checkpoint_every=BWD_STEPS // 8)
        return jnp.sum(out["outputs"] ** 2)

    grad = jax.jit(jax.grad(loss))
    dt, spread, _ = timed(lambda: grad(mesh.structure.coef_b), reps=3)
    return {"waveguide_bwd": mesh.descriptor.num_nodes * BWD_STEPS / dt,
            "fwdbwd_us_per_step": dt / BWD_STEPS * 1e6,
            "fwdbwd_spread_us_per_step": spread / BWD_STEPS * 1e6}


def general_parts(structure, dims, steps):
    """Per-step times of the general-mesh step and of its three parts:
    the dense weight-code pass, the boundary gather, the boundary
    scatter (each as its own scan of ``steps``)."""
    import jax
    import jax.numpy as jnp
    from wayverb_tpu.waveguide.stencil import weighted_step
    n = int(np.prod(dims))
    idx = structure.b_node_idx
    hint = dict(indices_are_sorted=True, unique_indices=True,
                mode="promise_in_bounds")
    f0 = jnp.zeros(dims, jnp.float32).at[dims[0] // 2, dims[1] // 2,
                                          dims[2] // 2].set(1.0)

    @jax.jit
    def dense(cur):
        def body(c, _):
            return (weighted_step(c[0], c[1], structure.weight_code),
                    c[0]), None
        return jax.lax.scan(body, (cur, cur), None, length=steps)[0][0]

    # the gather and scatter loops touch the field only in place (one
    # element, or the boundary nodes), so they time the indexed access
    @jax.jit
    def gather(cur):
        def body(c, _):
            f, s = c
            f = f.at[0, 0, 0].add(s * 1e-30)
            return (f, jnp.sum(f.reshape(n).at[idx].get(**hint))), None
        return jax.lax.scan(body, (cur, jnp.float32(0)), None,
                            length=steps)[0][1]

    @jax.jit
    def scatter(cur):
        vals = jnp.ones(idx.shape, jnp.float32)

        def body(c, _):
            f, s = c
            f = f.reshape(n).at[idx].set(vals + s * 1e-30,
                                         **hint).reshape(dims)
            return (f, f[0, 0, 0]), None
        return jax.lax.scan(body, (cur, jnp.float32(0)), None,
                            length=steps)[0][1]

    out = {}
    for name, fn in (("dense", dense), ("gather", gather),
                     ("scatter", scatter)):
        dt, spread, _ = timed(lambda fn=fn: fn(f0), reps=3)
        out[f"{name}_us_per_step"] = dt / steps * 1e6
    return out


def bench_general(ctx):
    """The general (weight-code + compact boundary) solver on the box mesh
    (geometry-matched to the box headline) and on the procedural hall."""
    import dataclasses as dc

    import jax
    from wayverb_tpu.combined import engine as eng
    from wayverb_tpu.core.surfaces import Surface
    from wayverb_tpu.raytracer.scenes import procedural_hall
    from wayverb_tpu.waveguide import run as wgrun
    from wayverb_tpu.waveguide.receivers import NodeReceiver
    from wayverb_tpu.waveguide.sources import HardSource
    import jax.numpy as jnp

    res = {}
    mesh = ctx["mesh"]
    src = dc.replace(ctx["source"],
                     signal=ctx["source"].signal[:GENERAL_STEPS])
    soup, _ = procedural_hall()
    hall = eng.Engine(soup, Surface(absorption=jnp.full((1, 8), 0.2),
                                    scattering=jnp.full((1, 8), 0.5))).mesh
    hdesc = hall.descriptor
    hsrc = HardSource(
        node_idx=jnp.asarray(hdesc.flat_index(hall.require_inside(
            HALL_SOURCE)), dtype=jnp.int32),
        signal=src.signal)
    hrcv = NodeReceiver(node_idx=jnp.asarray(hdesc.flat_index(
        hall.require_inside(HALL_RECEIVER)), dtype=jnp.int32))
    for name, m, s, r in (("box", mesh, src, ctx["receiver"]),
                          ("hall", hall, hsrc, hrcv)):
        dims = m.descriptor.dimensions
        fwd = jax.jit(lambda m=m, s=s, r=r, dims=dims: wgrun.run_waveguide(
            m.structure, dims, s, r, GENERAL_STEPS))
        dt, spread, _ = timed(fwd, reps=3)
        res[f"general_{name}_updates_per_s"] = \
            m.descriptor.num_nodes * GENERAL_STEPS / dt
        res[f"general_{name}_us_per_step"] = dt / GENERAL_STEPS * 1e6
        res[f"general_{name}_dims"] = list(dims)
        res[f"general_{name}_boundary_nodes"] = \
            int(m.structure.b_node_idx.shape[0])
        for k, v in general_parts(m.structure, dims,
                                  GENERAL_STEPS).items():
            res[f"general_{name}_{k}"] = v
    return res


def trace_rate(soup, accel, rays, depth, key):
    """ray·bounces/s of tracer.trace, and its histogram total."""
    import jax
    import jax.numpy as jnp
    from wayverb_tpu.core.surfaces import Surface
    from wayverb_tpu.raytracer.tracer import trace
    surfaces = Surface(absorption=jnp.full((1, 8), 0.1),
                       scattering=jnp.full((1, 8), 0.1))
    run = jax.jit(lambda: jnp.sum(trace(
        soup, surfaces, HALL_SOURCE, HALL_RECEIVER, key, num_rays=rays,
        depth=depth, max_time=1.0, accel=accel).histogram))
    dt, spread, total = timed(run, reps=3)
    total = float(total)
    if not np.isfinite(total) or total <= 0:
        raise RuntimeError(f"trace deposited no energy ({total})")
    return rays * depth / dt


def bench_rays(ctx):
    """Voxel DDA and dense broadcast on the ≈5.4k-triangle hall (2¹⁶ rays)
    and the ≈97k-triangle hall (DDA at 2¹⁶ rays; the dense broadcast's
    (R, T) intermediates limit it to 4,096 rays there)."""
    import jax
    from wayverb_tpu.raytracer.accel import auto_accel, build_ray_grid
    from wayverb_tpu.raytracer.scenes import (procedural_hall,
                                              procedural_hall_large)
    key = jax.random.PRNGKey(7)
    res = {}
    soup, n_small = procedural_hall()
    large, n_large = procedural_hall_large()
    res["hall_triangles"] = n_small
    res["large_hall_triangles"] = n_large
    res["rays_per_s_dda"] = trace_rate(soup, build_ray_grid(soup),
                                       1 << 16, 40, key)
    res["rays_per_s_dense"] = trace_rate(soup, None, 1 << 16, 40, key)
    res["rays_per_s_large_dda"] = trace_rate(large, build_ray_grid(large),
                                             1 << 16, 40, key)
    res["rays_per_s_large_dense_4096"] = trace_rate(large, None, 4096, 40,
                                                    key)
    auto = auto_accel(soup)
    res["rays_per_s"] = res["rays_per_s_dense"] if auto is None \
        else res["rays_per_s_dda"]
    return res


def top_device_ops(trace_dir, top=12):
    """Device time per op name from the newest profiler trace under
    ``trace_dir``: {name: total ns}, largest first, device planes only."""
    import glob

    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    totals = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                totals[ev.name] = totals.get(ev.name, 0) + ev.duration_ns
    return dict(sorted(totals.items(), key=lambda kv: -kv[1])[:top])


def bench_trace(ctx, trace_dir):
    """A short profiler window: 32 box steps, then 32 general-path steps
    on the same box mesh."""
    import jax
    from wayverb_tpu.waveguide import run as wgrun
    mesh, source, receiver = ctx["mesh"], ctx["source"], ctx["receiver"]
    box = jax.jit(lambda: wgrun.run_waveguide_box(
        mesh.structure, mesh.box_spec, source, receiver, 32))
    gen = jax.jit(lambda: wgrun.run_waveguide(
        mesh.structure, mesh.descriptor.dimensions, source, receiver, 32))
    jax.block_until_ready((box(), gen()))
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(box())
    res = {"box_top_device_ops_ns": top_device_ops(trace_dir)}
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(gen())
    res["general_top_device_ops_ns"] = top_device_ops(trace_dir)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace a short window into DIR")
    args = ap.parse_args(argv)

    import jax
    from wayverb_tpu.utils.card import card_line
    from wayverb_tpu.utils.compile_cache import configure_compile_cache
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: first device is {dev.platform}, not a GPU",
              file=sys.stderr)
        return 2
    bound = hbm_bandwidth(dev.device_kind) / BYTES_PER_NODE
    card = card_line()
    print(f"card: {card}; compile cache: {configure_compile_cache()}",
          flush=True)

    metrics, extra, errors, ctx = {}, {}, {}, {}
    sections = [("waveguide_fwd", bench_waveguide_forward),
                ("waveguide_bwd", bench_waveguide_backward),
                ("general", bench_general),
                ("rays", bench_rays)]
    if args.trace:
        sections.append(("trace", lambda c: bench_trace(c, args.trace)))
    for name, fn in sections:
        t0 = time.perf_counter()
        try:
            res = fn(ctx)
        except Exception:
            errors[name] = traceback.format_exc(limit=4)
            print(f"section {name}: FAILED on {card}\n{errors[name]}",
                  flush=True)
            continue
        for k in ("waveguide_fwd", "waveguide_bwd", "rays_per_s"):
            if k in res:
                metrics[k] = res.pop(k)
        extra.update(res)
        print(f"section {name}: {time.perf_counter() - t0:.1f} s on {card}",
              flush=True)

    fwd = metrics.get("waveguide_fwd")
    extra["speed_of_light_updates_per_s"] = bound
    print(card)
    print(json.dumps({
        "metric": "waveguide_node_updates_per_s_per_chip",
        "value": fwd,
        "unit": "updates/s",
        "vs_baseline": fwd / bound if fwd else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "waveguide_fwd": fwd,
        "waveguide_bwd": metrics.get("waveguide_bwd"),
        "rays_per_s": metrics.get("rays_per_s"),
        "errors": errors,
        "extra": extra,
    }))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
