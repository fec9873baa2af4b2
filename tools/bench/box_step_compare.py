"""Box waveguide forward on an NVIDIA GPU: the Triton step against the
plain XLA step, end to end through ``run.run_waveguide_box``.

    python tools/bench/box_step_compare.py [--steps 1024] [--side 224 224 256]

Runs XLA, Triton, Triton, XLA (alternating, one process, one card) and
prints µs/step and the share of the 12 B/node bound for each, the max
relative difference of the receiver traces, and the device time per op
name over a short traced window of each.  To see what an XLA fusion
does, add ``XLA_FLAGS="--xla_dump_to=DIR --xla_dump_hlo_as_text"`` and read
its ``*after_optimizations.txt``.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import bench  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--side", type=int, nargs=3, default=[224, 224, 256])
    args = ap.parse_args(argv)

    import jax
    from wayverb_tpu.waveguide import box_fused
    from wayverb_tpu.waveguide.run import run_waveguide_box

    dev = jax.devices()[0]
    bound = bench.hbm_bandwidth(dev.device_kind) / bench.BYTES_PER_NODE
    from wayverb_tpu.utils.card import card_line
    card = card_line()
    mesh, source, receiver = bench.box_problem(tuple(args.side), args.steps)
    n = mesh.descriptor.num_nodes
    triton_forward = box_fused._triton_forward

    def make(kind):
        box_fused._triton_forward = (triton_forward if kind == "triton"
                                     else box_fused._jnp_forward)
        fn = jax.jit(lambda: run_waveguide_box(
            mesh.structure, mesh.box_spec, source, receiver, args.steps))
        jax.block_until_ready(fn())          # trace + compile now
        box_fused._triton_forward = triton_forward
        return fn

    fns = {k: make(k) for k in ("xla", "triton")}
    outs = {}
    for kind in ("xla", "triton", "triton", "xla"):
        dt, spread, out = bench.timed(fns[kind], reps=5)
        outs[kind] = out
        us = dt / args.steps * 1e6
        print(f"{kind}: {us:.2f} µs/step (spread "
              f"{spread / args.steps * 1e6:.2f}), {n / (dt / args.steps):.4e}"
              f" upd/s, {n / (dt / args.steps) / bound:.4f} of bound, "
              f"stable={bool(out['stable'])} on {card}", flush=True)
    a = np.asarray(outs["triton"]["outputs"], np.float64)
    b = np.asarray(outs["xla"]["outputs"], np.float64)
    print(f"trace max rel diff: {np.abs(a - b).max() / np.abs(b).max():.3e}")

    short = {}
    for kind in ("xla", "triton"):
        box_fused._triton_forward = (triton_forward if kind == "triton"
                                     else box_fused._jnp_forward)
        short[kind] = jax.jit(lambda: run_waveguide_box(
            mesh.structure, mesh.box_spec, source, receiver, 32))
        jax.block_until_ready(short[kind]())
        box_fused._triton_forward = triton_forward
    for kind, fn in short.items():
        with tempfile.TemporaryDirectory() as tdir:
            with jax.profiler.trace(tdir):
                jax.block_until_ready(fn())
            ops = bench.top_device_ops(tdir, top=10)
        print(f"{kind} top device ops over 32 steps (ns): {ops}")


if __name__ == "__main__":
    main()
