"""Where the voxel DDA overtakes the dense broadcast: ray·bounces/s of both
on procedural halls of growing triangle count, on one NVIDIA GPU.

    python tools/bench/accel_crossover.py [--rays 65536] [--depth 40]

The result sets ``raytracer.accel.DENSE_MAX_TRIS`` (see PERF.md).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import bench  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 16)
    ap.add_argument("--depth", type=int, default=40)
    args = ap.parse_args(argv)

    import jax
    from wayverb_tpu.core.geometry import Box, box_scene
    from wayverb_tpu.raytracer.accel import build_ray_grid
    from wayverb_tpu.raytracer.scenes import procedural_hall
    from wayverb_tpu.utils.card import card_line
    card = card_line()
    key = jax.random.PRNGKey(7)
    scenes = [box_scene(Box((0.0, 0.0, 0.0), (20.0, 8.0, 15.0)))]
    scenes += [procedural_hall(shell_div=d, n_columns=c)[0]
               for d, c in ((1, 2), (2, 2), (4, 2), (8, 3), (12, 6))]
    for soup in scenes:
        dda = bench.trace_rate(soup, build_ray_grid(soup), args.rays,
                               args.depth, key)
        dense = bench.trace_rate(soup, None, args.rays, args.depth, key)
        print(f"triangles={soup.num_triangles} dda={dda:.4e} "
              f"dense={dense:.4e} ray·bounces/s dda/dense={dda / dense:.3f}"
              f" on {card}", flush=True)


if __name__ == "__main__":
    main()
