"""Voxel-DDA ray acceleration: parity with the dense (R, T) broadcast on
both the primitive queries and a full trace, plus hall-scale physics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wayverb_tpu.core.environment import Environment
from wayverb_tpu.core.geometry import (Box, box_scene, line_of_sight,
                                       scene_intersection)
from wayverb_tpu.core.orientation import random_unit_vectors
from wayverb_tpu.core.surfaces import Surface
from wayverb_tpu.raytracer import tracer
from wayverb_tpu.raytracer.accel import (build_ray_grid, grid_intersection,
                                         grid_line_of_sight)
from wayverb_tpu.raytracer.scenes import procedural_hall

ENV = Environment()


def surfaces(a=0.1, s=0.1):
    return Surface(absorption=jnp.full((1, 8), a),
                   scattering=jnp.full((1, 8), s))


def random_rays_inside(soup_box, n, key):
    lo = np.asarray(soup_box.min_corner) + 0.3
    hi = np.asarray(soup_box.max_corner) - 0.3
    ku, kd = jax.random.split(key)
    origins = jax.random.uniform(ku, (n, 3)) * (hi - lo) + lo
    dirs = random_unit_vectors(kd, n)
    return origins.astype(jnp.float32), dirs


class TestGridQueries:
    def test_closest_hit_matches_dense_hall(self):
        soup, _ = procedural_hall(shell_div=8, n_columns=3, column_div=2)
        grid = build_ray_grid(soup)
        box = Box((0, 0, 0), (20.0, 8.0, 15.0))
        origins, dirs = random_rays_inside(box, 512, jax.random.PRNGKey(0))
        td, trid, hitd = scene_intersection(origins, dirs, soup)
        tg, trig, hitg = grid_intersection(origins, dirs, grid, soup)
        np.testing.assert_array_equal(np.asarray(hitg), np.asarray(hitd))
        m = np.asarray(hitd)
        np.testing.assert_allclose(np.asarray(tg)[m], np.asarray(td)[m],
                                   rtol=1e-5)
        # triangle ids may differ only where two triangles share the hit
        # point (equal t); check the distances instead of ids there
        same = np.asarray(trig)[m] == np.asarray(trid)[m]
        assert same.mean() > 0.98

    def test_exclude_triangle(self):
        soup, _ = procedural_hall(shell_div=6, n_columns=0)
        grid = build_ray_grid(soup)
        box = Box((0, 0, 0), (20.0, 8.0, 15.0))
        origins, dirs = random_rays_inside(box, 128, jax.random.PRNGKey(1))
        _, tri, hit = grid_intersection(origins, dirs, grid, soup)
        # relaunch from the hit surface excluding it: must not self-hit
        t2, tri2, hit2 = grid_intersection(origins, dirs, grid, soup,
                                           exclude_triangle=tri)
        m = np.asarray(hit) & np.asarray(hit2)
        assert not np.any(np.asarray(tri2)[m] == np.asarray(tri)[m])

    def test_line_of_sight_matches_dense(self):
        soup, _ = procedural_hall(shell_div=6, n_columns=4, column_div=2)
        grid = build_ray_grid(soup)
        rng = np.random.default_rng(3)
        a = jnp.asarray(rng.uniform([1, 1, 1], [19, 7, 14],
                                    (256, 3)).astype(np.float32))
        b = jnp.asarray(rng.uniform([1, 1, 1], [19, 7, 14],
                                    (256, 3)).astype(np.float32))
        dense = np.asarray(line_of_sight(a, b, soup))
        grd = np.asarray(grid_line_of_sight(a, b, grid, soup))
        assert (dense == grd).mean() > 0.99    # boundary-grazing slack


def _hall_rays(n_tris_scale, n, seed, with_exclude):
    soup, nT = procedural_hall(shell_div=n_tris_scale, n_columns=3,
                               column_div=2)
    rng = np.random.RandomState(seed)
    o = jnp.asarray((rng.uniform(0.1, 0.9, (n, 3))
                     * np.asarray([20, 8, 15])).astype(np.float32))
    d = rng.randn(n, 3).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    ex = jnp.asarray(rng.randint(-1, nT, n).astype(np.int32)) \
        if with_exclude else None
    return soup, o, d, ex


class TestDDAOnHall:
    """The voxel DDA against the dense broadcast on procedural halls."""

    @pytest.mark.parametrize("shell_div,with_exclude",
                             [(10, False), (10, True), (14, True)])
    def test_closest_hit_matches_dense(self, shell_div, with_exclude):
        soup, o, d, ex = _hall_rays(shell_div, 1024, shell_div,
                                    with_exclude)
        grid = build_ray_grid(soup)
        td, trid, hitd = scene_intersection(o, d, soup, exclude_triangle=ex)
        tg, trig, hitg = grid_intersection(o, d, grid, soup,
                                           exclude_triangle=ex)
        np.testing.assert_array_equal(np.asarray(hitg), np.asarray(hitd))
        m = np.asarray(hitd)
        np.testing.assert_allclose(np.asarray(tg)[m], np.asarray(td)[m],
                                   rtol=1e-5)
        assert (np.asarray(trig)[m] == np.asarray(trid)[m]).mean() > 0.98
        if ex is not None:
            assert not np.any(np.asarray(trig)[m] == np.asarray(ex)[m])

    def test_line_of_sight_with_exclude_matches_dense(self):
        soup, a, _, ex = _hall_rays(8, 512, 21, True)
        rng = np.random.default_rng(22)
        b = jnp.asarray(rng.uniform([1, 1, 1], [19, 7, 14],
                                    (512, 3)).astype(np.float32))
        grid = build_ray_grid(soup)
        dense = np.asarray(line_of_sight(a, b, soup, exclude_triangle=ex))
        grd = np.asarray(grid_line_of_sight(a, b, grid, soup,
                                            exclude_triangle=ex))
        assert (dense == grd).mean() > 0.99    # boundary-grazing slack

    def test_trace_on_hall_matches_dense(self):
        """Same key ⇒ same bounce sequence ⇒ same histogram, through the
        full stochastic tracer on a hall (not only a box)."""
        soup, _ = procedural_hall(shell_div=8, n_columns=2)
        kw = dict(num_rays=256, depth=6, max_time=0.4)
        args = (soup, surfaces(), (2.0, 1.7, 3.0), (6.0, 1.9, 9.0),
                jax.random.PRNGKey(3))
        rd = tracer.trace(*args, **kw)
        rg = tracer.trace(*args, accel=build_ray_grid(soup), **kw)
        np.testing.assert_allclose(np.asarray(rg.histogram),
                                   np.asarray(rd.histogram),
                                   rtol=1e-4, atol=1e-12)

    @pytest.mark.parametrize("hall", [False, True])
    def test_auto_accel_choice(self, hall):
        from wayverb_tpu.raytracer.accel import (DENSE_MAX_TRIS, RayGrid,
                                                 auto_accel)
        soup = procedural_hall()[0] if hall \
            else box_scene(Box((0, 0, 0), (5.0, 4.0, 3.0)))
        acc = auto_accel(soup)
        if soup.num_triangles <= DENSE_MAX_TRIS:
            assert acc is None
        else:
            assert isinstance(acc, RayGrid)
        assert hall == (acc is not None)


class TestAcceleratedTrace:
    def test_trace_matches_dense_on_box(self):
        """Identical RNG ⇒ identical bounce sequence ⇒ identical histogram
        (box scene, both paths)."""
        box = Box((0, 0, 0), (5.56, 3.97, 2.81))
        soup = box_scene(box)
        grid = build_ray_grid(soup)
        kwargs = dict(num_rays=512, depth=12, max_time=0.6)
        rd = tracer.trace(soup, surfaces(), (2.1, 2.1, 1.2),
                          (2.1, 3.0, 0.9), jax.random.PRNGKey(5), **kwargs)
        rg = tracer.trace(soup, surfaces(), (2.1, 2.1, 1.2),
                          (2.1, 3.0, 0.9), jax.random.PRNGKey(5),
                          accel=grid, **kwargs)
        np.testing.assert_allclose(np.asarray(rg.histogram),
                                   np.asarray(rd.histogram),
                                   rtol=1e-4, atol=1e-8)
        np.testing.assert_array_equal(np.asarray(rg.triangle_history),
                                      np.asarray(rd.triangle_history))

    def test_hall_direct_energy_inverse_square(self):
        """Physics check at hall scale: direct (bounce-0 specular) energy
        at the receiver ≈ 1/(4πr²) per band."""
        soup, ntris = procedural_hall(shell_div=10, n_columns=0)
        assert ntris >= 1000
        grid = build_ray_grid(soup)
        src, rcv = (10.0, 4.0, 5.0), (10.0, 4.0, 9.0)
        res = tracer.trace(soup, surfaces(a=1.0, s=0.0), src, rcv,
                           jax.random.PRNGKey(7), num_rays=60000, depth=1,
                           max_time=0.2, receiver_radius=0.3, accel=grid)
        total = float(jnp.sum(res.histogram)) / 8     # per band
        r = 4.0
        expected = 1.0 / (4 * np.pi * r * r)
        # ~165 expected sphere crossings at this radius/ray count → ~8%
        # Poisson noise; 25% tolerance ≈ 3σ
        np.testing.assert_allclose(total, expected, rtol=0.25)
