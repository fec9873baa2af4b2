"""Fused general-mesh step (stencil.weighted_step + boundary_update):
parity vs the (B, 6)-gather reference path and the per-node naive oracle on
a genuinely general (rotated, non-axis-aligned) scene, the dense passes vs
a per-node gather transcription at unaligned shapes, and the hand VJPs vs
autodiff through the plain formulation.

Reference treatment being matched: one kernel covers interior + boundary
nodes per step (``src/waveguide/src/program.cpp:393-487``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wayverb_tpu.core.geometry import Box, TriangleSoup, box_scene
from wayverb_tpu.waveguide import boundary as bdry
from wayverb_tpu.waveguide.descriptor import (COURANT_SQ,
                                              DIRECTION_OFFSETS,
                                              compute_adjusted_boundary,
                                              descriptor_for_box,
                                              grid_spacing)
from wayverb_tpu.waveguide.naive import naive_step
from wayverb_tpu.waveguide.setup import (build_structure,
                                         classify_boundaries,
                                         classify_inside_scene)
from wayverb_tpu.waveguide.stencil import (interior_step, waveguide_step,
                                           waveguide_step_reference,
                                           weighted_step,
                                           weighted_step_jnp,
                                           weighted_step_sharded)

FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)


def rotated_box_scene(angle=0.42):
    """(descriptor, inside mask, soup) of a box rotated about z."""
    box = Box((0, 0, 0), (0.9, 0.8, 0.7))
    soup = box_scene(box)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    verts = np.asarray(soup.vertices) @ rot.T
    soup = TriangleSoup(vertices=jnp.asarray(verts),
                        triangles=soup.triangles, surfaces=soup.surfaces)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    aabb = Box(tuple(lo), tuple(hi))
    adjusted = compute_adjusted_boundary(
        aabb, tuple((lo + hi) / 2), DX)
    desc = descriptor_for_box(adjusted, DX)
    return desc, classify_inside_scene(desc, soup), soup


def rotated_box_mesh(absorption=0.25, angle=0.42):
    """A box rotated about z: boundary nodes of every direction config,
    plus reentrant nodes — none of the shoebox fast paths apply."""
    desc, inside, soup = rotated_box_scene(angle)
    coeffs = bdry.compute_boundary_coefficients(
        np.full(8, absorption), FS)
    coef_b, coef_a = bdry.coefficient_table([coeffs])
    structure = build_structure(desc, inside, soup, coef_b, coef_a)
    return desc, structure


class TestGeneralFusedParity:
    def test_matches_gather_reference_on_rotated_box(self):
        desc, s = rotated_box_mesh()
        dims = desc.dimensions
        rng = np.random.default_rng(3)
        # random interior excitation, zero outside/boundary (physical state)
        cur = jnp.asarray(
            rng.normal(size=dims).astype(np.float32) *
            np.asarray(s.interior_mask))
        prev = jnp.asarray(
            rng.normal(size=dims).astype(np.float32) *
            np.asarray(s.interior_mask))
        f_fast = s.initial_filter_state()
        f_ref = s.initial_filter_state()
        for _ in range(6):
            nxt_f, f_fast = waveguide_step(cur, prev, f_fast, s)
            nxt_r, f_ref = waveguide_step_reference(cur, prev, f_ref, s)
            np.testing.assert_allclose(np.asarray(nxt_f), np.asarray(nxt_r),
                                       atol=2e-5)
            np.testing.assert_allclose(np.asarray(f_fast),
                                       np.asarray(f_ref), atol=2e-5)
            prev, cur = cur, nxt_f

    def test_weight_code_interior_bits(self):
        desc, s = rotated_box_mesh()
        code = np.asarray(s.weight_code)
        interior = np.asarray(s.interior_mask) > 0
        assert (code[interior] == 0x103F).all()
        b_idx = np.asarray(s.b_node_idx)
        bcode = code.reshape(-1)[b_idx]
        # every boundary node has at least one weight-2 (inner) direction
        assert ((bcode >> 6) & 0x3F).min() > 0
        # and never the interior subtract-previous bit
        assert ((bcode >> 12) & 1).max() == 0
        # outside nodes are all-zero rows
        outside = ~interior
        outside.reshape(-1)[b_idx] = False
        assert (code[outside] == 0).all()


# shapes with no dimension a multiple of 8 or 128
UNALIGNED = [(3, 4, 5), (6, 7, 9), (11, 5, 13)]


def _gather_neighbours(field):
    """(6,) + shape: field[x + e_d] per direction by flat-index gather,
    zero where the neighbour leaves the grid."""
    idx = np.indices(field.shape)
    flat = field.reshape(-1)
    out = []
    for off in DIRECTION_OFFSETS:
        nb = idx + np.asarray(off).reshape(3, 1, 1, 1)
        valid = np.all((nb >= 0) & (nb < np.asarray(field.shape).reshape(
            3, 1, 1, 1)), axis=0)
        lin = np.ravel_multi_index(tuple(np.where(valid, nb, 0)),
                                   field.shape)
        out.append(np.where(valid, flat[lin], 0.0))
    return np.stack(out)


def _gather_weighted(cur, prev, code):
    nbs = _gather_neighbours(cur)
    acc = sum((((code >> d) & 1) + ((code >> (6 + d)) & 1)) * nbs[d]
              for d in range(6))
    return COURANT_SQ * acc - ((code >> 12) & 1) * prev


def _random_case(shape, seed):
    rng = np.random.default_rng(seed)
    cur = rng.normal(size=shape).astype(np.float32)
    prev = rng.normal(size=shape).astype(np.float32)
    code = rng.integers(0, 1 << 13, size=shape).astype(np.int32)
    return cur, prev, code


class TestDenseStepsVsGather:
    @pytest.mark.parametrize("shape", UNALIGNED)
    def test_weighted_step_matches_gather(self, shape):
        cur, prev, code = _random_case(shape, 11)
        out = weighted_step(jnp.asarray(cur), jnp.asarray(prev),
                            jnp.asarray(code))
        np.testing.assert_allclose(np.asarray(out),
                                   _gather_weighted(cur, prev, code),
                                   atol=1e-5)

    @pytest.mark.parametrize("shape", UNALIGNED)
    def test_interior_step_matches_gather(self, shape):
        cur, prev, code = _random_case(shape, 12)
        mask = (code & 1).astype(np.float32)
        out = interior_step(jnp.asarray(cur), jnp.asarray(prev),
                            jnp.asarray(mask))
        want = (COURANT_SQ * _gather_neighbours(cur).sum(0) - prev) * mask
        np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)

    @pytest.mark.parametrize("shape", UNALIGNED)
    def test_weighted_vjp_matches_autodiff(self, shape):
        cur, prev, code = (jnp.asarray(a) for a in _random_case(shape, 13))
        h = jnp.asarray(np.random.default_rng(5).normal(
            size=shape).astype(np.float32))
        got = jax.grad(lambda c, p: jnp.sum(weighted_step(c, p, code) * h),
                       argnums=(0, 1))(cur, prev)
        ref = jax.grad(
            lambda c, p: jnp.sum(weighted_step_jnp(c, p, code) * h),
            argnums=(0, 1))(cur, prev)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5)

    def _halves(self, cur, prev, code):
        xl = cur.shape[0] // 2
        zero = jnp.zeros_like(cur[:1])
        return [(cur[:xl], prev[:xl], code[:xl], (zero, cur[xl:xl + 1])),
                (cur[xl:], prev[xl:], code[xl:], (cur[xl - 1:xl], zero))]

    def test_sharded_halves_match_full(self):
        cur, prev, code = (jnp.asarray(a)
                           for a in _random_case((10, 5, 7), 14))
        full = weighted_step(cur, prev, code)
        parts = [weighted_step_sharded(*h) for h in
                 self._halves(cur, prev, code)]
        np.testing.assert_allclose(np.asarray(jnp.concatenate(parts)),
                                   np.asarray(full), atol=1e-5)

    def test_sharded_vjp_matches_full_grad(self):
        """Halo cotangents routed back to the neighbour rows reproduce the
        unsharded gradient (the contract the shard_map ppermute relies
        on)."""
        cur, prev, code = (jnp.asarray(a)
                           for a in _random_case((10, 5, 7), 15))
        h = jnp.asarray(np.random.default_rng(6).normal(
            size=cur.shape).astype(np.float32))
        xl = cur.shape[0] // 2

        def sharded_loss(c, p):
            parts = [weighted_step_sharded(*hv) for hv in
                     self._halves(c, p, code)]
            return jnp.sum(jnp.concatenate(parts) * h)

        got = jax.grad(sharded_loss, argnums=(0, 1))(cur, prev)
        ref = jax.grad(
            lambda c, p: jnp.sum(weighted_step_jnp(c, p, code) * h),
            argnums=(0, 1))(cur, prev)
        assert xl == 5
        for a, b in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5)


class TestNaiveOnRotatedBox:
    @pytest.mark.parametrize("angle", [0.42, 0.9])
    def test_waveguide_step_matches_naive(self, angle):
        """The weight-code step (dense pass + compact boundary update) vs
        the per-node transcription of the reference kernel, reentrant and
        every boundary category included."""
        desc, s = rotated_box_mesh(angle=angle)
        cat, inner = classify_boundaries(rotated_box_scene(angle)[1])
        dims = desc.dimensions
        slot_coef = np.zeros(dims + (3,), dtype=int)
        src = tuple(np.argwhere(np.asarray(s.interior_mask) > 0)[0])
        cur_n = np.zeros(dims)
        cur_n[src] = 1.0
        prev_n = np.zeros(dims)
        fmem = {loc: np.zeros((3, s.filter_order))
                for loc in np.ndindex(dims)}
        cur_j, prev_j = jnp.asarray(cur_n), jnp.asarray(prev_n)
        fstate = s.initial_filter_state()
        cb = np.asarray(s.coef_b, dtype=np.float64)
        ca = np.asarray(s.coef_a, dtype=np.float64)
        for _ in range(6):
            nxt_n = naive_step(cur_n, prev_n, fmem, cat, inner, slot_coef,
                               cb, ca)
            nxt_j, fstate = waveguide_step(cur_j, prev_j, fstate, s)
            np.testing.assert_allclose(np.asarray(nxt_j), nxt_n, atol=2e-5)
            prev_n, cur_n = cur_n, nxt_n
            prev_j, cur_j = cur_j, nxt_j


class TestWeightedStepVJP:
    def test_custom_vjp_matches_autodiff(self):
        rng = np.random.default_rng(7)
        dims = (6, 7, 9)
        cur = jnp.asarray(rng.normal(size=dims).astype(np.float32))
        prev = jnp.asarray(rng.normal(size=dims).astype(np.float32))
        code = jnp.asarray(
            rng.integers(0, 1 << 13, size=dims).astype(np.int32))
        h = jnp.asarray(rng.normal(size=dims).astype(np.float32))

        gc, gp = jax.grad(
            lambda c, p: jnp.sum(weighted_step(c, p, code) * h),
            argnums=(0, 1))(cur, prev)
        rc, rp = jax.grad(
            lambda c, p: jnp.sum(weighted_step_jnp(c, p, code) * h),
            argnums=(0, 1))(cur, prev)
        np.testing.assert_allclose(np.asarray(gc), np.asarray(rc),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(gp), np.asarray(rp),
                                   atol=1e-5)


class TestCarriedBoundaryParity:
    def test_run_waveguide_matches_manual_reference_loop(self):
        """run_waveguide's carried boundary-prev optimisation (patch_tap
        compact injection mirror) must reproduce the step-by-step reference
        loop with a HardSource, boundary filters included."""
        import jax.numpy as jnp
        from wayverb_tpu.waveguide.receivers import NodeReceiver
        from wayverb_tpu.waveguide.run import run_waveguide
        from wayverb_tpu.waveguide.sources import (HardSource,
                                                   impulse_signal)

        desc, s = rotated_box_mesh()
        dims = desc.dimensions
        inside_locs = np.argwhere(np.asarray(s.interior_mask) > 0)
        src_loc = inside_locs[len(inside_locs) // 2]
        src_idx = int(np.ravel_multi_index(tuple(src_loc), dims))
        steps = 14
        source = HardSource(node_idx=jnp.asarray(src_idx, dtype=jnp.int32),
                            signal=impulse_signal(steps, 1.0))
        receiver = NodeReceiver(
            node_idx=jnp.asarray(src_idx + 1, dtype=jnp.int32))

        out = run_waveguide(s, dims, source, receiver, steps)
        got = np.asarray(out["outputs"])
        assert bool(out["stable"])

        # manual loop with the gather-based oracle step
        n = int(np.prod(dims))
        cur = jnp.zeros(dims)
        prev = jnp.zeros(dims)
        fstate = s.initial_filter_state()
        ref = []
        for t in range(steps):
            cur_flat = source.inject(cur.reshape(n), t)
            cur = cur_flat.reshape(dims)
            ref.append(float(cur_flat[src_idx + 1]))
            nxt, fstate = waveguide_step_reference(cur, prev, fstate, s)
            prev, cur = cur, nxt
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)
