"""Fused plane-boundary path: parity with the general weight-code path,
hand-written VJP correctness, and the shard decomposition contract."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wayverb_tpu.core.environment import Environment
from wayverb_tpu.core.geometry import Box
from wayverb_tpu.waveguide import run as wgrun
from wayverb_tpu.waveguide.box_fused import (BoxSpec, fused_step,
                                             plane_boundary_step,
                                             spec_from_inside)
from wayverb_tpu.waveguide.descriptor import grid_spacing

ENV = Environment()
FS = 3333.33
DX = grid_spacing(ENV.speed_of_sound, 1.0 / FS)


def small_box_mesh(absorption=0.12):
    box = Box((0, 0, 0), (1.4, 1.6, 1.8))
    return box, wgrun.shoebox_mesh(box, np.full((1, 8), absorption), DX, FS)


class TestSpec:
    def test_spec_from_inside(self):
        _, mesh = small_box_mesh()
        spec = mesh.box_spec
        assert spec is not None
        idx = np.argwhere(mesh.inside)
        assert spec.ilo == tuple(idx.min(axis=0))
        assert spec.ihi == tuple(idx.max(axis=0))
        # plane coverage equals the compact boundary-node count
        n_plane = 0
        for a in range(3):
            ext = [spec.ihi[k] - spec.ilo[k] + 3 for k in range(3)]
            ext[a] = 1
            n_plane += 2 * int(np.prod(ext))
        # faces counted once, edges twice, corners three times:
        # n_plane = B + 2*edges + 3*... reconstruct directly instead
        dims_in = [spec.ihi[k] - spec.ilo[k] + 1 for k in range(3)]
        faces = 2 * (dims_in[0] * dims_in[1] + dims_in[1] * dims_in[2]
                     + dims_in[0] * dims_in[2])
        edges = 4 * sum(dims_in)
        corners = 8
        assert mesh.structure.num_boundary_nodes == faces + edges + corners

    def test_rejects_edge_touching_box(self):
        with pytest.raises(ValueError):
            BoxSpec(dims=(8, 8, 8), ilo=(1, 2, 2), ihi=(5, 5, 5),
                    face_surface=(0,) * 6)


class TestFusedParity:
    def test_matches_gather_path(self):
        """Whole-run parity: fused plane path vs compact gather path (which
        is itself parity-tested against the per-node naive oracle)."""
        box, mesh = small_box_mesh()
        assert mesh.box_spec is not None
        out_f = wgrun.canonical(mesh, (0.7, 0.8, 0.5), (0.7, 0.8, 1.3),
                                0.08, ENV)
        mesh_g = dataclasses.replace(mesh, box_spec=None, regions=None)
        out_g = wgrun.canonical(mesh_g, (0.7, 0.8, 0.5), (0.7, 0.8, 1.3),
                                0.08, ENV)
        np.testing.assert_allclose(np.asarray(out_f.pressure),
                                   np.asarray(out_g.pressure), atol=2e-5)
        np.testing.assert_allclose(np.asarray(out_f.intensity),
                                   np.asarray(out_g.intensity), atol=2e-5)
        assert bool(out_f.stable)

    def test_matches_region_path(self):
        box, mesh = small_box_mesh(absorption=0.3)
        out_f = wgrun.canonical(mesh, (0.7, 0.8, 0.5), (0.6, 0.9, 1.2),
                                0.05, ENV)
        mesh_r = dataclasses.replace(mesh, box_spec=None)
        out_r = wgrun.canonical(mesh_r, (0.7, 0.8, 0.5), (0.6, 0.9, 1.2),
                                0.05, ENV)
        np.testing.assert_allclose(np.asarray(out_f.pressure),
                                   np.asarray(out_r.pressure), atol=2e-5)

    def test_f64_state_close_to_f32(self):
        """Wider filter state must not change the physics (drift study for
        the reference's double-precision filter state mandate).

        Runs under jax_enable_x64 so float64 is REAL (without it the state
        silently truncates to f32 and the comparison is vacuous — ADVICE
        r2); asserts the state dtype actually widened.
        """
        from wayverb_tpu.waveguide.box_fused import (initial_box_carry,
                                                     make_box_body)
        from wayverb_tpu.waveguide.receivers import NodeReceiver
        from wayverb_tpu.waveguide.run import run_waveguide_box
        from wayverb_tpu.waveguide.sources import HardSource, impulse_signal
        box, mesh = small_box_mesh()
        desc = mesh.descriptor
        src = mesh.require_inside((0.7, 0.8, 0.5))
        rcv = mesh.require_inside((0.7, 0.8, 1.3))
        source = HardSource(
            node_idx=jnp.asarray(desc.flat_index(src), dtype=jnp.int32),
            signal=impulse_signal(400, 1.0))
        receiver = NodeReceiver(
            node_idx=jnp.asarray(desc.flat_index(rcv), dtype=jnp.int32))
        with jax.enable_x64(True):
            init = initial_box_carry(mesh.structure, mesh.box_spec,
                                     receiver, jnp.float32, jnp.float64)
            assert init[2][3].dtype == jnp.float64   # stacked filter state
            o32 = run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                    receiver, 400)
            o64 = run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                    receiver, 400, state_dtype=jnp.float64)
            np.testing.assert_allclose(np.asarray(o32["outputs"]),
                                       np.asarray(o64["outputs"]),
                                       atol=1e-5)


# one tile-friendly shape and one with no dimension a multiple of 8
STEP_DIMS = [(16, 16, 128), (14, 11, 13)]


def _random_problem(rng, dims=(16, 16, 128)):
    inside = np.zeros(dims, dtype=bool)
    inside[2:-2, 2:-2, 2:-2] = True
    spec = spec_from_inside(inside)
    cur = jnp.asarray(rng.normal(size=dims).astype(np.float32))
    prev = jnp.asarray(rng.normal(size=dims).astype(np.float32))
    planes = tuple(
        jnp.asarray(rng.normal(size=spec.plane_shape(p)).astype(np.float32))
        for p in range(6))
    return spec, cur, prev, planes


def _inner_weights(rng, spec):
    return tuple(
        jnp.asarray(rng.normal(size=spec.plane_shape(p)).astype(np.float32))
        for p in range(6))


class TestFusedStep:
    @pytest.mark.parametrize("dims", STEP_DIMS)
    def test_custom_vjp_matches_jnp_autodiff(self, rng, dims):
        """The hand VJP (writer-precedence plane masks + one-hot inner-plane
        placement + halo rows) must equal autodiff of the plain forward."""
        from wayverb_tpu.waveguide.box_fused import _jnp_forward
        spec, cur, prev, planes = _random_problem(rng, dims)
        geom = spec.geom_array()
        g = jnp.asarray(rng.normal(size=cur.shape).astype(np.float32))
        wi = _inner_weights(rng, spec)
        halos = tuple(
            jnp.asarray(rng.normal(
                size=(1,) + cur.shape[1:]).astype(np.float32))
            for _ in range(2))

        def weighted(out):
            nxt, inner = out
            return jnp.sum(nxt * g) + sum(
                jnp.sum(w * p) for w, p in zip(wi, inner))

        def loss_custom(cur, prev, planes, halos):
            return weighted(fused_step(spec, geom, cur, prev, planes,
                                       halos=halos))

        def loss_ref(cur, prev, planes, halos):
            return weighted(_jnp_forward(geom, cur, prev, planes,
                                         halos=halos))

        gc = jax.grad(loss_custom, argnums=(0, 1, 2, 3))(
            cur, prev, planes, halos)
        gr = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(
            cur, prev, planes, halos)
        for got, ref in zip(jax.tree_util.tree_leaves(gc),
                            jax.tree_util.tree_leaves(gr)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       atol=1e-4)

    @pytest.mark.parametrize("dims", STEP_DIMS)
    def test_sharded_halves_match_full(self, rng, dims):
        """Running the step on two x-halves with geom offsets + exchanged
        halo rows must reproduce the full-grid step exactly (the shard_map
        decomposition contract)."""
        spec, cur, prev, planes = _random_problem(rng, dims)
        X = cur.shape[0]
        XL = X // 2

        full_out, full_inner = fused_step(spec, spec.geom_array(), cur,
                                          prev, planes)

        pxlo, pxhi, pylo, pyhi, pzlo, pzhi = planes
        halves_out, halves_inner = [], []
        for s, off in ((0, 0), (1, XL)):
            geom = spec.geom_array(x_offset=off)
            local_planes = (pxlo, pxhi,
                            pylo[off:off + XL], pyhi[off:off + XL],
                            pzlo[off:off + XL], pzhi[off:off + XL])
            hlo = cur[off - 1:off] if off > 0 \
                else jnp.zeros_like(cur[:1])
            hhi = cur[off + XL:off + XL + 1] if off + XL < X \
                else jnp.zeros_like(cur[:1])
            out, inner = fused_step(
                spec, geom, cur[off:off + XL], prev[off:off + XL],
                local_planes, halos=(hlo, hhi))
            halves_out.append(out)
            halves_inner.append(inner)

        np.testing.assert_allclose(
            np.asarray(jnp.concatenate(halves_out, axis=0)),
            np.asarray(full_out), atol=1e-5)
        # y/z inner planes concatenate; x inner planes come from the owner
        for p, (a, side) in enumerate(
                ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))):
            if a == 0:
                coord = spec.ilo[0] if side == 0 else spec.ihi[0]
                got = halves_inner[coord // XL][p]
            else:
                got = jnp.concatenate(
                    [halves_inner[0][p], halves_inner[1][p]], axis=0)
            np.testing.assert_allclose(np.asarray(got),
                                       np.asarray(full_inner[p]),
                                       atol=1e-5)


class TestTritonStepInterpret:
    """The GPU step kernel (Pallas, Triton route) run by the interpreter
    against the XLA expression it replaces on the card."""

    @pytest.mark.parametrize("dims", STEP_DIMS)
    @pytest.mark.parametrize("mode", [0, 1, 2])
    def test_matches_jnp_forward(self, rng, dims, mode):
        from wayverb_tpu.waveguide.box_fused import _jnp_forward
        from wayverb_tpu.waveguide.box_triton import fused_field
        spec, cur, prev, planes = _random_problem(rng, dims)
        halos = tuple(
            jnp.asarray(rng.normal(
                size=(1,) + cur.shape[1:]).astype(np.float32))
            for _ in range(2))
        inj = np.asarray([spec.ilo[0], spec.ilo[1] + 1, spec.ihi[2], mode],
                         np.int32)
        val = np.asarray([0.7, -0.3], np.float32)
        geom = spec.geom_array(x_offset=0)
        want, _ = _jnp_forward(geom, cur, prev, planes, inj, val, halos)
        got = fused_field(geom, cur, prev, planes, inj, val, halos,
                          interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)


class TestKernelChoice:
    """Which step each platform compiles: lowering for CUDA (no card
    needed) must emit the Triton kernel, under vmap and grad too; the CPU
    lowering keeps the XLA expression."""

    @pytest.mark.parametrize("platform,variant", [
        ("cuda", "plain"), ("cuda", "vmap"), ("cuda", "grad"),
        ("cpu", "plain")])
    def test_lowering(self, rng, platform, variant):
        spec, cur, prev, planes = _random_problem(rng, (16, 16, 128))
        geom = spec.geom_array()

        def step(c, p):
            return fused_step(spec, geom, c, p, planes)[0]

        if variant == "vmap":
            fn = jax.vmap(step)
            args = (jnp.stack([cur, cur]), jnp.stack([prev, prev]))
        elif variant == "grad":
            fn = jax.grad(lambda c, p: jnp.sum(step(c, p) ** 2))
            args = (cur, prev)
        else:
            fn, args = step, (cur, prev)
        text = jax.jit(fn).trace(*args).lower(
            lowering_platforms=(platform,)).as_text()
        assert ("box_fused_step" in text) == (platform == "cuda")

    def test_shard_map_keeps_xla_step(self, rng):
        """Under shard_map (checked varying axes) the CUDA lowering keeps
        the XLA step: Pallas cannot trace refs that carry a mesh axis."""
        from jax.sharding import PartitionSpec as P

        from wayverb_tpu.parallel.sharding import make_device_mesh
        spec, cur, prev, planes = _random_problem(rng, (16, 16, 128))
        xl = 8
        local = planes[:2] + tuple(p[:xl] for p in planes[2:])

        def body(c, p):
            geom = spec.geom_array(x_offset=jax.lax.axis_index("x") * xl)
            return fused_step(spec, geom, c, p, local)[0]

        fn = jax.shard_map(body, mesh=make_device_mesh(2),
                           in_specs=(P("x"), P("x")), out_specs=P("x"),
                           check_vma=True)
        text = jax.jit(fn).trace(cur, prev).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "box_fused_step" not in text


class TestInjectionSemantics:
    """Fused-path injection must match the gather oracle in every placement
    the ADVICE r2 findings flagged: receiver at the source node, Gaussian
    support touching a wall, and gradients through the default kernel-inject
    configuration."""

    def test_receiver_at_source_node(self):
        """Kernel-inject taps must read POST-injection pressure."""
        from wayverb_tpu.waveguide.receivers import NodeReceiver
        from wayverb_tpu.waveguide.run import run_waveguide_box
        from wayverb_tpu.waveguide.sources import HardSource, impulse_signal
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        src = mesh.require_inside((0.7, 0.8, 0.5))
        node = jnp.asarray(desc.flat_index(src), dtype=jnp.int32)
        source = HardSource(node_idx=node, signal=impulse_signal(60, 1.0))
        receiver = NodeReceiver(node_idx=node)
        o_k = run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                receiver, 60)
        o_x = run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                receiver, 60, kernel_inject=False)
        np.testing.assert_allclose(np.asarray(o_k["outputs"]),
                                   np.asarray(o_x["outputs"]), atol=1e-6)
        # step 0 must see the injected impulse, not the zero field
        assert abs(float(o_k["outputs"][0]) - 1.0) < 1e-6

    def test_gaussian_source_near_wall_matches_gather(self):
        """A Gaussian ball within support radius of a wall must agree with
        the gather oracle (support clipped to inside nodes on both paths)."""
        from wayverb_tpu.waveguide.receivers import NodeReceiver
        from wayverb_tpu.waveguide.run import (_run_waveguide_jit,
                                               run_waveguide_box)
        from wayverb_tpu.waveguide.sources import make_gaussian_source
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        spec = mesh.box_spec
        # centre 2 cells from the low-x wall with 4-cell support
        near_wall = desc.position(np.array([spec.ilo[0] + 2,
                                            spec.ilo[1] + 6,
                                            spec.ilo[2] + 6]))
        sig = np.zeros(80, np.float32)
        sig[:8] = np.hanning(8)
        source = make_gaussian_source(desc, tuple(near_wall), 3 * DX, sig,
                                      inside=mesh.inside)
        rcv = mesh.require_inside((0.7, 0.8, 1.3))
        receiver = NodeReceiver(
            node_idx=jnp.asarray(desc.flat_index(rcv), dtype=jnp.int32))
        o_f = run_waveguide_box(mesh.structure, spec, source, receiver, 80)
        o_g = _run_waveguide_jit(mesh.structure, desc.dimensions, source,
                                 receiver, 80)
        np.testing.assert_allclose(np.asarray(o_f["outputs"]),
                                   np.asarray(o_g["outputs"]),
                                   rtol=1e-5, atol=2e-5)

    def test_grad_through_default_box_path(self):
        """jax.grad w.r.t. material coefficients through run_waveguide_box's
        DEFAULT configuration (kernel_inject=True) must match the
        kernel_inject=False path and finite differences."""
        from wayverb_tpu.waveguide.receivers import NodeReceiver
        from wayverb_tpu.waveguide.run import run_waveguide_box
        from wayverb_tpu.waveguide.sources import HardSource, impulse_signal
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        src = mesh.require_inside((0.7, 0.8, 0.5))
        rcv = mesh.require_inside((0.7, 0.8, 1.3))
        source = HardSource(
            node_idx=jnp.asarray(desc.flat_index(src), dtype=jnp.int32),
            signal=impulse_signal(90, 1.0))
        receiver = NodeReceiver(
            node_idx=jnp.asarray(desc.flat_index(rcv), dtype=jnp.int32))

        def loss(coef_b, kernel_inject):
            structure = dataclasses.replace(mesh.structure, coef_b=coef_b)
            out = run_waveguide_box(structure, mesh.box_spec, source,
                                    receiver, 90,
                                    kernel_inject=kernel_inject)
            return jnp.sum(out["outputs"] ** 2)

        cb = mesh.structure.coef_b
        g_kern = jax.grad(lambda c: loss(c, True))(cb)
        g_xla = jax.grad(lambda c: loss(c, False))(cb)
        np.testing.assert_allclose(np.asarray(g_kern), np.asarray(g_xla),
                                   rtol=1e-4, atol=1e-8)
        # finite-difference check on the largest-|grad| coefficient
        flat = np.abs(np.asarray(g_kern)).ravel()
        k = int(np.argmax(flat))
        eps = 1e-3
        e = jnp.zeros_like(cb).reshape(-1).at[k].set(eps).reshape(cb.shape)
        fd = (float(loss(cb + e, True)) - float(loss(cb - e, True))) \
            / (2 * eps)
        assert abs(fd - float(np.asarray(g_kern).ravel()[k])) <= \
            2e-3 * max(1.0, abs(fd))

    def test_interior_nan_flagged(self):
        """A NaN injected in the interior must flip ``stable`` (the per-step
        check covers only boundary planes; the final full-field reduction
        in run_waveguide_box is the interior net)."""
        from wayverb_tpu.waveguide.receivers import NodeReceiver
        from wayverb_tpu.waveguide.run import run_waveguide_box
        from wayverb_tpu.waveguide.sources import SoftSource
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        src = mesh.require_inside((0.7, 0.8, 0.9))
        rcv = mesh.require_inside((0.7, 0.8, 1.3))
        sig = jnp.zeros(6).at[2].set(jnp.nan)
        source = SoftSource(
            node_idx=jnp.asarray(desc.flat_index(src), dtype=jnp.int32),
            signal=sig)
        receiver = NodeReceiver(
            node_idx=jnp.asarray(desc.flat_index(rcv), dtype=jnp.int32))
        out = run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                receiver, 6)
        assert not bool(out["stable"])


class TestPlaneStep:
    def test_quiescent_stays_quiescent(self, rng):
        spec, cur, prev, _ = _random_problem(rng)
        cur = jnp.zeros_like(cur)
        prev = jnp.zeros_like(prev)
        face_b = jnp.tile(jnp.asarray([[1.0, 0, 0, 0, 0, 0, 0]]), (6, 1))
        face_a = jnp.tile(jnp.asarray([[1.0, 0, 0, 0, 0, 0, 0]]), (6, 1))
        states = spec.initial_states(6)
        pplus, new_states = plane_boundary_step(cur, prev, states, spec,
                                                face_b, face_a)
        for p in pplus:
            assert float(jnp.abs(p).max()) == 0.0
        for s in new_states:
            assert float(jnp.abs(s).max()) == 0.0


def _node_receiver(desc, loc):
    from wayverb_tpu.waveguide.receivers import NodeReceiver
    return NodeReceiver(
        node_idx=jnp.asarray(desc.flat_index(tuple(loc)), dtype=jnp.int32))


class TestBoxVsGeneral:
    """The fused box path against the general weight-code path on the same
    shoebox mesh: sources on every inner plane, odd step counts, soft and
    hard sources, directional capture and material gradients."""

    def test_whole_run_directional(self):
        from wayverb_tpu.waveguide.receivers import \
            make_directional_receiver
        from wayverb_tpu.waveguide.sources import (
            HardSource, impulse_signal, rectilinear_calibration_factor)
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        steps = 16
        src_loc = mesh.require_inside((0.7, 0.8, 0.5))
        rcv_loc = mesh.require_inside((0.7, 0.8, 1.3))
        amp = rectilinear_calibration_factor(desc.spacing,
                                             ENV.acoustic_impedance)
        source = HardSource(
            node_idx=jnp.asarray(desc.flat_index(src_loc), dtype=jnp.int32),
            signal=impulse_signal(steps, amp))
        fs = desc.sample_rate(ENV.speed_of_sound)
        receiver = make_directional_receiver(desc, fs, ENV.ambient_density,
                                             desc.position(rcv_loc))
        box = wgrun.run_waveguide_box(mesh.structure, mesh.box_spec,
                                      source, receiver, steps)
        gen = wgrun.run_waveguide(mesh.structure, desc.dimensions, source,
                                  receiver, steps)
        for a, b in zip(box["outputs"], gen["outputs"]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=2e-5)
        assert bool(box["stable"]) and bool(gen["stable"])

    def test_odd_step_count_soft_source(self):
        from wayverb_tpu.waveguide.sources import SoftSource, impulse_signal
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        steps = 11
        src_loc = mesh.require_inside((0.7, 0.8, 0.5))
        rcv_loc = mesh.require_inside((0.7, 0.8, 1.3))
        source = SoftSource(
            node_idx=jnp.asarray(desc.flat_index(src_loc), dtype=jnp.int32),
            signal=impulse_signal(steps, 2.0))
        receiver = _node_receiver(desc, rcv_loc)
        box = wgrun.run_waveguide_box(mesh.structure, mesh.box_spec,
                                      source, receiver, steps)
        gen = wgrun.run_waveguide(mesh.structure, desc.dimensions, source,
                                  receiver, steps)
        np.testing.assert_allclose(np.asarray(box["outputs"]),
                                   np.asarray(gen["outputs"]), atol=2e-5)

    @pytest.mark.parametrize("axis", [0, 1, 2])
    @pytest.mark.parametrize("side", [0, 1])
    def test_source_on_inner_plane(self, axis, side):
        """A source ON an inner boundary plane must be mirrored into the
        carried inner planes before the boundary update (the z planes are
        narrower than the stacked plane width)."""
        from wayverb_tpu.waveguide.sources import SoftSource, impulse_signal
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        spec = mesh.box_spec
        steps = 10
        loc = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
        loc[axis] = spec.ilo[axis] if side == 0 else spec.ihi[axis]
        rcv = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
        rcv[2] += 2
        source = SoftSource(
            node_idx=jnp.asarray(desc.flat_index(tuple(loc)),
                                 dtype=jnp.int32),
            signal=impulse_signal(steps, 1.5))
        receiver = _node_receiver(desc, rcv)
        box = wgrun.run_waveguide_box(mesh.structure, spec, source,
                                      receiver, steps)
        gen = wgrun.run_waveguide(mesh.structure, desc.dimensions, source,
                                  receiver, steps)
        np.testing.assert_allclose(np.asarray(box["outputs"]),
                                   np.asarray(gen["outputs"]), atol=2e-5)

    def test_material_gradients_match(self):
        """coef_b / coef_a gradients through the box path's hand VJPs equal
        those through the general path's weight-code VJP."""
        from wayverb_tpu.waveguide.sources import HardSource, impulse_signal
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        steps = 12
        src_loc = mesh.require_inside((0.7, 0.8, 0.5))
        rcv_loc = mesh.require_inside((0.7, 0.8, 1.3))
        source = HardSource(
            node_idx=jnp.asarray(desc.flat_index(src_loc), dtype=jnp.int32),
            signal=impulse_signal(steps, 3.0))
        receiver = _node_receiver(desc, rcv_loc)

        def loss(coef_b, coef_a, box):
            structure = dataclasses.replace(mesh.structure, coef_b=coef_b,
                                            coef_a=coef_a)
            if box:
                out = wgrun.run_waveguide_box(structure, mesh.box_spec,
                                              source, receiver, steps)
            else:
                out = wgrun.run_waveguide(structure, desc.dimensions,
                                          source, receiver, steps)
            return jnp.sum(out["outputs"] ** 2)

        args = (mesh.structure.coef_b, mesh.structure.coef_a)
        gb = jax.grad(lambda b, a: loss(b, a, True), argnums=(0, 1))(*args)
        gg = jax.grad(lambda b, a: loss(b, a, False), argnums=(0, 1))(*args)
        for a, b in zip(gb, gg):
            a, b = np.asarray(a), np.asarray(b)
            scale = np.max(np.abs(b)) + 1e-30
            assert np.max(np.abs(a - b)) / scale < 1e-4


class TestSeqTapView:
    def test_replay_matches_direct_tap(self):
        """Replaying a receiver over its pre-gathered tap nodes (what the
        sharded solvers do after one psum) equals tapping the full field."""
        from wayverb_tpu.waveguide.receivers import (SeqTapView,
                                                     make_directional_receiver)
        _, mesh = small_box_mesh()
        desc = mesh.descriptor
        rcv_loc = mesh.require_inside((0.7, 0.8, 1.3))
        fs = desc.sample_rate(ENV.speed_of_sound)
        receiver = make_directional_receiver(desc, fs, ENV.ambient_density,
                                             desc.position(rcv_loc))
        nodes = np.asarray(receiver.tap_nodes())
        fields = np.random.RandomState(1).randn(
            5, desc.num_nodes).astype(np.float32)
        s_view = s_full = receiver.init_state()
        for t in range(5):
            s_view, got = receiver.tap(SeqTapView(jnp.asarray(
                fields[t, nodes])), s_view)
            s_full, want = receiver.tap(jnp.asarray(fields[t]), s_full)
            for a, b in zip(got, want):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-6)
