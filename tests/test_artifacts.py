"""Long-run filter-state drift and the committed boundary-fit sweep
(the sweep's OUTPUT, not just its script, is pinned)."""

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestLongrunDrift:
    def test_f32_state_drift_vs_f64(self):
        """f32 vs f64 IIR filter state over a long low-absorption run at a
        small shape: the receiver trace must stay within the 2e-3 relative
        bound that justifies shipping f32 state where the reference
        mandates double (``cl/filter_structs.h:14``)."""
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        from wayverb_tpu.core.geometry import Box
        from wayverb_tpu.waveguide import run as wgrun
        from wayverb_tpu.waveguide.descriptor import grid_spacing
        from wayverb_tpu.waveguide.receivers import NodeReceiver
        from wayverb_tpu.waveguide.sources import (
            HardSource, impulse_signal, rectilinear_calibration_factor)
        fs, steps = 3333.33, 3000
        dx = grid_spacing(340.0, 1.0 / fs)
        box = Box((0, 0, 0), (dx * 12, dx * 10, dx * 14))
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.05), dx, fs)
        desc = mesh.descriptor
        centre = np.asarray(box.centre())
        src = mesh.require_inside(tuple(centre))
        rcv = mesh.require_inside(tuple(centre + [0.0, 0.0, 3 * dx]))
        source = HardSource(
            node_idx=jnp.asarray(desc.flat_index(src), dtype=jnp.int32),
            signal=impulse_signal(steps, rectilinear_calibration_factor(
                dx, 400.0)))
        receiver = NodeReceiver(
            node_idx=jnp.asarray(desc.flat_index(rcv), dtype=jnp.int32))
        with jax.enable_x64(True):
            o32 = wgrun.run_waveguide_box(mesh.structure, mesh.box_spec,
                                          source, receiver, steps)
            o64 = wgrun.run_waveguide_box(mesh.structure, mesh.box_spec,
                                          source, receiver, steps,
                                          state_dtype=jnp.float64)
            p32 = np.asarray(o32["outputs"])
            p64 = np.asarray(o64["outputs"])
        assert bool(o32["stable"]) and bool(o64["stable"])
        assert p64.dtype == np.float32     # field stays f32; state widens
        # the run must actually ring: a late-window signal to drift in
        assert np.abs(p64[-steps // 10:]).max() > 0.0
        rel = np.abs(p32 - p64).max() / np.abs(p64).max()
        assert rel < 2e-3


class TestBoundaryFitArtifact:
    def test_sweep_bounds(self):
        s = json.load(open(os.path.join(ROOT, "BOUNDARY_FIT_r04.json")))
        assert s["materials"] >= 16 and len(s["mesh_rates"]) >= 3
        assert s["worst_reflectance"] <= 1.0 + 1e-6, "passivity"
        assert s["worst_inband_r_error"] <= s["error_bound"] == 0.02
        for row in s["rows"]:
            assert row["max_reflectance"] <= 1.0 + 1e-6, row

    def test_sweep_is_reproducible_spot(self):
        """Re-fit one material at one rate and compare to the committed
        row (guards against silent drift in the fit pipeline)."""
        import jax
        jax.config.update("jax_platforms", "cpu")
        from wayverb_tpu.combined.model import MATERIAL_PRESETS
        from wayverb_tpu.signal.multiband import band_centres
        from wayverb_tpu.waveguide import boundary as bdry
        s = json.load(open(os.path.join(ROOT, "BOUNDARY_FIT_r04.json")))
        row = s["rows"][0]
        preset = MATERIAL_PRESETS[0]
        assert row["material"] == preset.name
        absorption = np.asarray(preset.absorption, dtype=np.float64)
        fs = row["mesh_rate_hz"]
        coeffs = bdry.compute_boundary_coefficients(absorption, fs)
        centres = np.asarray(band_centres(8))
        in_band = centres < fs / 2 * 0.9
        got = bdry.reflectance_response(coeffs, centres[in_band] / (fs / 2))
        target = np.sqrt(np.clip(1 - absorption, 0, 1))[in_band]
        err = float(np.max(np.abs(got - target)))
        np.testing.assert_allclose(err, row["max_inband_r_error"],
                                   rtol=1e-5, atol=1e-7)
