"""The CPU-reachable parts of chip_smoke.py and bench.py: refusal off the
card, the contract's last line, phase selection, the nvidia-smi line, the
compile-cache rule, the bandwidth table, and the small helpers the on-card
checks rely on.  The card itself is exercised by the ``gpu``-marked test."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


class TestRefusal:
    def test_refuses_cpu_before_any_phase(self, monkeypatch, capsys):
        ran = []
        monkeypatch.setattr(chip_smoke, "PHASES", {
            k: (lambda k=k: ran.append(k)) for k in chip_smoke.PHASES})
        from wayverb_tpu.utils import card
        monkeypatch.setattr(card, "card_line", lambda: ran.append(
            "nvidia-smi"))
        assert chip_smoke.main([]) != 0
        assert ran == []
        assert capsys.readouterr().out == ""

    def test_bench_refuses_cpu(self, capsys):
        assert bench.main([]) != 0
        assert capsys.readouterr().out == ""


class TestContract:
    @pytest.mark.parametrize("count", [1, 4])
    def test_last_line_format(self, count):
        dev = SimpleNamespace(platform="gpu",
                              device_kind="NVIDIA H100 80GB HBM3")
        line = chip_smoke.final_line([dev] * count)
        assert "\n" not in line
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": count}}

    @pytest.mark.parametrize("four_cards,phases", [
        (False, ("box", "grad", "hall", "rays")),
        (True, ("sharded",))])
    def test_phase_selection(self, four_cards, phases):
        assert chip_smoke.phases_for(four_cards) == phases
        assert set(phases) <= set(chip_smoke.PHASES)

    @pytest.mark.parametrize("text,want", [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         ("NVIDIA H100 80GB HBM3", "700.00 W")),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, "
         "700.00 W\n", ("NVIDIA H100 80GB HBM3", "500.00 W")),
        ("  Some, Card, Name, [N/A]  ", ("Some, Card, Name", "[N/A]")),
    ])
    def test_parse_smi_line(self, text, want):
        from wayverb_tpu.utils.card import parse_smi_line
        assert parse_smi_line(text) == want

    @pytest.mark.parametrize("text", ["", "no comma here", "name, "])
    def test_parse_smi_line_rejects(self, text):
        from wayverb_tpu.utils.card import parse_smi_line
        with pytest.raises(ValueError):
            parse_smi_line(text)


class TestCompileCache:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        import jax
        from wayverb_tpu.utils import compile_cache
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        assert compile_cache.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_checkout_jax_cache(self, monkeypatch):
        import jax
        from wayverb_tpu.utils import compile_cache
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = compile_cache.configure_compile_cache()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestBandwidthTable:
    def test_h100_maps_to_datasheet_bandwidth(self):
        assert bench.hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12

    @pytest.mark.parametrize("kind", ["cpu", "Unknown Accelerator",
                                      "NVIDIA A100-SXM4-80GB"])
    def test_unknown_device_raises(self, kind):
        with pytest.raises(ValueError):
            bench.hbm_bandwidth(kind)


class TestHelpers:
    def test_max_rel(self):
        assert chip_smoke.max_rel([1.0, 2.0], [1.0, 2.0]) == 0.0
        assert chip_smoke.max_rel([1.0, 2.5], [1.0, 2.0]) == \
            pytest.approx(0.25)

    def test_direct_peak_ignores_low_band(self):
        """A large, early low-frequency bump must not move the detected
        direct sound, which is a band-limited impulse at ``expected``."""
        fs, n, expected = 44100.0, 4096, 1013.4
        t = np.arange(n)
        ir = 0.2 * np.sinc(t - expected)
        ir += 3.0 * np.exp(-0.5 * ((t - 990) / 60.0) ** 2)   # < 300 Hz
        assert chip_smoke.direct_peak(ir, fs, expected, 2000.0) == 1013

    def test_first_arrival(self):
        p = np.zeros(100)
        p[30:] = np.linspace(1.0, 0.0, 70)
        p[20] = 0.01
        assert chip_smoke.first_arrival(p) == 30

    def test_import_package_is_the_checkout(self):
        pkg = chip_smoke.import_package()
        assert os.path.dirname(os.path.dirname(pkg.__file__)) == ROOT


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_name):
    """The whole smoke on the card, in a child process (this process is
    pinned to the CPU and never opens the card)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
