"""Sample-rate conversion via windowed-sinc interpolation.

Vectorized replacement for the reference's libsamplerate call
(``waveguide/src/config.cpp:29-56``): a Kaiser-windowed sinc interpolator as
one batched gather + weighted reduction (static shapes, differentiable).
Matches the reference's level convention of scaling the output by
``in_sr / out_sr``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def _kaiser_beta(att_db: float) -> float:
    if att_db > 50.0:
        return 0.1102 * (att_db - 8.7)
    if att_db >= 21.0:
        return 0.5842 * (att_db - 21.0) ** 0.4 + 0.07886 * (att_db - 21.0)
    return 0.0


def _i0(x):
    return jnp.i0(x)


def resample(signal, in_sr: float, out_sr: float, taps: int = 64,
             att_db: float = 80.0):
    """Resample (..., n) from ``in_sr`` to ``out_sr``.

    Output length = floor(n · out_sr / in_sr); output is scaled by
    ``in_sr/out_sr`` (reference level convention, config.cpp:49-53).
    """
    if in_sr == out_sr:
        return signal
    ratio = out_sr / in_sr
    n = signal.shape[-1]
    out_n = int(n * ratio)
    cutoff = min(1.0, ratio)  # normalized to in-rate nyquist
    beta = _kaiser_beta(att_db)

    j = jnp.arange(out_n, dtype=jnp.float32)
    t = j / ratio                                   # position in input samples
    base = jnp.floor(t).astype(jnp.int32)
    frac = t - base
    k = jnp.arange(-(taps // 2) + 1, taps // 2 + 1, dtype=jnp.int32)  # (K,)
    idx = base[:, None] + k[None, :]                                  # (O, K)
    valid = (idx >= 0) & (idx < n)
    idx_c = jnp.clip(idx, 0, n - 1)
    x = frac[:, None] - k[None, :].astype(jnp.float32)                # (O, K)
    window_arg = jnp.clip(x / (taps / 2.0), -1.0, 1.0)
    window = _i0(beta * jnp.sqrt(1.0 - window_arg ** 2)) / _i0(
        jnp.asarray(beta))
    weights = cutoff * jnp.sinc(cutoff * x) * window * valid
    gathered = signal[..., idx_c]                                     # (...,O,K)
    out = jnp.sum(gathered * weights, axis=-1)
    return out / ratio
