"""IR assembly: deposit impulse batches into time histograms.

Two deposit modes (parity: reference ``raytracer/histogram.h``):
 * dirac — add the whole volume into one bin (energy histograms),
 * windowed sinc — fu2015 §2.2.2 band-limited deposit over a 400-sample
   Hann-windowed sinc (pressure IRs from the image-source solver).

Vectorized: one scatter-add over an (N, W) window instead of the reference's
per-impulse CPU loops; out-of-range samples drop via scatter mode, and
masked impulses (zero volume) contribute nothing, keeping shapes static
under jit.  Differentiable in volumes and (for sinc) in times.
"""

from __future__ import annotations

import jax.numpy as jnp

SINC_WIDTH = 400  # samples — reference histogram.h:107


def dirac_histogram(times, volumes, sample_rate, num_bins: int):
    """Scatter volumes (N, ...) into bins (num_bins, ...) by floor(t·sr).

    Out-of-range impulses are dropped.
    """
    idx = jnp.floor(times * sample_rate).astype(jnp.int32)
    out_shape = (num_bins,) + volumes.shape[1:]
    out = jnp.zeros(out_shape, dtype=volumes.dtype)
    return out.at[idx].add(volumes, mode="drop")


def sinc_histogram(times, volumes, sample_rate, num_bins: int,
                   width: int = SINC_WIDTH):
    """Band-limited deposit: Hann-windowed sinc of ``width`` samples.

    times (N,), volumes (N, bands) → (num_bins, bands).
    """
    centre = times * sample_rate                        # (N,)
    start = jnp.floor(centre - width / 2).astype(jnp.int32)
    k = jnp.arange(width + 1, dtype=jnp.int32)          # (W,)
    j = start[:, None] + k[None, :]                     # (N, W)
    rel = j.astype(volumes.dtype) - centre[:, None]
    envelope = 0.5 * (1.0 + jnp.cos(2.0 * jnp.pi * rel / width))
    weights = envelope * jnp.sinc(rel)                  # (N, W)
    vals = volumes[:, None, :] * weights[:, :, None]    # (N, W, bands)
    out = jnp.zeros((num_bins,) + volumes.shape[1:], dtype=volumes.dtype)
    return out.at[j.reshape(-1)].add(
        vals.reshape(-1, *volumes.shape[1:]), mode="drop")
