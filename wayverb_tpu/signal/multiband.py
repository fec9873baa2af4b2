"""Multiband zero-phase FFT filtering: band edges, crossover envelopes,
per-band filtering and mixdown.

The whole pipeline is pure JAX (jnp.fft), differentiable, and batched over a
``bands`` axis — one FFT pass filters all 8 bands at once instead of the
reference's per-band serial FFT.

Parity: reference ``frequency_domain/envelope.h`` + ``src/envelope.cpp``
(antoni2010 eq. 19/20 band-edge envelopes, logarithmic band edges),
``frequency_domain/multiband_filter.h`` (FFT length = 4·next_pow2, per-band
bandpass + sum), ``hrtf/multiband.h:11`` (audible range 20 Hz – 20 kHz,
8 bands, overlap 1), ``core/mixdown.h:11-24``.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

AUDIBLE_RANGE = (20.0, 20000.0)
DEFAULT_BANDS = 8


def band_edge_frequency(band, bands, lo, hi):
    """Logarithmically spaced edge ``band`` of ``bands`` bands over [lo, hi]."""
    return lo * (hi / lo) ** (band / bands)


def band_edges(bands: int = DEFAULT_BANDS, lo=AUDIBLE_RANGE[0],
               hi=AUDIBLE_RANGE[1]):
    """(bands+1,) edges in Hz.  Pure numpy: this is setup-path math, and on
    a remote-TPU backend every tiny jnp array costs a round trip."""
    import numpy as _np
    return _np.asarray(
        [band_edge_frequency(i, bands, lo, hi) for i in range(bands + 1)])


def band_centres(bands: int = DEFAULT_BANDS, lo=AUDIBLE_RANGE[0],
                 hi=AUDIBLE_RANGE[1]):
    """(bands,) geometric band centres in Hz (numpy, setup path)."""
    import numpy as _np
    return _np.asarray([
        band_edge_frequency(2 * i + 1, 2 * bands, lo, hi)
        for i in range(bands)
    ])


def max_width_factor(lo, hi, step):
    base = (hi / lo) ** step
    return (base - 1.0) / (base + 1.0)


def width_factor(lo, hi, bands, overlap):
    """Relative crossover half-width shared by all edges (antoni2010)."""
    return max_width_factor(lo, hi, 1.0 / bands) * overlap


def _band_edge_impl(p, width, l: int):
    x = (p / width + 1.0) * 0.5
    for _ in range(l):
        x = jnp.sin(jnp.pi * x / 2.0)
    return x


def lower_band_edge(p, width, l: int = 0):
    """Rising crossover envelope: 0 below -width, 1 above +width (power)."""
    return jnp.square(jnp.sin(jnp.pi * _band_edge_impl(p, width, l) / 2.0))


def upper_band_edge(p, width, l: int = 0):
    return jnp.square(jnp.cos(jnp.pi * _band_edge_impl(p, width, l) / 2.0))


def compute_lopass_magnitude(frequency, edge, width, l: int = 0):
    """Smooth zero-phase lowpass magnitude (frequencies normalized alike)."""
    absolute_width = edge * width
    p = frequency - edge
    return jnp.where(
        frequency < edge - absolute_width, 1.0,
        jnp.where(frequency < edge + absolute_width,
                  upper_band_edge(p, absolute_width, l), 0.0))


def compute_hipass_magnitude(frequency, edge, width, l: int = 0):
    absolute_width = edge * width
    p = frequency - edge
    return jnp.where(
        frequency < edge - absolute_width, 0.0,
        jnp.where(frequency < edge + absolute_width,
                  lower_band_edge(p, absolute_width, l), 1.0))


def compute_bandpass_magnitude(frequency, lo, hi, width, l: int = 0):
    return compute_lopass_magnitude(frequency, hi, width, l) * \
        compute_hipass_magnitude(frequency, lo, width, l)


def best_fft_length(n: int) -> int:
    """4 × next power of two — extra padding so edge discontinuities decay."""
    return (1 << math.ceil(math.log2(max(n, 1)))) << 2


def _fft_freqs(bins: int, dtype):
    """Normalized frequency (0..0.5..) for rfft bins of a ``bins``-pt FFT."""
    return jnp.arange(bins // 2 + 1, dtype=dtype) / bins


def apply_zero_phase_magnitude(signal, mag_fn):
    """FFT → multiply rfft bins by ``mag_fn(normalized_freq)`` → IFFT.

    ``signal``: (..., n).  Returns the same length (zero-phase, no delay).
    On a GPU the transform is cuFFT, whose sums run in another order than
    the CPU's: results agree to f32 rounding of those sums (the usual FFT
    bound, of order log2(n)·2⁻²⁴ relative to the signal's norm), not
    bitwise.
    """
    n = signal.shape[-1]
    bins = best_fft_length(n)
    spectrum = jnp.fft.rfft(signal, n=bins, axis=-1)
    mags = mag_fn(_fft_freqs(bins, jnp.float32))
    filtered = jnp.fft.irfft(spectrum * mags, n=bins, axis=-1)
    return filtered[..., :n]


def multiband_params(sample_rate, bands: int = DEFAULT_BANDS, overlap=1.0):
    """Normalized band edges + width factor for the audible range.

    Matches ``hrtf_band_params(sample_rate)``: edges in cycles/sample.
    """
    edges = band_edges(bands) / sample_rate
    wf = width_factor(AUDIBLE_RANGE[0], AUDIBLE_RANGE[1], bands, overlap)
    return edges, wf


def multiband_filter(signals, sample_rate, bands: int = DEFAULT_BANDS,
                     l: int = 0):
    """Bandpass each band of (..., bands, n) with its own antoni2010 window.

    All bands share one FFT batch; returns filtered (..., bands, n).
    """
    edges, wf = multiband_params(sample_rate, bands)
    n = signals.shape[-1]
    bins = best_fft_length(n)
    freqs = _fft_freqs(bins, jnp.float32)                     # (F,)
    mags = compute_bandpass_magnitude(
        freqs[None, :], edges[:-1, None], edges[1:, None], wf, l)  # (bands, F)
    spectrum = jnp.fft.rfft(signals, n=bins, axis=-1)
    filtered = jnp.fft.irfft(spectrum * mags, n=bins, axis=-1)
    return filtered[..., :n]


def multiband_filter_and_mixdown(signals, sample_rate,
                                 bands: int = DEFAULT_BANDS):
    """8-band signal (..., bands, n) → bandpass each band → sum → (..., n).

    Parity: ``core/mixdown.h:11-24``.
    """
    return jnp.sum(multiband_filter(signals, sample_rate, bands), axis=-2)


def per_band_energy(signal, sample_rate, bands: int = DEFAULT_BANDS):
    """RMS energy of ``signal`` (..., n) measured in each band.

    Parity: ``frequency_domain::per_band_energy`` (normalized rms: the
    filtered energy divided by the integrated envelope area).
    """
    edges, wf = multiband_params(sample_rate, bands)
    n = signal.shape[-1]
    bins = best_fft_length(n)
    freqs = _fft_freqs(bins, jnp.float32)
    mags = compute_bandpass_magnitude(
        freqs[None, :], edges[:-1, None], edges[1:, None], wf)   # (bands, F)
    spectrum = jnp.fft.rfft(signal, n=bins, axis=-1)             # (..., F)
    weighted = spectrum[..., None, :] * mags                     # (..., b, F)
    # rfft bins represent two-sided spectrum except DC/nyquist; for the
    # energy *ratio* used here the one-sided sum matches the reference's
    # full-FFT sum up to that symmetric factor in both numerator and
    # denominator of each band.
    summed_squared = jnp.sum(jnp.abs(weighted) ** 2, axis=-1)
    integrated_envelope = jnp.sum(mags, axis=-1)
    return jnp.where(integrated_envelope > 0,
                     jnp.sqrt(summed_squared / integrated_envelope), 0.0)
