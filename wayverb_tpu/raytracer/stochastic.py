"""Late-field synthesis: directional energy histogram → pressure tail.

Pipeline (parity: reference ``raytracer/stochastic/postprocessing.{h,cpp}``
and ``stochastic/postprocess.h``):
 1. attenuate the 20×9 directional histogram per direction bin by the
    capsule's squared gain (energy domain) and sum → (bins, bands),
 2. synthesize a Poisson dirac sequence with rate min(4πc³t²/V, 10⁴)
    starting at t₀ = (2ln2/rate_constant)^{1/3},
 3. weight each histogram bin's worth of sequence samples so its energy
    matches the histogram (pressure = √(E/Σδ²·Z)),
 4. multiband filter + mixdown.

Vectorized: the dirac sequence is per-sample Bernoulli thinning of the
inhomogeneous Poisson process (same statistics as the reference's
inter-arrival sampling, but static-shaped and vectorized), and the binwise
weighting is a segment-sum.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp

from wayverb_tpu.core.attenuator import Hrtf, Microphone, Null
from wayverb_tpu.core.environment import Environment
from wayverb_tpu.core.pressure import intensity_to_pressure
from wayverb_tpu.signal.multiband import multiband_filter_and_mixdown

MAX_EVENT_RATE = 10000.0


def constant_mean_event_occurrence(speed_of_sound: float,
                                   room_volume: float) -> float:
    return 4.0 * math.pi * speed_of_sound ** 3 / room_volume


def mean_event_occurrence(constant, t):
    return jnp.minimum(constant * t * t, MAX_EVENT_RATE)


def t0(constant: float) -> float:
    return (2.0 * math.log(2.0) / constant) ** (1.0 / 3.0)


def generate_dirac_sequence(key, speed_of_sound: float, room_volume: float,
                            sample_rate: float, max_time: float):
    """±1 dirac train from the inhomogeneous Poisson model, (N,) float."""
    constant = constant_mean_event_occurrence(speed_of_sound, room_volume)
    n = int(math.ceil(max_time * sample_rate))
    t = jnp.arange(n, dtype=jnp.float32) / sample_rate
    rate = mean_event_occurrence(constant, t)
    p_event = 1.0 - jnp.exp(-rate / sample_rate)
    k1, k2 = jax.random.split(key)
    events = (jax.random.uniform(k1, (n,)) < p_event) & (t >= t0(constant))
    signs = jax.random.rademacher(k2, (n,), dtype=jnp.float32)
    return jnp.where(events, signs, 0.0)


def bin_pointing(num_az: int = 20, num_el: int = 9):
    """(az, el, 3) centre directions of the histogram's angle bins."""
    az = jnp.arange(num_az) * (2.0 * jnp.pi / num_az)
    el = (jnp.arange(num_el) - num_el // 2) * (jnp.pi / num_el)
    azg, elg = jnp.meshgrid(az, el, indexing="ij")
    # inverse of orientation.azimuth/elevation: az = atan2(x, z), el = asin(y)
    return jnp.stack([
        jnp.cos(elg) * jnp.sin(azg),
        jnp.sin(elg),
        jnp.cos(elg) * jnp.cos(azg),
    ], axis=-1)


def attenuate_histogram(directional_hist, method):
    """(bins, az, el, bands) → (bins, bands) with squared capsule gains."""
    if isinstance(method, Null):
        return jnp.sum(directional_hist, axis=(1, 2))
    pointing = bin_pointing(directional_hist.shape[1],
                            directional_hist.shape[2])     # (az, el, 3)
    att = method.attenuation(pointing)                     # (az,el) or +bands
    if att.ndim == 2:
        att = att[..., None]
    factor = att * att                                     # energy domain
    return jnp.sum(directional_hist * factor[None], axis=(1, 2))


def weight_sequence(histogram, histogram_sr: float, sequence,
                    sequence_sr: float, acoustic_impedance: float):
    """Scale the dirac train so each histogram bin carries its energy.

    histogram: (bins, bands); sequence: (N,).  Returns (N, bands).
    """
    bins = histogram.shape[0]
    n = sequence.shape[0]
    sample_bin = jnp.floor(
        jnp.arange(n) * histogram_sr / sequence_sr).astype(jnp.int32)
    sq = jax.ops.segment_sum(sequence * sequence, sample_bin,
                             num_segments=bins)            # (bins,)
    scale = jnp.where(
        sq[:, None] > 0,
        intensity_to_pressure(
            histogram / jnp.maximum(sq[:, None], 1e-30), acoustic_impedance),
        0.0)                                               # (bins, bands)
    return sequence[:, None] * scale[sample_bin]


def postprocess(directional_hist, histogram_sr: float, method, room_volume,
                environment: Environment, output_sample_rate: float, key):
    """Directional histogram → broadband pressure tail at the output rate."""
    summed = attenuate_histogram(directional_hist, method)
    max_time = summed.shape[0] / histogram_sr
    sequence = generate_dirac_sequence(
        key, environment.speed_of_sound, float(room_volume),
        output_sample_rate, max_time)
    weighted = weight_sequence(summed, histogram_sr, sequence,
                               output_sample_rate,
                               environment.acoustic_impedance)
    return multiband_filter_and_mixdown(weighted.T, output_sample_rate)
