"""The hybrid engine: one source–receiver pair, all three solvers, combined.

Flow (parity: reference ``combined/engine.cpp:90-188`` + ``full_run.h``):
 1. build the waveguide mesh for the scene (voxelise + classify + fit
    boundary filters),
 2. run the ray tracer (stochastic histogram + traced image-source paths +
    direct line-of-sight),
 3. run the waveguide for the duration the stochastic tail indicates,
 4. per capsule: postprocess both solvers to the output rate, crossover at
    the waveguide cutoff, window to the direct arrival.

New vs the reference: everything after mesh setup is differentiable, and
the per-step host round-trips are gone (both solvers are single scans).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from wayverb_tpu.core.attenuator import Hrtf, Microphone, Null
from wayverb_tpu.core.environment import Environment
from wayverb_tpu.core.geometry import Box, TriangleSoup, box_scene
from wayverb_tpu.core.impulse import Impulses, apply_distance_pressure
from wayverb_tpu.core.surfaces import Surface
from wayverb_tpu.combined.postprocess import (crossover_filter,
                                              window_direct_arrival)
from wayverb_tpu.imagesource import exact
from wayverb_tpu.imagesource.postprocess import postprocess as is_postprocess
from wayverb_tpu.imagesource.tree import find_image_source_impulses
from wayverb_tpu.raytracer import stochastic, tracer
from wayverb_tpu.waveguide import run as wgrun
from wayverb_tpu.waveguide.descriptor import (compute_sampling_frequency,
                                              grid_spacing)
from wayverb_tpu.waveguide.postprocess import BandpassBand
from wayverb_tpu.waveguide.postprocess import postprocess as wg_postprocess


@dataclasses.dataclass(frozen=True)
class RaytracerParameters:
    """Parity: raytracer/simulation_parameters.h:9-34."""

    rays: int = 1 << 16
    maximum_image_source_order: int = 4
    receiver_radius: float = 0.1
    histogram_sample_rate: float = 1000.0
    max_time: float = 4.0


@dataclasses.dataclass(frozen=True)
class WaveguideParameters:
    """Parity: waveguide/simulation_parameters.h — ``bands=1`` is the
    single-band mode; >1 reruns the mesh per band with flat coefficients
    (multiple_band_constant_spacing_parameters)."""

    cutoff: float = 500.0
    usable_portion: float = 0.6
    bands: int = 1

    @property
    def sample_rate(self) -> float:
        return compute_sampling_frequency(self.cutoff, self.usable_portion)


@dataclasses.dataclass
class CombinedResults:
    """Raw solver outputs for one src–rcv pair, before capsule rendering."""

    image_source: Impulses            # includes direct; 1/r applied
    stochastic_histogram: Any         # (bins, 20, 9, bands)
    histogram_sample_rate: float
    waveguide_bands: List[BandpassBand]
    room_volume: float
    source: Any
    receiver: Any
    environment: Environment


class Engine:
    """Reusable per-scene state: mesh + materials (reference engine ctor)."""

    def __init__(self, soup: TriangleSoup, surfaces: Surface,
                 waveguide_params: WaveguideParameters = WaveguideParameters(),
                 environment: Environment = Environment(),
                 scene_box: Optional[Box] = None,
                 device_mesh=None):
        """``device_mesh``: optional 1-D jax.sharding.Mesh — the waveguide
        leg then runs on the sharded fused solver (parallel.box_sharded
        for shoeboxes, parallel.general_sharded for loaded geometry),
        with the grid x dim padded to divide over the mesh."""
        self.soup = soup
        self.surfaces = surfaces
        self.environment = environment
        self.waveguide_params = waveguide_params
        self.device_mesh = device_mesh
        spacing = grid_spacing(environment.speed_of_sound,
                               1.0 / waveguide_params.sample_rate)
        align = None
        if device_mesh is not None:
            n = int(np.prod(list(device_mesh.shape.values())))
            align = (n, 1, 1)
        self.mesh = wgrun.compute_mesh(
            soup, np.asarray(surfaces.absorption), spacing,
            waveguide_params.sample_rate, scene_box=scene_box, align=align)
        # voxel DDA, or the dense broadcast for tiny scenes
        from wayverb_tpu.raytracer.accel import auto_accel
        self.ray_grid = auto_accel(soup)

    def run(self, source, receiver, key,
            raytracer_params: RaytracerParameters = RaytracerParameters(),
            waveguide_time: Optional[float] = None,
            time_quantum: float = 0.1,
            state_callback=None) -> CombinedResults:
        """``waveguide_time``: fix the waveguide duration statically and the
        whole run jits without data-dependent recompiles; when None it is
        derived from the trace (one host sync) and rounded UP to
        ``time_quantum`` so near-identical scenes reuse the compiled
        waveguide scan instead of recompiling per duration.

        ``state_callback(state)``: optional per-phase hook mirroring the
        reference engine's state enum (``engine.h:38-48``:
        starting_raytracer/running_raytracer/…); callers use it for
        progress UIs and COOPERATIVE CANCELLATION between phases (raise
        from the callback to abort, the reference ``keep_going``
        contract)."""
        def phase(name):
            if state_callback is not None:
                state_callback(name)

        env = self.environment
        min_absorption = float(jnp.min(self.surfaces.absorption))
        depth = tracer.compute_optimum_reflection_number(
            max(min_absorption, 1e-3))
        # depth is a static scan length (recompile per value); round UP to
        # a multiple of 8 so small absorption edits reuse the compiled
        # bounce scan — extra bounces only tighten the energy tail
        # (compute_optimum_reflection_number is a sufficiency bound)
        depth = -(-depth // 8) * 8

        phase("running_raytracer")
        trace_res = tracer.trace_jit(
            self.soup, self.surfaces, source, receiver, key,
            num_rays=raytracer_params.rays, depth=depth,
            max_time=raytracer_params.max_time, environment=env,
            receiver_radius=raytracer_params.receiver_radius,
            histogram_sample_rate=raytracer_params.histogram_sample_rate,
            max_image_source_order=(
                raytracer_params.maximum_image_source_order),
            accel=self.ray_grid)

        phase("finding_image_sources")
        image_source = find_image_source_impulses(
            trace_res.triangle_history, self.soup, self.surfaces,
            source, receiver,
            max_order=raytracer_params.maximum_image_source_order)
        direct = exact.get_direct(
            source, receiver, self.soup,
            bands=self.surfaces.absorption.shape[-1])
        image_source = image_source.concatenate(direct)
        image_source = apply_distance_pressure(
            image_source, env.acoustic_impedance)

        if waveguide_time is not None:
            max_stochastic_time = waveguide_time
        else:
            import math
            max_stochastic_time = time_quantum * math.ceil(
                trace_res.max_time() / time_quantum)

        phase("running_waveguide")
        if self.waveguide_params.bands > 1:
            bands = wgrun.canonical_multiband(
                self.mesh, np.asarray(self.surfaces.absorption), source,
                receiver, max_stochastic_time,
                self.waveguide_params.bands, env,
                device_mesh=self.device_mesh)
        else:
            if self.device_mesh is not None and \
                    self.mesh.box_spec is not None:
                from wayverb_tpu.parallel.box_sharded import \
                    canonical_sharded
                wg_out = canonical_sharded(self.mesh, source, receiver,
                                           max_stochastic_time,
                                           self.device_mesh, env)
            elif self.device_mesh is not None:
                # general (loaded OBJ/PLY/STL) scenes shard too (r4):
                # fused weight-code solver under shard_map
                from wayverb_tpu.parallel.general_sharded import \
                    canonical_general_sharded
                wg_out = canonical_general_sharded(
                    self.mesh, source, receiver, max_stochastic_time,
                    self.device_mesh, env)
            else:
                wg_out = wgrun.canonical(self.mesh, source, receiver,
                                         max_stochastic_time, env)
            bands = [BandpassBand(
                pressure=wg_out.pressure, intensity=wg_out.intensity,
                sample_rate=wg_out.sample_rate,
                valid_hz=(0.0, self.waveguide_params.cutoff))]

        phase("finishing")
        return CombinedResults(
            image_source=image_source,
            stochastic_histogram=trace_res.histogram,
            histogram_sample_rate=trace_res.histogram_sample_rate,
            waveguide_bands=bands,
            room_volume=self.mesh.room_volume,
            source=jnp.asarray(source, dtype=jnp.float32),
            receiver=jnp.asarray(receiver, dtype=jnp.float32),
            environment=env,
        )


def render(results: CombinedResults, method, output_sample_rate: float,
           key) -> jnp.ndarray:
    """Capsule rendering: combined broadband IR at the output rate.

    Parity: ``combined/postprocess.h:72-136``.
    """
    env = results.environment

    head = is_postprocess(
        results.image_source, method, results.receiver,
        env.speed_of_sound, output_sample_rate)
    tail = stochastic.postprocess(
        results.stochastic_histogram, results.histogram_sample_rate, method,
        results.room_volume, env, output_sample_rate, key)
    n = max(head.shape[-1], tail.shape[-1])
    geometric = jnp.zeros(n).at[:head.shape[-1]].add(head) \
        .at[:tail.shape[-1]].add(tail)

    low = wg_postprocess(results.waveguide_bands, method,
                         env.acoustic_impedance, output_sample_rate)

    cutoff = max(hi for _, hi in
                 [b.valid_hz for b in results.waveguide_bands])
    combined = crossover_filter(low, geometric,
                                cutoff / output_sample_rate)
    return window_direct_arrival(
        combined, results.source, results.receiver, output_sample_rate,
        env.speed_of_sound)


def render_all(results: CombinedResults, methods: Sequence, key,
               output_sample_rate: float = 44100.0,
               normalize: bool = True):
    """Render every capsule; optionally peak-normalize jointly
    (reference complete_engine, threaded_engine.cpp:241-260)."""
    outs = []
    for i, method in enumerate(methods):
        outs.append(render(results, method, output_sample_rate,
                           jax.random.fold_in(key, i)))
    n = max(o.shape[-1] for o in outs)
    outs = [jnp.zeros(n).at[:o.shape[-1]].set(o) for o in outs]
    stacked = jnp.stack(outs)
    if normalize:
        peak = jnp.max(jnp.abs(stacked))
        stacked = stacked / jnp.maximum(peak, 1e-12)
    return stacked
