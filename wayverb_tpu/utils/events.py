"""Progress events and phase timing.

The reference wires an observer/event system through the engine
(``utilities/event.h``; 9-state enum in ``combined/engine.h:38-48``) for
GUI progress and live visualisation, but has no timers or kernel profiling.
Here: a minimal typed event hub, wall-clock phase timing, and a
``jax.profiler`` trace helper for device timelines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

# engine states, mirroring the reference enum
STATES = (
    "idle",
    "initialising",
    "starting_raytracer",
    "running_raytracer",
    "finishing_raytracer",
    "starting_waveguide",
    "running_waveguide",
    "finishing_waveguide",
    "postprocessing",
)


class EventHub:
    """connect/disconnect + fire, like the reference's event<Ts...>."""

    def __init__(self):
        self._listeners: Dict[str, List[Callable]] = {}

    def connect(self, name: str, fn: Callable) -> Callable:
        self._listeners.setdefault(name, []).append(fn)
        return fn

    def disconnect(self, name: str, fn: Callable) -> None:
        if name in self._listeners and fn in self._listeners[name]:
            self._listeners[name].remove(fn)

    def fire(self, name: str, *args) -> None:
        for fn in self._listeners.get(name, []):
            fn(*args)


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock per phase; attach to an EventHub or use the
    contextmanager directly."""

    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{name}: {t:.3f}s ({self.counts[name]}x)"
                 for name, t in sorted(self.timings.items(),
                                       key=lambda kv: -kv[1])]
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a jax.profiler trace (view in TensorBoard / Perfetto)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def iter_pressure_fields(mesh, source, receiver, num_steps: int,
                         every: int = 8):
    """Yield (step, pressure_field, outputs) snapshots during a run.

    The chunked runner surfaces the full field between chunks — the
    parity for the reference's live wavefront visualisation stream
    (``engine.h:110-117``).
    """
    from wayverb_tpu.waveguide import checkpoint as ck

    state = ck.initial_state(mesh, receiver)
    done = 0
    while done < num_steps:
        n = min(every, num_steps - done)
        state, outputs = ck.run_chunk(mesh, source, receiver, state, n)
        done += n
        yield done, state.current, outputs
