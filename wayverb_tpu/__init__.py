"""wayverb_tpu — a differentiable hybrid room-acoustics renderer in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference C++/OpenCL implementation (reuk/wayverb, see SURVEY.md):

* ``wayverb_tpu.core``        — scene/geometry/surface/acoustics math
* ``wayverb_tpu.signal``      — multiband FFT filters, IIR design, resampling
* ``wayverb_tpu.imagesource`` — deterministic early reflections (exact shoebox
                                lattice + arbitrary-geometry path validation)
* ``wayverb_tpu.raytracer``   — stochastic energy ray tracer (on-device scan)
* ``wayverb_tpu.waveguide``   — rectilinear FDTD mesh (fused stencil + scan)
* ``wayverb_tpu.combined``    — hybrid crossover engine
* ``wayverb_tpu.parallel``    — sharding: grid domain decomposition + ray DP

Unlike the reference, every solver is differentiable end-to-end and scales
over a ``jax.sharding.Mesh``.
"""

__version__ = "0.1.0"

from wayverb_tpu.core.environment import Environment

__all__ = ["Environment", "__version__"]
