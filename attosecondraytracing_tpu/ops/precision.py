"""Precision policy for the tracer.

The reference (ART) traces everything in float64 on CPU. Accelerators are
fast in float32, so the default trace dtype here is float32, made
accurate by two design choices (see SURVEY.md §7):

* all intersection math happens in the *element-local frame* (the reference's
  own re-centering, ART/ModuleProcessing.py:288-295), which keeps coordinates
  small and well-conditioned;
* every closed-form root is polished with a few Newton iterations on a
  well-conditioned distance-like residual, and optical path length is
  accumulated with Kahan-compensated summation.

For parity tests against the NumPy reference, run on CPU with
``jax.config.update("jax_enable_x64", True)`` and pass float64 arrays; all ops
are dtype-generic and simply follow their inputs.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

#: Speed of light in mm/s (the reference uses mm everywhere;
#: ART/ModuleDetector.py:21).
LIGHT_SPEED_MM_S = 299792458000.0

#: Minimum ray-advance distance for a hit to count as "in front of" the ray
#: (reference epsilon: ART/ModuleGeometry.py:110-134 uses 1e-12; that is below
#: float32 resolution at mm scales, so we use a small but f32-safe epsilon).
T_EPS = 1e-9


def env_dtype():
    """Explicit bundle-dtype override from ``ART_TPU_DTYPE`` (None when the
    variable is unset — sources then build float64 NumPy bundles, which the
    backend casts to its native float at jit entry). Consumed by
    :func:`attosecondraytracing_tpu.ops.bundle.make_bundle`, i.e. by every
    source factory."""
    name = os.environ.get("ART_TPU_DTYPE")
    return None if not name else jnp.dtype(name)


def default_dtype():
    """Trace dtype: float32 unless overridden via ART_TPU_DTYPE."""
    return env_dtype() or jnp.dtype("float32")
