"""Structure-of-arrays ray bundle (the batched replacement for ART's Ray objects).

The reference models each ray as a Python object with validating setters
(ART/ModuleOpticalRay.py) and drops rays from Python lists when they miss an
optic (ART/ModuleMirror.py:932-938). Here a bundle of N rays is a pytree of
arrays with static shapes; "dropped" rays simply carry ``alive=False`` and are
excluded from all statistics by weighting. The ray's ``number`` is its array
index (stable through the whole trace, so cross-element ray identity is free).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class RayBundle(NamedTuple):
    """SoA bundle of N rays.

    Attributes
    ----------
    p : (N, 3) ray origin points [mm]
    d : (N, 3) unit direction vectors
    opl : (N,) accumulated optical path length [mm] (reference: sum(Ray.path))
    opl_c : (N,) Kahan compensation term for ``opl`` (zeros in float64 mode)
    alive : (N,) bool — False once a ray missed an optic / was blocked
    intensity : (N,) fluence fraction carried by the ray (arb. u.)
    incidence : (N,) incidence angle [rad] on the *last* optic hit
    wavelength : () wavelength [mm] (uniform across the bundle, as in ART)
    """

    p: jax.Array
    d: jax.Array
    opl: jax.Array
    opl_c: jax.Array
    alive: jax.Array
    intensity: jax.Array
    incidence: jax.Array
    wavelength: jax.Array

    @property
    def n_rays(self) -> int:
        return self.p.shape[-2]

    def weights(self):
        """Statistics weights: intensity where alive, else 0."""
        return jnp.where(self.alive, self.intensity, 0.0)


def make_bundle(points, directions, wavelength=None, intensity=None, dtype=None):
    """Build a RayBundle from (N,3) points and direction vectors.

    Directions are normalized (the reference Ray.vector setter does the same,
    ART/ModuleOpticalRay.py:85-90).

    Construction stays in host NumPy unless the inputs are already device
    arrays: scene building is host-side work, and eager per-op device
    dispatch is expensive. The single
    host->device transfer happens when the bundle enters a jitted trace.
    """
    if dtype is None:
        from .precision import env_dtype

        dtype = env_dtype()  # explicit ART_TPU_DTYPE override, else input dtype
    on_device = isinstance(points, jax.Array) or isinstance(directions, jax.Array)
    xp = jnp if on_device else np
    p = xp.asarray(points, dtype=dtype)
    dtype = p.dtype
    d = xp.asarray(directions, dtype=dtype)
    d = d / xp.linalg.norm(d, axis=-1, keepdims=True)
    n = p.shape[0]
    if intensity is None:
        intensity = xp.ones((n,), dtype=dtype)
    else:
        intensity = xp.asarray(intensity, dtype=dtype)
    wl = xp.asarray(0.0 if wavelength is None else wavelength, dtype=dtype)
    return RayBundle(
        p=p,
        d=d,
        opl=xp.zeros((n,), dtype=dtype),
        opl_c=xp.zeros((n,), dtype=dtype),
        alive=xp.ones((n,), dtype=bool),
        intensity=intensity,
        incidence=xp.zeros((n,), dtype=dtype),
        wavelength=wl,
    )


def total_path(bundle: RayBundle):
    """Accurate accumulated OPL.

    ``kahan_add`` keeps the classic-Kahan compensation ``c = (t - s) - y``,
    i.e. the rounding *excess* already folded into the running sum, so the
    refined value is ``opl - opl_c``. (Adding instead of subtracting doubles
    the last-step rounding error — the round-1 sign bug.)
    """
    return bundle.opl - bundle.opl_c


def to_host(bundle: RayBundle):
    """Bring a bundle to host memory as a NamedTuple of NumPy arrays."""
    return RayBundle(*(np.asarray(x) for x in bundle))


def compact_host(bundle: RayBundle):
    """Drop dead rays (host-side, dynamic shape) — for plotting/export, where
    reference-identical 'survivors only' lists are wanted. Returns (bundle,
    original_indices)."""
    b = to_host(bundle)
    idx = np.nonzero(b.alive)[0]
    return RayBundle(
        p=b.p[idx],
        d=b.d[idx],
        opl=b.opl[idx],
        opl_c=b.opl_c[idx],
        alive=b.alive[idx],
        intensity=b.intensity[idx],
        incidence=b.incidence[idx],
        wavelength=b.wavelength,
    ), idx


def pad_bundle(bundle: RayBundle, n_total: int):
    """Pad a bundle with dead rays up to ``n_total`` (for even sharding)."""
    n = bundle.n_rays
    if n == n_total:
        return bundle
    extra = n_total - n
    if extra < 0:
        raise ValueError(f"cannot pad bundle of {n} rays down to {n_total}")

    def pad(x, fill):
        if x.ndim == 0:
            return x
        pad_block = jnp.full((extra,) + x.shape[1:], fill, dtype=x.dtype)
        return jnp.concatenate([x, pad_block], axis=0)

    # dead padding rays point along +z so the math stays finite
    d_fill = jnp.zeros((extra, 3), dtype=bundle.d.dtype).at[:, 2].set(1.0)
    return RayBundle(
        p=pad(bundle.p, 0.0),
        d=jnp.concatenate([bundle.d, d_fill], axis=0),
        opl=pad(bundle.opl, 0.0),
        opl_c=pad(bundle.opl_c, 0.0),
        alive=pad(bundle.alive, False),
        intensity=pad(bundle.intensity, 0.0),
        incidence=pad(bundle.incidence, 0.0),
        wavelength=bundle.wavelength,
    )
