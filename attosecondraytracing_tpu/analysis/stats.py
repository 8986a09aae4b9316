"""Bundle statistics (device-side, alive-mask aware).

Replaces the list-comprehension statistics of ART/ModuleProcessing.py:464-593
and ART/ModuleAnalysisAndPlots.py:28-129. The reference computes means/SDs
over *surviving* rays only (dead rays were physically removed from the
lists); here every reduction weights by the alive mask (and optionally the
ray intensities), which reproduces those semantics with static shapes and —
under ``jit`` over a sharded ray axis — turns into XLA ``psum`` collectives
for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.bundle import RayBundle
from ..ops.geometry import angle_between, kahan_add
from ..ops.precision import LIGHT_SPEED_MM_S


def _alive_w(bundle: RayBundle, intensity_weighted: bool = False):
    w = bundle.alive.astype(bundle.p.dtype)
    if intensity_weighted:
        w = w * bundle.intensity
    return w


def masked_mean(x, w, axis=None):
    wsum = jnp.sum(w, axis=axis)
    return jnp.sum(x * w, axis=axis) / jnp.maximum(wsum, 1e-30)


def std_scalar(x, w):
    """Weighted standard deviation of scalars (reference StandardDeviation /
    WeightedStandardDeviation, ART/ModuleProcessing.py:485-532)."""
    m = masked_mean(x, w)
    return jnp.sqrt(masked_mean((x - m) ** 2, w))


def std_points(xy, w):
    """sqrt(sum of per-axis variances) of 2D/3D point clouds — the
    reference's 'spot size SD' metric (ART/ModuleProcessing.py:485-507)."""
    m = masked_mean(xy, w[:, None], axis=0)
    var = masked_mean((xy - m) ** 2, w[:, None], axis=0)
    return jnp.sqrt(jnp.sum(var))


def central_direction(bundle: RayBundle):
    """Mean direction of surviving rays (FindCentralRay,
    ART/ModuleProcessing.py:464-482)."""
    w = _alive_w(bundle)
    return masked_mean(bundle.d, w[:, None], axis=0)


def central_point(bundle: RayBundle):
    w = _alive_w(bundle)
    return masked_mean(bundle.p, w[:, None], axis=0)


def energy_transmission(source: RayBundle, out: RayBundle):
    """Energy transmission in percent (getETransmission,
    ART/ModuleAnalysisAndPlots.py:62-77)."""
    return 100.0 * jnp.sum(out.weights()) / jnp.maximum(jnp.sum(source.weights()), 1e-30)


def numerical_aperture(bundle: RayBundle, refractive_index: float = 1.0):
    """n*sin(max angle to the central ray) over surviving rays
    (ReturnNumericalAperture, ART/ModuleProcessing.py:536-566)."""
    c = central_direction(bundle)
    ang = angle_between(jnp.broadcast_to(c, bundle.d.shape), bundle.d)
    ang = jnp.where(bundle.alive, ang, 0.0)
    return jnp.sin(jnp.max(ang)) * refractive_index


def airy_radius(wavelength, na):
    """1.22/2 * lambda / NA, 0 for NA < 1e-3 (ReturnAiryRadius,
    ART/ModuleProcessing.py:570-593)."""
    return jnp.where(na > 1e-3, 1.22 * 0.5 * wavelength / jnp.maximum(na, 1e-3), 0.0)


# ---------------------------------------------------------------------------
# detector response (plane hit points, delays)
# ---------------------------------------------------------------------------


def detector_points_3d(bundle: RayBundle, centre, normal):
    """Lab-frame impact points on the detector plane
    (Detector.get_PointList3D, ART/ModuleDetector.py:191-210)."""
    num = jnp.sum(normal * (centre - bundle.p), axis=-1)
    den = jnp.sum(bundle.d * normal, axis=-1)
    t = num / jnp.where(jnp.abs(den) > 1e-30, den, jnp.inf)
    return bundle.p + t[:, None] * bundle.d, t


def detector_points_2d(bundle: RayBundle, centre, normal, rot):
    """In-plane coordinates with origin at the detector centre
    (Detector.get_PointList2D, ART/ModuleDetector.py:212-234). ``rot`` is the
    host-precomputed rotation taking ``normal`` -> ez (RotationPointList
    convention)."""
    pts3, _ = detector_points_3d(bundle, centre, normal)
    # full-f32 matmul precision: a reduced-precision default (bf16 or TF32
    # passes) would add
    # ~4e-3-relative noise to the in-plane coordinates — micrometres on a
    # millimetre-offset spot, swamping micron-scale foci
    local = jnp.matmul(pts3 - centre, rot.T,
                       precision=jax.lax.Precision.HIGHEST)
    return local[:, :2]


def centre_point_cloud(xy, alive):
    """Recentre on the (min+max)/2 midpoint of surviving points
    (CentrePointList, ART/ModuleGeometry.py:222-245)."""
    big = jnp.asarray(jnp.finfo(xy.dtype).max, dtype=xy.dtype)
    lo = jnp.min(jnp.where(alive[:, None], xy, big), axis=0)
    hi = jnp.max(jnp.where(alive[:, None], xy, -big), axis=0)
    return xy - 0.5 * (lo + hi)


def detector_delays(bundle: RayBundle, centre, normal):
    """Ray delays [fs] relative to the mean travel time of surviving rays
    (Detector.get_Delays, ART/ModuleDetector.py:254-279).

    Precision note: the trace carries the OPL as a Kahan pair
    ``(opl, opl_c)`` whose compensation is ~1 ulp of a metre-scale total —
    i.e. exactly the fs-scale signal this function extracts. Collapsing the
    pair first (``opl - opl_c``) re-rounds the compensation away in float32,
    so the large common part is cancelled *before* the compensation is
    applied: ``(opl - mean_opl)`` is exact (Sterbenz: all totals are within
    2x of each other), and only then is the small ``(opl_c - mean_c)``
    correction subtracted."""
    _, t = detector_points_3d(bundle, centre, normal)
    s, c = kahan_add(bundle.opl, bundle.opl_c, t)
    w = _alive_w(bundle)
    mean_s = masked_mean(s, w)
    mean_c = masked_mean(c, w)
    delta = (s - mean_s) - (c - mean_c)
    return delta / LIGHT_SPEED_MM_S * 1e15


def spot_and_duration(bundle: RayBundle, centre, normal, rot, intensity_weighted=False):
    """(spot SD [mm], duration SD [fs]) on a detector plane — the metrics the
    reference prints and optimizes (GetResultSummary,
    ART/ModuleAnalysisAndPlots.py:81-129)."""
    w = _alive_w(bundle, intensity_weighted)
    xy = detector_points_2d(bundle, centre, normal, rot)
    spot = std_points(xy, w)
    delays = detector_delays(bundle, centre, normal)
    duration = std_scalar(delays, w)
    return spot, duration
