"""Detector-distance optimization.

Reference algorithm (ART/ModuleProcessing.py:317-460): iterative grid
refinement — scan 2*Amplitude in 20 steps, keep the argmin of the fitness,
shrink the window by 10x, repeat Precision+1 times. Fitness per OptFor:
"spotsize" = SD of the detector spot, "duration" = SD of the delays,
"intensity" = spotsize^2 * duration.

Here each refinement level evaluates *all* candidate distances in one
vmapped device call (the whole scan is ~(Precision+1) tiny XLA launches
instead of 20*(Precision+1) python-loop re-traces of the detector response).
A closed-form quadratic "focus finder" is also provided: on a fixed ray
bundle both spot-variance and delay-variance are exact quadratics in the
detector shift, so the optimum needs no search at all (one reduction,
differentiable) — use it when reference-exact optimizer parity is not needed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bundle import RayBundle
from . import stats

_OPTFOR_ALIASES = {"size": "spotsize", "spotsize": "spotsize", "duration": "duration", "intensity": "intensity"}


@partial(jax.jit, static_argnames=("opt_for", "intensity_weighted"))
def _scan_fitness(bundle, centre, normal, rot, shifts, opt_for, intensity_weighted):
    """Fitness at each candidate shift of the detector along -normal
    (vectorized over the scan axis)."""

    def one(shift):
        c = centre - shift * normal
        w = bundle.alive.astype(bundle.p.dtype)
        if intensity_weighted:
            w = w * bundle.intensity
        spot = jnp.asarray(0.0, dtype=bundle.p.dtype)
        duration = jnp.asarray(0.0, dtype=bundle.p.dtype)
        if opt_for in ("intensity", "spotsize"):
            xy = stats.detector_points_2d(bundle, c, normal, rot)
            spot = stats.std_points(xy, w)
        if opt_for in ("intensity", "duration"):
            delays = stats.detector_delays(bundle, c, normal)
            duration = stats.std_scalar(delays, w)
        if opt_for == "intensity":
            fitness = spot**2 * duration
        elif opt_for == "duration":
            fitness = duration
        else:
            fitness = spot
        return fitness, spot, duration

    return jax.vmap(one)(shifts)


def FindOptimalDistance(
    Detector,
    bundle: RayBundle,
    OptFor: str = "intensity",
    Amplitude: float | None = None,
    Precision: int = 3,
    IntensityWeighted: bool = False,
    verbose: bool = False,
):
    """Find the detector distance minimizing the chosen fitness
    (ART/ModuleProcessing.py:369-460 semantics; accepts "size" as an alias of
    "spotsize" — the reference validates one spelling but implements the
    other, ART/ModuleProcessing.py:424 vs :347).

    Returns (optimal Detector copy, spot SD [mm], duration SD [fs]).
    """
    if OptFor not in _OPTFOR_ALIASES:
        raise NameError(
            "OptFor must be one of 'intensity', 'spotsize'/'size', or 'duration'."
        )
    opt_for = _OPTFOR_ALIASES[OptFor]

    first_distance = Detector.get_distance()
    if Amplitude is None:
        xy = Detector.get_PointList2D(bundle)
        w = bundle.alive.astype(xy.dtype)
        size_spot = 2.0 * float(stats.std_points(xy, w))
        na = float(stats.numerical_aperture(bundle))
        Amplitude = min(4 * np.ceil(size_spot / np.tan(np.arcsin(min(na, 1.0)))), first_distance)
    amplitude = float(Amplitude)
    step = amplitude / 10.0

    det = Detector.copy_detector()
    rot = det._plane_rotation()
    centre0 = jnp.asarray(det.centre)
    normal = jnp.asarray(det.normal)
    base_shift = 0.0
    opt_spot = np.nan
    opt_duration = np.nan

    for k in range(Precision + 1):
        amp_k = amplitude * 0.1**k
        step_k = step * 0.1**k
        n = int(2 * amp_k / step_k)
        # candidate positions: from -amp_k to -amp_k + (n-1)*step, relative to
        # the current centre (the reference walks the detector the same way)
        shifts = base_shift + (-amp_k + step_k * jnp.arange(n))
        fitness, spots, durations = _scan_fitness(
            bundle, centre0, normal, rot, shifts, opt_for, IntensityWeighted
        )
        ind = int(jnp.argmin(fitness))
        base_shift = float(shifts[ind])
        opt_spot = float(spots[ind]) if opt_for in ("intensity", "spotsize") else np.nan
        opt_duration = float(durations[ind]) if opt_for in ("intensity", "duration") else np.nan

    # candidate planes were centre - shift*normal, which is exactly
    # Detector.shiftByDistance(shift)
    det.shiftByDistance(base_shift)
    if not (
        first_distance - amplitude + 10**-Precision
        < det.get_distance()
        < first_distance + amplitude - 10**-Precision
    ):
        print("There`s no minimum-size/duration focus in the searched range.")
    if verbose:
        print(
            f"Optimal detector distance {det.get_distance():.3f} mm "
            f"(spot {opt_spot * 1e3:.3g} um, duration {opt_duration:.3g} fs)"
        )
    return det, opt_spot, opt_duration


def _probe_focus_estimate(bundle, det, amplitude, weights=None):
    """Rough focal shift [mm, shiftByDistance convention] from a small traced
    probe bundle: closed-form minimum of the host-float64 spot variance of
    the exact per-ray linear impact model ``x(d) = x0 - d*cx`` (a global
    quadratic in d). Only used to centre the fused pass's moment expansion
    point near the focus; a few-percent error is irrelevant there.

    ``weights``: optional per-ray weights (e.g. the Gaussian source profile)
    so the expansion point matches the intensity-weighted moments the fused
    pass accumulates."""
    alive = np.asarray(bundle.alive)
    if not alive.any():
        return 0.0
    p = np.asarray(bundle.p, np.float64)[alive]
    dvec = np.asarray(bundle.d, np.float64)[alive]
    w = (np.ones(len(p)) if weights is None
         else np.asarray(weights, np.float64)[alive])
    n = np.asarray(det.normal, np.float64)
    c = np.asarray(det.centre, np.float64)
    rot = np.asarray(det._plane_rotation(), np.float64)
    e1, e2 = rot[0], rot[1]
    dn = dvec @ n
    ok = np.abs(dn) > 1e-12
    if not ok.any():
        return 0.0
    p, dvec, dn, w = p[ok], dvec[ok], dn[ok], w[ok]
    wsum = max(w.sum(), 1e-300)
    inv_dn = 1.0 / dn
    t0 = ((c - p) @ n) * inv_dn
    x0 = (p - c) @ e1 + t0 * (dvec @ e1)
    y0 = (p - c) @ e2 + t0 * (dvec @ e2)
    cx = inv_dn * (dvec @ e1)
    cy = inv_dn * (dvec @ e2)

    # var_w(x0 - d cx) + var_w(y0 - d cy) = A d^2 + B d + C: closed-form min
    def _terms(a, b):
        am, bm = (w * a).sum() / wsum, (w * b).sum() / wsum
        return ((w * (b - bm) ** 2).sum() / wsum,
                -2.0 * (w * (a - am) * (b - bm)).sum() / wsum)

    Ax, Bx = _terms(x0, cx)
    Ay, By = _terms(y0, cy)
    A, B = Ax + Ay, Bx + By
    if A <= 0.0:
        return 0.0
    return float(np.clip(-B / (2.0 * A), -amplitude, amplitude))


def FindOptimalDistanceFused(
    spec,
    elements,
    n_rays: int,
    Detector,
    OptFor: str = "intensity",
    Amplitude: float | None = None,
    Precision: int = 3,
    gaussian_edge: float | None = None,
    verbose: bool = False,
    moments_fn=None,
    last_moments: dict | None = None,
):
    """Detector-distance optimization without ever materializing the bundle —
    and without a refinement loop: ONE fused trace->moments pass
    (ops.xla_source.xla_source_moments) determines every per-distance
    statistic as an EXACT quadratic in the scan distance (the alive mask
    cannot depend on the detector position, so the quadratics hold
    globally), and the fitness is minimized on the host in float64 at
    arbitrary resolution. The reference's whole iterative refinement
    (ART/ModuleProcessing.py:317-460: Precision+1 rounds of 20-point scans)
    collapses to a single device pass at any ray count.

    ``spec`` is an ops.source.BakedSource; ``Detector`` supplies the
    starting plane; ``Amplitude`` bounds the search window (auto-sized from
    spot and NA like the reference); ``Precision`` sets the target grid
    resolution ``Amplitude * 10^-(Precision+1)`` — the reference's final
    refinement step — reached by zooming the *host-side* (free) quadratic
    evaluation of the one moment pass, so any Precision costs zero extra
    device work. A cheap probe trace pre-locates the
    focus so the moment expansion point sits near it (squaring multi-mm
    off-focus coordinates in float32 would bury the focal-plane variance —
    see ops.moments.moment_sums). Gaussian source weighting via
    ``gaussian_edge``. Duration readings carry the fused pass's ~0.6 fs
    float32 noise floor; optima below it are refined in float64.

    ``moments_fn(det_centre, det_normal, det_rot, gaussian_edge,
    centre_distance)`` overrides the moment provider — the driver's scan
    engine passes ops.xla_source.make_xla_moments_fn closures, whose
    geometry stays on the device across calls. ``last_moments`` (a dict, if
    given) receives the moment
    record actually used — its ``moments[0]`` is the distance-independent
    surviving weight, i.e. the scan driver's transmission numerator.

    Returns (optimal Detector copy, spot SD [mm], duration SD [fs]).
    """
    from ..ops import xla_source
    from ..ops.moments import moments_to_distance_sums, sums_to_stats
    from ..ops.source import source_bundle, synth_source_c
    from ..ops.trace import trace_jit

    if OptFor not in _OPTFOR_ALIASES:
        raise NameError(
            "OptFor must be one of 'intensity', 'spotsize'/'size', or 'duration'."
        )
    opt_for = _OPTFOR_ALIASES[OptFor]

    det = Detector.copy_detector()
    first_distance = det.get_distance()
    # probe source: for 'extended' specs the first 4096 global rays all
    # decode to sub-source 0's central cone fraction (k < n_each), which
    # would skew the auto-Amplitude and the expansion point — spread the
    # probe across every sub-source with a reduced per-cone count instead
    # (moments stay exact either way; this sizes the search window right)
    probe_spec = spec
    probe_n = min(n_rays, 4096)
    if spec.kind == "extended" and spec.n_sources > 0:
        n_each_p = max(1, min(spec.n_each, probe_n // spec.n_sources))
        probe_spec = spec._replace(n_each=n_each_p)
        probe_n = n_each_p * spec.n_sources
    probe = source_bundle(probe_spec, probe_n)
    out = trace_jit(probe, elements, keep_history=False)
    # probe weights = the same Gaussian-vs-radial-law profile the engine
    # applies (weight = edge**rr with rr from synth_source_c — k/n for plain
    # spirals, the per-cone law for 'extended'), so both the auto-Amplitude
    # and the expansion point match the weighted moments (source_bundle
    # intensities are uniform)
    if gaussian_edge is None:
        probe_w = np.ones(out.n_rays)
    else:
        _, _, rr = synth_source_c(
            probe_spec.kind, np.arange(probe_n, dtype=np.float32), probe_n,
            probe_spec.radius, pos_radius=probe_spec.pos_radius,
            n_each=probe_spec.n_each, n_sources=probe_spec.n_sources)
        probe_w = np.exp(np.log(gaussian_edge) * np.asarray(rr, np.float64))
    if Amplitude is None:
        xy = det.get_PointList2D(out)
        w = out.alive.astype(xy.dtype)
        size_spot = 2.0 * float(stats.std_points(xy, w))
        na = float(stats.numerical_aperture(out))
        Amplitude = min(4 * np.ceil(size_spot / np.tan(np.arcsin(min(na, 1.0)))), first_distance)
    amplitude = float(Amplitude)

    # probe-based focus pre-estimate = the fused pass's expansion point:
    # host float64 evaluation of the same exact quadratics on ~4k rays
    d_centre = float(_probe_focus_estimate(out, det, amplitude, weights=probe_w))

    rot = det._plane_rotation()
    if moments_fn is None:
        mom = xla_source.xla_source_moments(
            spec, elements, n_rays, det.centre, det.normal, rot,
            gaussian_edge=gaussian_edge, centre_distance=d_centre,
        )
    else:
        mom = moments_fn(det.centre, det.normal, rot,
                         gaussian_edge=gaussian_edge, centre_distance=d_centre)
    if last_moments is not None:
        last_moments.update(mom)

    def _stats_at(shifts):
        sums = moments_to_distance_sums(mom["moments"], shifts,
                                        mom["centre_distance"])
        return sums_to_stats(sums, mom["opl_ref"], shifts)

    def _fitness_of(res):
        if opt_for == "intensity":
            return res["spot_sd"] ** 2 * res["duration_sd"]
        if opt_for == "duration":
            return res["duration_sd"]
        return res["spot_sd"]

    # grid-zoom the free host evaluation until the step reaches the
    # reference's final refinement resolution amplitude*10^-(Precision+1)
    # (each zoom brackets the previous argmin by +-1 step, as the reference's
    # iterative refinement does)
    target_step = amplitude * 10.0 ** (-(int(Precision) + 1))
    lo, hi = -amplitude, amplitude
    base_shift, opt_spot, opt_duration = 0.0, np.nan, np.nan
    while True:
        shifts = np.linspace(lo, hi, 2001)
        res = _stats_at(shifts)
        fitness = _fitness_of(res)
        ind = int(np.argmin(fitness))
        base_shift = float(shifts[ind])
        opt_spot = float(res["spot_sd"][ind])
        opt_duration = float(res["duration_sd"][ind])
        step = float(shifts[1] - shifts[0])
        if step <= target_step or step < 1e-12:
            break
        lo, hi = base_shift - step, base_shift + step

    det.shiftByDistance(base_shift)

    # float32 noise-floor guard: fused duration readings carry ~0.6 fs of
    # per-ray OPL noise (ops.xla_source.xla_source_detector_stats). When the
    # optimum sits within ~2x that floor, the fitness landscape near the
    # focus is flat noise and the argmin is arbitrary within it — refine
    # with the two-pass float64 path
    if opt_for in ("duration", "intensity") and opt_duration < DURATION_F32_FLOOR_FS:
        det, opt_spot, opt_duration = _x64_refine_distance(
            spec, elements, n_rays, det, OptFor,
            amplitude=amplitude * 0.1 ** max(Precision - 1, 0),
            gaussian_edge=gaussian_edge, verbose=verbose,
        )
    if verbose:
        print(
            f"Optimal detector distance {det.get_distance():.3f} mm "
            f"(spot {opt_spot * 1e3:.3g} um, duration {opt_duration:.3g} fs)"
        )
    return det, opt_spot, opt_duration


#: ~2x the documented ~0.6 fs float32 OPL noise of the fused moment pass
DURATION_F32_FLOOR_FS = 1.2


def _x64_refine_distance(spec, elements, n_rays, det, OptFor, amplitude,
                         gaussian_edge, verbose, max_rays: int = 20000):
    """Final float64 refinement for sub-noise-floor duration optima: rebuild
    the (reference-semantics, float64 NumPy) source from the BakedSource,
    trace it on the streamed path under x64, and run the grid-refinement
    optimizer in the last window of the fused scan. Returns (det, spot,
    duration); a failure raises (every supported backend runs float64)."""
    from ..models import sources as msource
    from ..ops.trace import trace_jit

    origin = np.asarray(spec.origin)
    axis = np.asarray(spec.rot, np.float64) @ np.array([0.0, 0.0, 1.0])
    n = min(n_rays, max_rays)
    if spec.kind == "cone":
        bundle = msource.PointSource(origin, axis, float(np.arctan(spec.radius)), n)
    elif spec.kind == "disk":
        bundle = msource.PlaneWaveDisk(origin, axis, float(spec.radius), n)
    elif spec.kind == "extended":
        bundle = msource.ExtendedSource(origin, axis, 2.0 * spec.pos_radius,
                                        float(np.arctan(spec.radius)), n)
    else:  # 'square': radius carries the side length
        bundle = msource.PlaneWaveSquare(origin, axis, float(spec.radius), n)
    if gaussian_edge is not None:
        bundle = msource.ApplyGaussianIntensityToRayList(bundle, gaussian_edge)

    def f64(x):
        x = np.asarray(x)
        return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x

    with jax.enable_x64():
        # packed jitted trace: the executable is cached across the chains of
        # a scan (one float64 compile, not one per refining chain)
        out = trace_jit(jax.tree.map(f64, bundle), jax.tree.map(f64, elements),
                        keep_history=False)
        det2, spot, duration = FindOptimalDistance(
            det, out, OptFor, Amplitude=float(amplitude), Precision=2,
            IntensityWeighted=gaussian_edge is not None, verbose=False,
        )
    if verbose:
        print("(duration near the float32 noise floor: refined with the "
              "two-pass float64 optimizer)")
    return det2, float(spot), float(duration)


# ---------------------------------------------------------------------------
# closed-form focus finder
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("intensity_weighted",))
def optimal_shift_closed_form(bundle: RayBundle, centre, normal, rot,
                              intensity_weighted: bool = False):
    """Closed-form detector shift minimizing the spot variance.

    On a fixed bundle, each ray's in-plane impact point is affine in the
    detector shift s, so the spot variance is an exact quadratic in s with a
    unique minimum — no grid search needed (the weighted case is the same
    quadratic with weighted moments). Returns (s*, spot SD at s*).
    """
    w = bundle.alive.astype(bundle.p.dtype)
    if intensity_weighted:
        w = w * bundle.intensity
    xy0 = stats.detector_points_2d(bundle, centre, normal, rot)
    xy1 = stats.detector_points_2d(bundle, centre - 1.0 * normal, normal, rot)
    g = xy1 - xy0  # d(xy)/ds, exact (affine)
    m0 = stats.masked_mean(xy0, w[:, None], axis=0)
    mg = stats.masked_mean(g, w[:, None], axis=0)
    a = xy0 - m0
    bgrad = g - mg
    num = -jnp.sum(stats.masked_mean(a * bgrad, w[:, None], axis=0))
    den = jnp.sum(stats.masked_mean(bgrad * bgrad, w[:, None], axis=0))
    s_opt = num / jnp.maximum(den, 1e-30)
    var = stats.masked_mean(jnp.sum((a + s_opt * bgrad) ** 2, axis=-1), w)
    return s_opt, jnp.sqrt(var)


def delay_stats_for_shift(bundle: RayBundle, centre, normal, shift):
    """Duration SD at a shifted detector (helper for fast composite metrics)."""
    delays = stats.detector_delays(bundle, centre - shift * normal, normal)
    w = bundle.alive.astype(bundle.p.dtype)
    return stats.std_scalar(delays, w)
