"""Fused trace->detector-statistics pass (XLA fused-source engine + moment
epilogue) vs the composed reference path (trace + Detector responses +
weighted SD reductions)."""

import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.analysis import stats
from attosecondraytracing_tpu.models import masks as mmask
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement
from attosecondraytracing_tpu.ops.source import make_source_spec, source_bundle
from attosecondraytracing_tpu.ops.trace import trace
from attosecondraytracing_tpu.ops.xla_source import xla_source_detector_stats


@pytest.fixture(scope="module")
def setup():
    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": 16}
    chain = OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, inc, -inc], [0, 0, 0])
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    spec = make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)

    n = 20000
    src = source_bundle(spec, n, wavelength=80e-6)
    out = trace(src, elements, keep_history=False)
    det = Detector(np.zeros(3))
    # f-d-f chain focuses at f beyond the last toroid; place 10 mm short of
    # it so the spot has structure and the scan brackets the focus
    det.autoplace(out, focal - 10.0)
    return spec, elements, n, out, det


def test_stats_kernel_matches_detector_path(setup):
    spec, elements, n, out, det = setup
    distances = (-20.0, -5.0, 0.0, 5.0, 20.0)
    res = xla_source_detector_stats(
        spec, elements, n, det.centre, det.normal, det._plane_rotation(),
        distances=distances,
    )
    assert res["spot_sd"].shape == (5,)
    for j, dist in enumerate(distances):
        dj = det.copy_detector()
        dj.shiftByDistance(dist)
        spot, dur = (float(v) for v in dj.get_SpotAndDuration(out))
        assert res["spot_sd"][j] == pytest.approx(spot, rel=2e-3, abs=1e-6), dist
        # duration: the fused pass's f32 OPL noise (~0.6 fs/ray, same class
        # as the streamed path's 0.4 fs floor) adds in quadrature
        k, r = float(res["duration_sd"][j]), dur
        assert abs(k - r) <= 0.025 * r or abs(k * k - r * r) ** 0.5 <= 0.8, (dist, k, r)
    # unweighted survivors
    assert res["sum_w"][0] == pytest.approx(float(np.asarray(out.alive).sum()), abs=0.5)


def test_stats_kernel_gaussian_weights(setup):
    spec, elements, n, out, det = setup
    res = xla_source_detector_stats(
        spec, elements, n, det.centre, det.normal, det._plane_rotation(),
        distances=(0.0,), gaussian_edge=float(1 / np.e**2),
    )
    # reference: same Gaussian profile applied to the jnp source bundle
    src = source_bundle(spec, n, wavelength=80e-6)
    d = np.asarray(src.d, np.float64)
    axis = np.array([1.0, 0, 0])
    tan2 = (np.linalg.norm(np.cross(d, axis), axis=1) / (d @ axis)) ** 2
    w = np.exp(np.log(1 / np.e**2) * tan2 / np.tan(25e-3) ** 2)
    w = w * np.asarray(out.alive)
    xy = np.asarray(det.get_PointList2D(out), np.float64)
    mean = (w[:, None] * xy).sum(0) / w.sum()
    var = (w[:, None] * (xy - mean) ** 2).sum(0) / w.sum()
    spot_ref = float(np.sqrt(var.sum()))
    assert res["sum_w"][0] == pytest.approx(w.sum(), rel=1e-4)
    assert res["spot_sd"][0] == pytest.approx(spot_ref, rel=2e-3)


def test_pallas_optimizer_matches_bundle_optimizer(setup):
    """FindOptimalDistanceFused lands on the same detector distance as the
    bundle-based FindOptimalDistance on the same physics."""
    from attosecondraytracing_tpu.analysis.optimizer import (
        FindOptimalDistance,
        FindOptimalDistanceFused,
    )

    spec, elements, n, out, det = setup
    d_ref, spot_ref, _ = FindOptimalDistance(
        det, out, OptFor="spotsize", Amplitude=30.0, Precision=2
    )
    d_pal, spot_pal, _ = FindOptimalDistanceFused(
        spec, elements, n, det, OptFor="spotsize", Amplitude=30.0, Precision=2
    )
    assert d_pal.get_distance() == pytest.approx(d_ref.get_distance(), abs=0.05)
    assert spot_pal == pytest.approx(spot_ref, rel=5e-3, abs=1e-6)


def test_stats_kernel_full_scan_matches_optimizer_shape(setup):
    """A 21-point scan in one fused pass brackets the focus: the spot-SD
    curve is V-shaped around its minimum."""
    spec, elements, n, out, det = setup
    distances = tuple(np.linspace(-80, 80, 21))
    res = xla_source_detector_stats(
        spec, elements, n, det.centre, det.normal, det._plane_rotation(),
        distances=distances,
    )
    s = res["spot_sd"]
    k = int(s.argmin())
    assert 0 < k < 20
    assert np.all(np.diff(s[: k + 1]) <= 1e-9) or k <= 2
    assert np.all(np.diff(s[k:]) >= -1e-9) or k >= 18


def test_sharded_spiral_partition_matches_global():
    """Per-shard (phase, k_frac) synthesis reproduces the global spiral."""
    from attosecondraytracing_tpu.parallel.mesh import shard_source_offsets

    spec = make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)
    n_total, n_dev = 8192, 8
    full = source_bundle(spec, n_total)
    n_local, phases, k_fracs = shard_source_offsets(n_total, n_dev)
    parts = [
        source_bundle(spec, n_local, phase=float(phases[i]),
                      k_frac=float(k_fracs[i]), n_total=n_total)
        for i in range(n_dev)
    ]
    d_union = np.concatenate([np.asarray(b.d) for b in parts])
    # angle-frac rounding paths differ (local vs global digit split): allow
    # the documented ~1e-4-turn phase envelope, ~2e-5 on direction components
    np.testing.assert_allclose(d_union, np.asarray(full.d), atol=5e-5)
    # radii are exact in both
    r_union = np.hypot(d_union[:, 1], d_union[:, 2]) / d_union[:, 0]
    r_full = np.asarray(full.d)
    r_full = np.hypot(r_full[:, 1], r_full[:, 2]) / r_full[:, 0]
    np.testing.assert_allclose(r_union, r_full, atol=2e-6)


def test_sharded_source_stats_matches_single_device(setup):
    """source_stats_sharded over the 8-virtual-device mesh == the
    single-device fused stats (same global spiral, partial sums combined
    across shards)."""
    import jax
    from attosecondraytracing_tpu.parallel.mesh import source_stats_sharded

    spec, elements, n, out, det = setup
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("rays",))
    distances = (-10.0, 0.0, 10.0)
    kw = dict(det_centre=det.centre, det_normal=det.normal,
              det_rot=det._plane_rotation(), distances=distances)
    res_1 = xla_source_detector_stats(spec, elements, 16384, **kw)
    res_8 = source_stats_sharded(spec, elements, 16384, mesh, **kw)
    np.testing.assert_allclose(res_8["sum_w"], res_1["sum_w"], rtol=2e-3)
    np.testing.assert_allclose(res_8["spot_sd"], res_1["spot_sd"], rtol=2e-3)
    np.testing.assert_allclose(res_8["duration_sd"], res_1["duration_sd"], rtol=2e-2, atol=0.2)


def test_chunked_stats_match_single_pass(setup):
    """The >2^23-ray chunk law: quarter-range calls at the (phase, k_frac)
    offsets of the global spiral must reproduce the single-pass sums."""
    from attosecondraytracing_tpu.ops import source as psrc
    from attosecondraytracing_tpu.ops import xla_source as mod

    spec, elements, n, out, det = setup
    kw = dict(det_centre=det.centre, det_normal=det.normal,
              det_rot=det._plane_rotation(), distances=(0.0, 10.0))
    res_1 = xla_source_detector_stats(spec, elements, 16384, **kw)
    assert mod.CHUNK == 1 << 23  # the production chunk size

    # simulate chunking by composing 4 quarter-range calls the way the
    # chunk loop does (phase/k_frac per offset) and summing raw moments
    n_total, n_chunks = 16384, 4
    n_local = n_total // n_chunks
    import numpy as _np
    agg = None
    for i in range(n_chunks):
        off = i * n_local
        r = xla_source_detector_stats(
            spec, elements, n_local,
            phase=float(_np.mod(off * psrc.PHI_FRAC, 1.0)),
            k_frac=off / n_total, n_total=n_total, **kw)
        w = r["sum_w"]
        part = {
            "w": w, "wx": r["mean_x"] * w, "wy": r["mean_y"] * w,
        }
        if agg is None:
            agg = part
        else:
            agg = {k: agg[k] + part[k] for k in agg}
    np.testing.assert_allclose(agg["w"], res_1["sum_w"], rtol=1e-3)
    np.testing.assert_allclose(
        agg["wx"] / agg["w"], res_1["mean_x"], atol=5e-6)
    np.testing.assert_allclose(
        agg["wy"] / agg["w"], res_1["mean_y"], atol=5e-6)


def test_duration_floor_triggers_x64_refinement(setup, capsys):
    """At a stigmatic 2f-2f focus the true duration SD is far below the
    fused pass's ~0.6 fs float32 noise floor; the optimizer must detect this and
    refine with the two-pass float64 path, landing on the float64 optimizer's
    distance (VERDICT r2 #7)."""
    import jax
    from jax import enable_x64

    from attosecondraytracing_tpu.analysis.optimizer import (
        FindOptimalDistance,
        FindOptimalDistanceFused,
    )
    from attosecondraytracing_tpu.ops.trace import trace as _trace

    spec, elements, n, out, det = setup
    d_pal, spot_pal, dur_pal = FindOptimalDistanceFused(
        spec, elements, n, det, OptFor="duration", Amplitude=30.0, Precision=2,
        verbose=True,
    )
    captured = capsys.readouterr()
    assert "refined with the two-pass float64 optimizer" in captured.out

    # float64 reference optimizer on an x64-traced bundle
    with enable_x64():
        src64 = jax.tree.map(
            lambda x: np.asarray(x, np.float64)
            if np.issubdtype(np.asarray(x).dtype, np.floating) else x,
            source_bundle(spec, n, wavelength=80e-6),
        )
        out64 = _trace(src64, elements, keep_history=False)
        d_ref, _, dur_ref = FindOptimalDistance(
            det, out64, OptFor="duration", Amplitude=30.0, Precision=3
        )
    assert d_pal.get_distance() == pytest.approx(d_ref.get_distance(), abs=0.5)
    assert dur_pal < 1.0  # refined reading resolves the sub-floor duration


def test_moment_scan_unbounded_distances(setup):
    """The moment epilogue has no per-call distance limit: a 300-distance
    scan runs in one fused pass (the distance dependence is an
    exact quadratic evaluated on host in f64) and agrees with the
    per-distance detector path at sampled positions; consecutive calls with
    different distance sets must also agree with each other exactly on the
    shared moments (w is distance-independent)."""
    spec, elements, n, out, det = setup
    distances = tuple(np.linspace(-30.0, 30.0, 300))
    res = xla_source_detector_stats(
        spec, elements, n, det.centre, det.normal, det._plane_rotation(),
        distances=distances,
    )
    assert res["spot_sd"].shape == (300,)
    assert np.all(np.isfinite(res["spot_sd"]))
    assert np.ptp(res["sum_w"]) == 0.0  # w must not depend on distance
    for j in (0, 150, 299):
        dj = det.copy_detector()
        dj.shiftByDistance(distances[j])
        spot, dur = (float(v) for v in dj.get_SpotAndDuration(out))
        assert res["spot_sd"][j] == pytest.approx(spot, rel=2e-3, abs=1e-6)
        k, r = float(res["duration_sd"][j]), dur
        assert abs(k - r) <= 0.025 * r or abs(k * k - r * r) ** 0.5 <= 0.8, (j, k, r)
    # same moments, different distance grid: identical where grids overlap
    res2 = xla_source_detector_stats(
        spec, elements, n, det.centre, det.normal, det._plane_rotation(),
        distances=(distances[0], distances[299]),
    )
    np.testing.assert_allclose(res2["spot_sd"], res["spot_sd"][[0, 299]], rtol=1e-12)


def test_pallas_optimizer_far_off_focus_start():
    """Regression (round-3 review): with the detector initially placed far
    from the focus, the f32 moment accumulator must not bury the focal-plane
    variance (multi-mm x0 spreads squared on the device) — the probe-based
    expansion-point pre-centering keeps the moments small. The optimizer must
    land on the same focus as when started near it."""
    from attosecondraytracing_tpu.analysis.optimizer import (
        FindOptimalDistanceFused,
    )
    from attosecondraytracing_tpu.models.detector import Detector as Det

    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": 16}
    chain = OEPlacement(props, [mask, tor, tor], [400, 100, 500],
                        [0, inc, -inc], [0, 0, 0])
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    spec = make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)
    src = source_bundle(spec, 60000, wavelength=80e-6)
    out = trace(src, elements, keep_history=False)

    # start 300 mm short of the 2f refocus: x0 spreads are ~7.5 mm
    det_far = Det(np.zeros(3))
    det_far.autoplace(out, focal - 300.0)
    d_far, spot_far, _ = FindOptimalDistanceFused(
        spec, elements, 60000, det_far, "spotsize", Amplitude=400.0)

    det_near = Det(np.zeros(3))
    det_near.autoplace(out, focal - 10.0)
    d_near, spot_near, _ = FindOptimalDistanceFused(
        spec, elements, 60000, det_near, "spotsize", Amplitude=30.0)

    assert d_far.get_distance() == pytest.approx(d_near.get_distance(), abs=0.5)
    assert spot_far == pytest.approx(spot_near, rel=0.1, abs=2e-4)
    assert spot_far < 0.05  # mm: a real focus, not accumulator noise


def test_pallas_optimizer_arbitrary_precision(setup, monkeypatch):
    """The host-side grid zoom reaches amplitude*10^-(Precision+1) for ANY
    Precision (ADVICE r3: the old single 200k-point grid floored the
    resolution at amplitude*1e-5). Synthetic moments with a known irrational
    minimum isolate the refinement logic from device noise."""
    from attosecondraytracing_tpu.analysis.optimizer import (
        FindOptimalDistanceFused,
    )
    from attosecondraytracing_tpu.ops import moments as pt
    from attosecondraytracing_tpu.ops import xla_source

    spec, elements, n, out, det = setup
    d_true_rel = 7.654321e-3  # mm, relative to the expansion point
    recorded = {}

    def fake_moments(spec_, elements_, n_rays_, c_, nrm_, rot_, **kw):
        centre = float(kw.get("centre_distance", 0.0))
        recorded["centre"] = centre
        m = dict.fromkeys(pt.MOMENT_FIELDS, 0.0)
        # var_x(d_rel) = 1 - 2 d_rel * x0cx + d_rel^2 -> min at x0cx
        m.update(w=1.0, x0x0=1.0, x0cx=d_true_rel, cxcx=1.0,
                 d0d0=1.0, cdcd=1.0)
        return {
            "moments": np.array([m[f] for f in pt.MOMENT_FIELDS]),
            "opl_ref": 0.0, "inv_dn_chief": 0.0, "centre_distance": centre,
        }

    monkeypatch.setattr(xla_source, "xla_source_moments", fake_moments)
    first = det.get_distance()
    d_opt, spot, _ = FindOptimalDistanceFused(
        spec, elements, n, det, OptFor="spotsize", Amplitude=30.0, Precision=6,
    )
    expected_shift = recorded["centre"] + d_true_rel
    # resolution target: 30 mm * 10^-7 = 3e-6 mm; allow a few steps
    assert d_opt.get_distance() - first == pytest.approx(expected_shift, abs=1e-5)
    assert spot == pytest.approx(np.sqrt(1.0 - d_true_rel**2), rel=1e-6)


def test_probe_focus_estimate_weighting():
    """Intensity weights shift the probe focus estimate toward the weighted
    sub-beam's focus (ADVICE r3: the expansion point must match the fused
    pass's weighted moments)."""
    from attosecondraytracing_tpu.analysis.optimizer import _probe_focus_estimate
    from attosecondraytracing_tpu.models.detector import Detector as Det
    from attosecondraytracing_tpu.ops.bundle import make_bundle

    rng = np.random.default_rng(7)
    n = 4000
    # two interleaved converging sub-beams: foci 10 mm and 20 mm past z=0
    x = rng.uniform(-1, 1, n)
    y = rng.uniform(-1, 1, n)
    focus_z = np.where(np.arange(n) % 2 == 0, 10.0, 20.0)
    p = np.stack([x, y, np.full(n, -5.0)], axis=-1)
    d = np.stack([-x, -y, focus_z + 5.0], axis=-1)
    bundle = make_bundle(p, d)
    det = Det(np.array([0.0, 0.0, -5.0]), Centre=[0.0, 0.0, 0.0],
              Normal=[0.0, 0.0, -1.0])  # normal towards the incoming rays

    w_a = np.where(np.arange(n) % 2 == 0, 1.0, 1e-6)
    w_b = np.where(np.arange(n) % 2 == 0, 1e-6, 1.0)
    est_a = _probe_focus_estimate(bundle, det, 50.0, weights=w_a)
    est_b = _probe_focus_estimate(bundle, det, 50.0, weights=w_b)
    assert abs(est_a) == pytest.approx(10.0, rel=1e-3)
    assert abs(est_b) == pytest.approx(20.0, rel=1e-3)
    est_u = _probe_focus_estimate(bundle, det, 50.0)
    assert min(abs(est_a), abs(est_b)) < abs(est_u) < max(abs(est_a), abs(est_b))
