"""Giga-ray image scan (analysis/gigascan.py): chunked fused-source tracing
with device-binned accumulation must reproduce the single-bundle image path."""

import numpy as np
import pytest

from attosecondraytracing_tpu.analysis.gigascan import fused_source_images
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement


@pytest.fixture(scope="module")
def setup():
    import jax.numpy as jnp

    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": 16384}
    chain = OEPlacement(props, [tor, tor], [500, 600], [inc, -inc], [0, 0])
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(engine="xla"), focal - 5.0)
    return chain, elements, det


def test_chunked_images_match_single_pass(setup):
    chain, elements, det = setup
    spec = chain.source_spec
    assert spec is not None
    kw = dict(bins=(64, 64))
    res_1 = fused_source_images(spec, elements, det, n_total=16384,
                                chunk=1 << 23, **kw)
    res_4 = fused_source_images(spec, elements, det, n_total=16384,
                                chunk=4096, extent=res_1["extent"], **kw)
    assert res_1["sum_w"] == pytest.approx(res_4["sum_w"], rel=1e-5)
    # chunked synthesis reproduces the global spiral to ~2e-5 in direction
    # (documented digit-split rounding), so rays sitting exactly on a pixel
    # boundary may hop one bin: allow a few single-ray weights per pixel and
    # require the bulk to match closely
    np.testing.assert_allclose(res_4["image"], res_1["image"], atol=2.5)
    assert np.abs(res_4["image"] - res_1["image"]).sum() < 0.01 * res_1["sum_w"]
    m1, m4 = res_1["mean_delay"], res_4["mean_delay"]
    w1 = res_1["weight_image"]
    both = np.isfinite(m1) & np.isfinite(m4) & (w1 > 5)
    assert both.sum() > 50
    diffs = np.abs(m4[both] - m1[both])
    assert np.median(diffs) < 0.05 and diffs.max() < 0.5, (  # fs
        np.median(diffs), diffs.max())


def test_images_match_scatter_histogram(setup):
    """The fused image (full-f32 one-hot matmul binning) equals a plain
    ``.at[].add`` scatter histogram of the same traced rays, and agrees with
    the streamed trace's scatter histogram up to single-bin hops of rays on
    pixel boundaries (chained vs lab frames round differently)."""
    import jax.numpy as jnp
    from numpy.lib.stride_tricks import sliding_window_view

    from attosecondraytracing_tpu.analysis import stats
    from attosecondraytracing_tpu.analysis.histogram import _bin_indices
    from attosecondraytracing_tpu.ops.source import source_bundle
    from attosecondraytracing_tpu.ops.trace import trace
    from attosecondraytracing_tpu.ops.xla_source import xla_trace_source

    chain, elements, det = setup
    spec = chain.source_spec
    n, bins = 16384, (64, 64)
    res = fused_source_images(spec, elements, det, n_total=n, bins=bins)
    # float32 geometry, as inside the fused binning
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    lo, hi = (f32(v) for v in res["extent"])
    w_src = np.exp(np.log(spec.gaussian_edge) * np.arange(n) / n)

    def scatter(out):
        w = w_src * np.asarray(out.alive)
        xy = stats.detector_points_2d(out, f32(det.centre), f32(det.normal),
                                      f32(det._plane_rotation()))
        ix, iy, inside = _bin_indices(xy, lo, hi, bins)
        return np.asarray(jnp.zeros(bins).at[ix, iy].add(jnp.where(inside, w, 0.0)))

    fused = scatter(xla_trace_source(spec.baked(), elements, n,
                                     wavelength=spec.wavelength))
    # same rays, two binnings: eager vs jitted float32 arithmetic may move a
    # ray sitting exactly on a pixel edge (a hop of at most one ray weight)
    np.testing.assert_allclose(res["image"], fused, atol=1.0)
    assert np.abs(res["image"] - fused).sum() < 1e-3 * res["sum_w"]

    streamed = scatter(trace(source_bundle(spec.baked(), n,
                                           wavelength=spec.wavelength),
                             elements, keep_history=False))
    assert res["sum_w"] == pytest.approx(streamed.sum(), rel=1e-4)

    def blur3(a):
        return sliding_window_view(np.pad(a, 1), (3, 3)).sum(axis=(2, 3))

    assert np.abs(blur3(res["image"]) - blur3(streamed)).sum() < (
        0.05 * 9 * res["sum_w"])


def test_sharded_images_match_single_device(setup):
    """source_images_sharded over the 8-virtual-device mesh == the
    single-device gigascan images (same global spiral via per-shard
    (phase, k_frac) offsets; per-device binned partial images summed in f64
    on the host)."""
    import jax
    import numpy as np

    from attosecondraytracing_tpu.ops.moments import chief_ray_refs
    from attosecondraytracing_tpu.parallel.mesh import source_images_sharded

    chain, elements, det = setup
    spec = chain.source_spec
    baked = spec.baked()
    n = 16384
    res_1 = fused_source_images(spec, elements, det, n_total=n, bins=(64, 64))
    opl_ref, _ = chief_ray_refs(baked, elements, det.centre, det.normal)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("rays",))
    w8, wd8 = source_images_sharded(
        baked, elements, n, mesh, det.centre, det.normal,
        det._plane_rotation(), res_1["extent"], bins=(64, 64),
        gaussian_edge=spec.gaussian_edge, opl_ref=opl_ref,
        wavelength=spec.wavelength)
    assert w8.sum() == pytest.approx(res_1["sum_w"], rel=1e-5)
    # per-shard spiral-phase rounding differs from the global digit split
    # (same envelope as the chunked-vs-single comparison): boundary rays may
    # hop one bin
    np.testing.assert_allclose(w8, res_1["image"], atol=2.5)
    assert np.abs(w8 - res_1["image"]).sum() < 0.02 * res_1["sum_w"]


def test_images_match_bundle_histogram_path(setup):
    """The gigascan image equals Detector.get_Image on the equivalent
    explicitly-built bundle (same in-jit spiral, same weights)."""
    import jax.numpy as jnp

    from attosecondraytracing_tpu.ops.source import source_bundle
    from attosecondraytracing_tpu.ops.trace import trace

    chain, elements, det = setup
    spec = chain.source_spec
    n = 16384
    res = fused_source_images(spec, elements, det, n_total=n, bins=(64, 64))

    src = source_bundle(spec.baked(), n, wavelength=spec.wavelength)
    kf = jnp.arange(n, dtype=jnp.float32)
    weights = jnp.exp(np.log(spec.gaussian_edge) * kf / n)
    out = trace(src, elements, keep_history=False)
    out = out._replace(intensity=weights)
    img, (lo, hi) = det.get_Image(out, bins=(64, 64), extent=res["extent"])
    # chained-frame engine vs lab-frame streamed trace: impact points agree only to
    # ~1e-4 mm (f32 reassociation) while pixels here are ~6 um, so a few
    # percent of rays legitimately hop one bin. Compare physically: image
    # moments and a 3x3-blurred L1 (absorbs single-bin hops).
    img = np.asarray(img, np.float64)

    def blur3(a):
        from numpy.lib.stride_tricks import sliding_window_view

        return sliding_window_view(np.pad(a, 1), (3, 3)).sum(axis=(2, 3))

    b1, b2 = blur3(img), blur3(res["image"])
    assert np.abs(b1 - b2).sum() < 0.05 * 9 * res["sum_w"]

    ii, jj = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    for a, b in [(img, res["image"])]:
        for ax in (ii, jj):
            ca = (a * ax).sum() / a.sum()
            cb = (b * ax).sum() / b.sum()
            assert abs(ca - cb) < 0.05  # centroid within 5% of a pixel
            va = (a * (ax - ca) ** 2).sum() / a.sum()
            vb = (b * (ax - cb) ** 2).sum() / b.sum()
            assert abs(va - vb) < 0.01 * max(va, 1.0)

    # weighted totals agree with the surviving-weight sum
    assert res["sum_w"] == pytest.approx(
        float(np.sum(np.asarray(weights) * np.asarray(out.alive))), rel=1e-4)

    # mean-delay map is mean-centred: global weighted mean ~ 0
    m = res["mean_delay"]
    w = res["weight_image"]
    finite = np.isfinite(m)
    gmean = (m[finite] * w[finite]).sum() / w[finite].sum()
    assert abs(gmean) < 1e-3  # fs


def test_fused_dispatch_group_accumulation(setup):
    """>GROUP full chunks exercise the group-partitioned f32 accumulators of
    the one-dispatch fori_loop path (VERDICT r3 #4): 16 chunks -> 2 groups
    must reproduce the single-pass image."""
    chain, elements, det = setup
    spec = chain.source_spec
    kw = dict(bins=(64, 64))
    res_1 = fused_source_images(spec, elements, det, n_total=16384,
                                chunk=1 << 23, **kw)
    res_16 = fused_source_images(spec, elements, det, n_total=16384,
                                 chunk=1024, extent=res_1["extent"], **kw)
    assert res_16["sum_w"] == pytest.approx(res_1["sum_w"], rel=1e-5)
    # 16 small chunks mean more per-chunk spiral-phase rounding (documented
    # ~2e-5 direction envelope), so single-bin hops are more frequent than in
    # the 4-chunk test: compare 3x3-blurred images (absorbs one-bin hops)
    from numpy.lib.stride_tricks import sliding_window_view

    def blur3(a):
        return sliding_window_view(np.pad(a, 1), (3, 3)).sum(axis=(2, 3))

    assert np.abs(res_16["image"] - res_1["image"]).sum() < 0.03 * res_1["sum_w"]
    assert np.abs(blur3(res_16["image"]) - blur3(res_1["image"])).sum() < (
        0.01 * 9 * res_1["sum_w"])
