"""In-jit ExtendedSource (VERDICT r3 #9): the nested-spiral index decode
(ops/source.synth_source_c) must reproduce the host ExtendedSource bundle
and unlock every fused engine for the last source kind."""

import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement
from attosecondraytracing_tpu.ops import moments as pm
from attosecondraytracing_tpu.ops import source as pt
from attosecondraytracing_tpu.ops import xla_source as xs
from attosecondraytracing_tpu.ops.trace import trace_jit

DIAMETER = 0.2   # mm -> 50 sub-sources
DIV = 20e-3      # rad
N_REQ = 30000


def _extended_chain(n_rays=N_REQ):
    """OAP illuminated by an extended source (Divergence>0, SourceSize>0)."""
    support = msupp.SupportRound(30)
    mirror = mmirror.MirrorParabolic(FocalEffective=200, OffAxisAngle=90,
                                     Support=support)
    props = {"Divergence": DIV, "SourceSize": DIAMETER, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": n_rays}
    return OEPlacement(props, [mirror], [300.0], [0.0], [0.0], "extended")


def test_placement_attaches_extended_spec():
    chain = _extended_chain()
    spec = chain.source_spec
    assert spec is not None and spec.kind == "extended"
    baked = spec.baked()
    assert baked.n_sources * baked.n_each == chain.source_rays.n_rays
    assert spec.n_rays == chain.source_rays.n_rays
    assert baked.pos_radius == pytest.approx(DIAMETER / 2)
    assert baked.radius == pytest.approx(np.tan(DIV))
    # the count heuristics are a fixed point of re-deriving from the emitted
    # count (FusedSourceInfo stores emitted rays, not the requested NbRays)
    from attosecondraytracing_tpu.ops.host_geometry import extended_source_counts

    ns, ne = extended_source_counts(DIAMETER, spec.n_rays)
    assert (ns, ne) == (baked.n_sources, baked.n_each)


def test_source_bundle_matches_host_extended():
    """The float32 exact-index synthesis reproduces the host NumPy
    ExtendedSource ray for ray (same (i, j) decode, same spirals)."""
    from attosecondraytracing_tpu.models import sources as msource

    chain = _extended_chain()
    spec = chain.source_spec
    baked = spec.baked()
    n = spec.n_rays
    host = msource.ExtendedSource(np.zeros(3), np.array([1.0, 0, 0]),
                                  DIAMETER, DIV, N_REQ)
    synth = pt.source_bundle(baked, n, wavelength=spec.wavelength)
    assert host.n_rays == n
    np.testing.assert_allclose(np.asarray(synth.p), np.asarray(host.p),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(synth.d), np.asarray(host.d),
                               atol=5e-5)


def test_pallas_trace_source_extended_matches_xla(monkeypatch):
    """engine='xla-source' on an extended-source chain runs the in-jit
    synthesis and agrees with the streamed trace of the host bundle."""
    chain = _extended_chain()
    out_xla = chain.trace_final(engine="xla")
    out_pl = chain.trace_final(engine="xla-source")
    assert chain.last_trace_engine == "xla-source"
    a_x, a_p = np.asarray(out_xla.alive), np.asarray(out_pl.alive)
    assert abs(a_x.sum() - a_p.sum()) <= 0.01 * a_x.sum() + 5
    px = np.asarray(out_xla.p)[a_x]
    pp = np.asarray(out_pl.p)[a_p]
    np.testing.assert_allclose(px.mean(axis=0), pp.mean(axis=0), atol=2e-3)
    np.testing.assert_allclose(px.std(axis=0), pp.std(axis=0), rtol=5e-3,
                               atol=2e-3)


def test_extended_stats_kernel_matches_detector_path():
    """Fused trace->moments with the extended source + Gaussian weights
    reproduces the two-pass detector statistics."""
    chain = _extended_chain()
    spec = chain.source_spec
    baked = spec.baked()
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    n = spec.n_rays
    src = pt.source_bundle(baked, n, wavelength=spec.wavelength)
    out = trace_jit(src, elements, keep_history=False)
    det = Detector(np.zeros(3))
    det.autoplace(out, 195.0)
    edge = float(1 / np.e**2)
    res = xs.xla_source_detector_stats(
        baked, elements, n, det.centre, det.normal, det._plane_rotation(),
        distances=(-4.0, 0.0, 4.0), gaussian_edge=edge)
    # reference weights: the cone-angle law per sub-source ray
    kf = np.arange(n)
    rj = kf % baked.n_each
    w = np.exp(np.log(edge) * (rj / baked.n_each)) * np.asarray(out.alive)
    xy = np.asarray(det.get_PointList2D(out), np.float64)
    for j, dist in enumerate((-4.0, 0.0, 4.0)):
        dj = det.copy_detector()
        dj.shiftByDistance(dist)
        xyj = np.asarray(dj.get_PointList2D(out), np.float64)
        mean = (w[:, None] * xyj).sum(0) / w.sum()
        var = (w[:, None] * (xyj - mean) ** 2).sum(0) / w.sum()
        spot_ref = float(np.sqrt(var.sum()))
        assert res["spot_sd"][j] == pytest.approx(spot_ref, rel=5e-3), dist
    assert res["sum_w"][0] == pytest.approx(w.sum(), rel=1e-3)


def test_extended_chunking_aligns_to_sub_sources():
    chain = _extended_chain()
    baked = chain.source_spec.baked()
    n = chain.source_spec.n_rays
    chunks = pt.source_chunks("extended", n, n, baked.n_each,
                              baked.n_sources, chunk=4 * baked.n_each)
    assert sum(c[0] for c in chunks) == n
    for k, (n_local, phase, k_frac) in enumerate(chunks):
        assert n_local % baked.n_each == 0 or k == len(chunks) - 1
    # chunked moments == single pass
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    src = pt.source_bundle(baked, n)
    out = trace_jit(src, elements, keep_history=False)
    det = Detector(np.zeros(3))
    det.autoplace(out, 195.0)
    kw = dict(det_centre=det.centre, det_normal=det.normal,
              det_rot=det._plane_rotation())
    full = xs.xla_source_moments(baked, elements, n, **kw)
    parts = np.zeros(len(pm.MOMENT_FIELDS))
    for n_local, phase, k_frac in chunks:
        m = xs.xla_source_moments(
            baked, elements, n_local, phase=phase, k_frac=k_frac,
            n_total=n, opl_ref=full["opl_ref"], **kw)
        parts += m["moments"]
    np.testing.assert_allclose(parts, full["moments"], rtol=1e-4, atol=1e-4)


def test_extended_resize_source():
    chain = _extended_chain()
    chain.resize_source(60000)
    spec = chain.source_spec
    assert spec.kind == "extended"
    assert chain.source_rays.n_rays == spec.n_rays
    baked = spec.baked()
    assert baked.n_sources * baked.n_each == spec.n_rays


def test_divmod_exact_decode():
    """The float div-mod decode is exact over the full chunk range."""
    import jax

    n_each = 333
    kf = jnp.asarray(
        np.concatenate([np.arange(0, 5000),
                        np.arange((1 << 23) - 5000, 1 << 23)]), jnp.float32)
    q, r = jax.jit(lambda k: pt._divmod_exact(k, n_each))(kf)
    k64 = np.asarray(kf, np.int64)
    np.testing.assert_array_equal(np.asarray(q, np.int64), k64 // n_each)
    np.testing.assert_array_equal(np.asarray(r, np.int64), k64 % n_each)
