"""In-jit 'square' source kind (VERDICT r4 #6): the grid-index decode
(ops/source.synth_source_c kind='square') must reproduce the host
PlaneWaveSquare bundle and unlock the fused engines for the last source kind
outside the fused universe (the reference's PlaneWaveSquare intent,
ART/ModuleSource.py:173-207 — broken there, fixed in models.sources)."""

import numpy as np
import pytest

from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import sources as msource
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.chain import OpticalChain
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.elements import OpticalElement
from attosecondraytracing_tpu.ops import source as pt
from attosecondraytracing_tpu.ops import xla_source as xs
from attosecondraytracing_tpu.ops.trace import trace_jit

SIDE = 12.0     # mm
N_REQ = 10000   # -> 100x100 grid
WL = 800e-6


def _square_chain(n_rays=N_REQ):
    """On-axis parabola illuminated by a collimated square grid."""
    bundle, spec = msource.PlaneWaveSquareFused(
        np.zeros(3), np.array([1.0, 0.0, 0.0]), SIDE, n_rays,
        Wavelength=WL, gaussian_edge=float(1 / np.e**2))
    support = msupp.SupportRectangle(30, 30)
    mirror = mmirror.MirrorParabolic(FocalEffective=100, OffAxisAngle=0,
                                     Support=support)
    el = OpticalElement(mirror, np.array([50.0, 0.0, 0.0]),
                        np.array([-1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]))
    return OpticalChain(bundle, [el], "square chain", source_spec=spec)


def test_fused_helper_attaches_square_spec():
    chain = _square_chain()
    spec = chain.source_spec
    assert spec is not None and spec.kind == "square"
    baked = spec.baked()
    assert baked.kind == "square"
    assert baked.n_each == 100                      # grid side
    assert baked.radius == pytest.approx(SIDE)      # side length
    assert spec.n_rays == chain.source_rays.n_rays == 100 * 100


def test_source_bundle_matches_host_square():
    """The float32 exact-index synthesis reproduces the host NumPy
    PlaneWaveSquare ray for ray (same (row, col) decode, same linspace)."""
    chain = _square_chain()
    spec = chain.source_spec
    baked = spec.baked()
    n = spec.n_rays
    host = msource.PlaneWaveSquare(np.zeros(3), np.array([1.0, 0.0, 0.0]),
                                   SIDE, N_REQ)
    synth = pt.source_bundle(baked, n, wavelength=WL)
    assert host.n_rays == n
    np.testing.assert_allclose(np.asarray(synth.p), np.asarray(host.p),
                               atol=5e-6)
    np.testing.assert_allclose(np.asarray(synth.d), np.asarray(host.d),
                               atol=1e-7)


def test_square_gaussian_weights_match_host():
    """In-jit weight law edge**rr (corner-normalized) == the host
    ApplyGaussianIntensityToRayList profile on the same grid."""
    chain = _square_chain()
    spec = chain.source_spec
    baked = spec.baked()
    n = spec.n_rays
    host = msource.ApplyGaussianIntensityToRayList(
        msource.PlaneWaveSquare(np.zeros(3), np.array([1.0, 0.0, 0.0]),
                                SIDE, N_REQ), spec.gaussian_edge)
    _p, _d, rr = pt.synth_source_c(
        "square", np.arange(n, dtype=np.float32), n, baked.radius,
        n_each=baked.n_each)
    w = np.exp(np.log(spec.gaussian_edge) * np.asarray(rr, np.float64))
    np.testing.assert_allclose(w, np.asarray(host.intensity), atol=1e-6)


def test_square_chunking_covers_grid_by_rows():
    """source_chunks aligns 'square' chunks to whole grid rows and offsets
    the row index through the phase slot — the union of chunked syntheses
    equals the one-shot grid."""
    baked = pt.make_source_spec("square", np.zeros(3), np.array([0, 0, 1.0]),
                                SIDE, n_rays=64 * 64)
    n = 64 * 64
    chunks = pt.source_chunks("square", n, n, n_each=baked.n_each,
                              n_sources=0, chunk=1000)
    assert sum(c[0] for c in chunks) == n
    for n_local, phase, k_frac in chunks:
        assert n_local % 64 == 0 and k_frac == 0.0
        assert phase == int(phase)  # integer row offsets
    full = pt.source_bundle(baked, n)
    parts = [
        pt.source_bundle(baked, n_local, phase=phase, k_frac=k_frac, n_total=n)
        for n_local, phase, k_frac in chunks
    ]
    p_union = np.concatenate([np.asarray(b.p) for b in parts])
    np.testing.assert_allclose(p_union, np.asarray(full.p), atol=1e-6)


def test_square_moments_match_streamed_trace():
    """The fused moment engine on a 'square' chain == host-bundle trace +
    float64 moment reduction (the same parity contract the other kinds
    carry)."""
    chain = _square_chain()
    spec = chain.source_spec
    baked = spec.baked()
    elements = [e.to_device(dtype=np.float32) for e in chain.optical_elements]
    out = trace_jit(chain.source_rays, elements, keep_history=False)
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(out, 100.0)
    mom = xs.xla_source_moments(
        baked, elements, spec.n_rays, det.centre, det.normal,
        det._plane_rotation(), gaussian_edge=spec.gaussian_edge)
    # reference moment 0: total surviving Gaussian weight of the host trace
    alive = np.asarray(out.alive)
    w_host = np.asarray(chain.source_rays.intensity, np.float64)
    np.testing.assert_allclose(mom["moments"][0], w_host[alive].sum(),
                               rtol=2e-3)


def test_square_scan_engine_parity():
    """A square chain evaluates through the fused scan closure
    (device-resident geometry) and reproduces the streamed detector path's
    spot statistics at several distances."""
    from attosecondraytracing_tpu.ops import moments as pm

    chain = _square_chain()
    baked = chain.source_spec.baked()
    elements = [e.to_device(dtype=np.float32) for e in chain.optical_elements]
    out = trace_jit(pt.source_bundle(baked, chain.source_spec.n_rays,
                                     wavelength=WL), elements,
                    keep_history=False)
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(out, 97.0)
    n = chain.source_spec.n_rays
    fn = xs.make_xla_moments_fn(baked, elements, n)
    mom = fn(det.centre, det.normal, det._plane_rotation())
    distances = (-2.0, 0.0, 2.0)
    res = pm.sums_to_stats(
        pm.moments_to_distance_sums(mom["moments"], distances,
                                    mom["centre_distance"]),
        mom["opl_ref"], distances)
    alive = np.asarray(out.alive)
    for j, dist in enumerate(distances):
        dj = det.copy_detector()
        dj.shiftByDistance(dist)
        xy = np.asarray(dj.get_PointList2D(out), np.float64)[alive]
        spot_ref = float(np.sqrt(xy.var(axis=0).sum()))
        assert res["spot_sd"][j] == pytest.approx(spot_ref, rel=5e-3), dist
    assert res["sum_w"][0] == pytest.approx(alive.sum(), rel=1e-6)


def test_square_total_source_weight_closed_form():
    edge = float(1 / np.e**2)
    n_side = 57
    xs = np.linspace(-0.5, 0.5, n_side)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    rr = 2.0 * (X**2 + Y**2)
    direct = float(np.exp(np.log(edge) * rr).sum())
    got = pt.total_source_weight(n_side * n_side, edge, n_each=n_side,
                                 kind="square")
    assert got == pytest.approx(direct, rel=1e-12)


def test_driver_scan_routes_square_chains_through_scan_engine(monkeypatch):
    """A pitch scan of square-source chains runs the fused scan engine
    end to end through the driver (the last source kind joining the fused
    scan universe, VERDICT r4 #6)."""
    from attosecondraytracing_tpu import main as amain
    from attosecondraytracing_tpu.models import chain as mchain

    import jax

    monkeypatch.setattr(mchain, "FUSED_MIN_RAYS", 1024)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(amain, "_CLI_ACTIVE", True)

    chains = _square_chain(4096).get_OE_loop_list(
        0, "pitch", np.linspace(-0.05, 0.05, 3))
    sp = {"NumberRays": chains[0].source_spec.n_rays}
    do = {"AutoDetectorDistance": True, "DistanceDetector": 100.0,
          "OptFor": "spotsize"}
    ao = {"verbose": False, "save_results": False}
    kept = amain.main(chains, sp, do, ao)
    assert all(c.last_trace_engine == "xla-scan" for c in chains)
    # tilting the mirror moves the focus: distances stay near f=100 and the
    # middle (aligned) chain focuses tightest
    dists = [d.get_distance() for d in kept["Detector"]]
    assert all(90.0 < d < 110.0 for d in dists)
    spots = kept["SpotSizeSD"]
    assert spots[1] <= min(spots[0], spots[2]) + 1e-9


def test_square_trace_final_uses_fused_engine(monkeypatch):
    """trace_final routes a square chain to the fused-source engine, and
    resize_source regenerates the grid from the spec."""
    from attosecondraytracing_tpu.models import chain as mchain

    monkeypatch.setattr(mchain, "FUSED_MIN_RAYS", 1024)
    chain = _square_chain()
    chain.resize_source(4096)
    assert chain.source_rays.n_rays == 64 * 64
    assert chain.source_spec.n_rays == 64 * 64
    out_fused = chain.trace_final(engine="xla-source")
    assert chain.last_trace_engine == "xla-source"
    ref = trace_jit(chain.source_rays,
                    [e.to_device() for e in chain.optical_elements],
                    keep_history=False)
    alive = np.asarray(ref.alive)
    np.testing.assert_array_equal(np.asarray(out_fused.alive), alive)
    np.testing.assert_allclose(np.asarray(out_fused.p)[alive],
                               np.asarray(ref.p)[alive], atol=2e-3)
