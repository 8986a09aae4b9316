"""XLA fused-source engine (ops/xla_source.py): in-jit source synthesis +
chained-frame trace + moment epilogue, grid defects included (VERDICT r3
#3)."""

import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.models import defects as mdef
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement
from attosecondraytracing_tpu.ops import moments as pm
from attosecondraytracing_tpu.ops import source as psrc
from attosecondraytracing_tpu.ops import xla_source as xs
from attosecondraytracing_tpu.ops.trace import trace_jit


def _deformed_chain(n_rays=16, rms=1e-4):
    """An OAP with a Fourrier (grid-interpolated) surface-defect map — the
    CONFIG_deformed class of chain (gathers from a defect grid)."""
    support = msupp.SupportRound(25)
    mirror = mmirror.MirrorParabolic(FocalEffective=150, OffAxisAngle=90,
                                     Support=support)
    defect = mdef.Fourrier(support, RMS=rms, smallest=0.5, seed=12345)
    deformed = mmirror.DeformedMirror(mirror, [defect])
    props = {"Divergence": 0, "SourceSize": 60, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": n_rays}
    return OEPlacement(props, [deformed], [200.0], [0.0], [0.0], "deformed")


def _f32(chain):
    return [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]


N = 20000


@pytest.fixture(scope="module")
def deformed():
    chain = _deformed_chain()
    elements = _f32(chain)
    spec = chain.source_spec
    assert spec is not None and spec.kind == "disk"
    baked = spec.baked()
    src = psrc.source_bundle(baked, N, wavelength=80e-6)
    # slope reflection ON (ignore_defects=False): that is what makes a
    # defect-bearing chain physically different, and what the engine must
    # carry through the gathers
    out = trace_jit(src, elements, ignore_defects=False, keep_history=False)
    det = Detector(np.zeros(3))
    # 8 mm short of the focus: spots are tens of um, far above the f32
    # conditioning floor of BOTH the lab-frame reference path and the
    # patch-relative moment path (at the exact focus the two floors differ)
    det.autoplace(out, 142.0)
    return chain, elements, spec, baked, out, det


def test_xla_trace_source_matches_streamed_trace(deformed):
    """Same float32 spiral through chained-frame (in-jit source) vs the
    streamed lab-frame trace: statistics must agree to f32 reassociation."""
    chain, elements, spec, baked, out_ref, det = deformed
    out = xs.xla_trace_source(baked, elements, N, wavelength=80e-6,
                              ignore_defects=False)
    a_r, a_x = np.asarray(out_ref.alive), np.asarray(out.alive)
    assert abs(a_r.sum() - a_x.sum()) <= 0.005 * a_r.sum() + 5
    pr = np.asarray(out_ref.p)[a_r]
    px = np.asarray(out.p)[a_x]
    np.testing.assert_allclose(pr.mean(axis=0), px.mean(axis=0), atol=2e-3)
    np.testing.assert_allclose(pr.std(axis=0), px.std(axis=0), rtol=5e-3,
                               atol=2e-3)
    # the defect must actually be in the trace: at the FOCUS, the undeformed
    # mirror refocuses to a point while the defect slopes blur it widely
    plain = _deformed_chain(rms=0.0)
    out_plain = xs.xla_trace_source(plain.source_spec.baked(), _f32(plain), N,
                                    wavelength=80e-6, ignore_defects=False)
    det_f = Detector(np.zeros(3))
    det_f.autoplace(out_plain, 150.0)
    xyr = np.asarray(det_f.get_PointList2DCentre(out))
    xyp = np.asarray(det_f.get_PointList2DCentre(out_plain))
    sd_def = float(xyr[np.asarray(out.alive)].std())
    sd_plain = float(xyp[np.asarray(out_plain.alive)].std())
    assert sd_def > 5.0 * sd_plain


def test_xla_source_moments_match_detector_path(deformed):
    chain, elements, spec, baked, out_ref, det = deformed
    mom = xs.xla_source_moments(baked, elements, N, det.centre, det.normal,
                                det._plane_rotation(), ignore_defects=False)
    distances = (-5.0, 0.0, 5.0)
    sums = pm.moments_to_distance_sums(mom["moments"], distances,
                                       mom["centre_distance"])
    res = pm.sums_to_stats(sums, mom["opl_ref"], distances)
    for j, dist in enumerate(distances):
        dj = det.copy_detector()
        dj.shiftByDistance(dist)
        spot, dur = (float(v) for v in dj.get_SpotAndDuration(out_ref))
        assert res["spot_sd"][j] == pytest.approx(spot, rel=5e-3, abs=1e-6)
        k = float(res["duration_sd"][j])
        assert abs(k - dur) <= 0.03 * dur or abs(k * k - dur * dur) ** 0.5 <= 0.9
    assert res["sum_w"][0] == pytest.approx(float(np.asarray(out_ref.alive).sum()),
                                            rel=5e-3)


def test_xla_moments_chunking(deformed, monkeypatch):
    """The chunk law applies: with a small chunk size the internal chunk loop
    (several engine calls at (phase, k_frac) offsets, moments summed in
    float64) reproduces the one-pass moments, and the chunked bundle trace
    concatenates to the one-pass bundle."""
    chain, elements, spec, baked, out_ref, det = deformed
    args = (baked, elements, N, det.centre, det.normal, det._plane_rotation())
    full = xs.xla_source_moments(*args)
    bundle = xs.xla_trace_source(baked, elements, N, ignore_defects=False)
    assert xs.CHUNK == 1 << 23  # the production chunk size
    monkeypatch.setattr(xs, "CHUNK", 6000)  # 20000 rays -> 4 chunks
    chunked = xs.xla_source_moments(*args, opl_ref=full["opl_ref"])
    np.testing.assert_allclose(chunked["moments"], full["moments"],
                               rtol=1e-4, atol=1e-4)
    bundle_c = xs.xla_trace_source(baked, elements, N, ignore_defects=False)
    assert bundle_c.n_rays == N
    a_1, a_c = np.asarray(bundle.alive), np.asarray(bundle_c.alive)
    assert (a_1 == a_c).mean() > 0.999
    a = a_1 & a_c
    # chunk offsets re-split the golden-angle digits: ~2e-5 of direction
    # (ops/source._vogel_xy_c) over a ~200 mm lever arm
    dp = np.abs(np.asarray(bundle_c.p)[a] - np.asarray(bundle.p)[a])
    assert np.median(dp) < 1e-4 and dp.max() < 1e-2, (np.median(dp), dp.max())


def test_optimizer_with_xla_moments_fn(deformed):
    """The defect chain gets the one-pass moment optimizer through the XLA
    engine and lands where the bundle optimizer lands."""
    from attosecondraytracing_tpu.analysis.optimizer import (
        FindOptimalDistance,
        FindOptimalDistanceFused,
    )

    chain, elements, spec, baked, out_ref, det = deformed
    d_ref, spot_ref, _ = FindOptimalDistance(
        det, out_ref, OptFor="spotsize", Amplitude=20.0, Precision=2)
    fn = xs.make_xla_moments_fn(baked, elements, N, ignore_defects=False)
    d_x, spot_x, _ = FindOptimalDistanceFused(
        baked, elements, N, det, OptFor="spotsize", Amplitude=20.0,
        Precision=3, moments_fn=fn)
    assert d_x.get_distance() == pytest.approx(d_ref.get_distance(), abs=0.2)
    assert spot_x == pytest.approx(spot_ref, rel=2e-2, abs=1e-5)


def test_trace_final_engine_xla_source(deformed):
    chain, elements, spec, baked, out_ref, det = deformed
    out = chain.trace_final(engine="xla-source")
    assert chain.last_trace_engine == "xla-source"
    a_r, a_x = np.asarray(out_ref.alive), np.asarray(out.alive)
    # trace_final uses the chain's own ray count (16), so just smoke-check
    assert out.n_rays == chain.source_rays.n_rays
    assert np.asarray(out.alive).any()


def test_driver_xla_scan_engine(monkeypatch, capsys):
    """A structurally-uniform DEFECT-chain scan routes through the XLA
    fused-source scan engine on a (reported) GPU backend and matches the
    per-chain path."""
    import jax

    from attosecondraytracing_tpu import main as amain
    from attosecondraytracing_tpu.models import chain as mchain

    monkeypatch.setattr(mchain, "FUSED_MIN_RAYS", 1024)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(amain, "_CLI_ACTIVE", True)

    sp = {"NumberRays": 4096}
    do = {"AutoDetectorDistance": True, "DistanceDetector": 150.0,
          "OptFor": "spotsize"}
    ao = {"verbose": True, "save_results": False}

    def scan_chains():
        return _deformed_chain(4096).get_OE_loop_list(
            0, "pitch", np.linspace(-0.1, 0.1, 3))

    chains = scan_chains()
    kept = amain.main(chains, sp, do, ao)
    assert all(c.last_trace_engine == "xla-scan" for c in chains)

    monkeypatch.setattr(amain, "_prepare_fused_scan", lambda *a: None)
    chains_ref = scan_chains()
    kept_ref = amain.main(chains_ref, sp, do, ao)
    for d_f, d_r in zip(kept["Detector"], kept_ref["Detector"]):
        assert d_f.get_distance() == pytest.approx(d_r.get_distance(), abs=0.5)
    np.testing.assert_allclose(kept["ETransmission"], kept_ref["ETransmission"],
                               rtol=0.02)
