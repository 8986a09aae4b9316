"""Fused scan engine (ops/xla_source.make_xla_moments_fn): every chain of a
structurally-uniform parameter scan runs through ONE compiled XLA program
whose poses are traced inputs, and reproduces the streamed detector path."""

import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.models import masks as mmask
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement
from attosecondraytracing_tpu.ops import moments as pm
from attosecondraytracing_tpu.ops import source as psrc
from attosecondraytracing_tpu.ops import xla_source as xs
from attosecondraytracing_tpu.ops.trace import trace_jit


def _flagship(n_rays=16, divergence=25e-3):
    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": divergence, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": n_rays}
    return OEPlacement(props, [mask, tor, tor], [400, 100, 500],
                       [0, inc, -inc], [0, 0, 0])


def _f32_elements(chain):
    return [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]


def _detector_for(chain, elements, n=20000, offset=-10.0):
    spec = chain.source_spec.baked()
    out = trace_jit(psrc.source_bundle(spec, n, wavelength=80e-6), elements)
    det = Detector(np.zeros(3))
    det.autoplace(out, 500.0 + offset)
    return det


def _stats_of_moments(mom, distances):
    sums = pm.moments_to_distance_sums(mom["moments"], distances,
                                       mom["centre_distance"])
    return pm.sums_to_stats(sums, mom["opl_ref"], distances)


def _detector_path_stats(spec, elements, det, distances, gaussian_edge=None):
    """Reference: streamed trace of the same float32 spiral + Detector
    responses reduced in float64 on the host."""
    out = trace_jit(psrc.source_bundle(spec, N, wavelength=80e-6), elements,
                    keep_history=False)
    w = np.asarray(out.alive, np.float64)
    if gaussian_edge is not None:
        _p, _d, rr = psrc.synth_source_c(
            spec.kind, np.arange(N, dtype=np.float32), N, spec.radius)
        w = w * np.exp(np.log(gaussian_edge) * np.asarray(rr, np.float64))
    spots, sum_w = [], []
    for dist in distances:
        dj = det.copy_detector()
        dj.shiftByDistance(dist)
        xy = np.asarray(dj.get_PointList2D(out), np.float64)
        mean = (w[:, None] * xy).sum(0) / w.sum()
        var = (w[:, None] * (xy - mean) ** 2).sum(0) / w.sum()
        spots.append(float(np.sqrt(var.sum())))
        sum_w.append(w.sum())
    return {"spot_sd": np.array(spots), "sum_w": np.array(sum_w)}


def _assert_stats_close(res_a, res_b, w_rtol=2e-3):
    np.testing.assert_allclose(res_a["sum_w"], res_b["sum_w"], rtol=w_rtol)
    np.testing.assert_allclose(res_a["spot_sd"], res_b["spot_sd"], rtol=5e-3,
                               atol=1e-6)
    for k, r in zip(res_a.get("duration_sd", ()), res_b.get("duration_sd", ())):
        # f32 OPL noise adds in quadrature (same envelope as the stats tests)
        assert abs(k - r) <= 0.03 * r or abs(k * k - r * r) ** 0.5 <= 0.9, (k, r)


N = 20000
DISTANCES = (-10.0, 0.0, 10.0)


@pytest.fixture(scope="module")
def base():
    chain = _flagship(16)
    elements = _f32_elements(chain)
    det = _detector_for(chain, elements)
    return chain, elements, det


def test_scan_kernel_matches_baked_kernel(base):
    """The scan closure (device-resident geometry) reproduces the streamed
    detector path and a fresh one-shot fused pass."""
    chain, elements, det = base
    spec = chain.source_spec.baked()
    fn = xs.make_xla_moments_fn(spec, elements, N)
    mom_scan = fn(det.centre, det.normal, det._plane_rotation())
    mom_ref = xs.xla_source_moments(spec, elements, N, det.centre, det.normal,
                                    det._plane_rotation())
    assert mom_scan["opl_ref"] == pytest.approx(mom_ref["opl_ref"], abs=1e-6)
    np.testing.assert_allclose(mom_scan["moments"], mom_ref["moments"],
                               rtol=1e-6, atol=1e-6)
    _assert_stats_close(_stats_of_moments(mom_scan, DISTANCES),
                        _detector_path_stats(spec, elements, det, DISTANCES))


def test_scan_kernel_gaussian_weights(base):
    chain, elements, det = base
    edge = float(1 / np.e**2)
    spec = chain.source_spec.baked()
    fn = xs.make_xla_moments_fn(spec, elements, N)
    mom_scan = fn(det.centre, det.normal, det._plane_rotation(),
                  gaussian_edge=edge)
    _assert_stats_close(
        _stats_of_moments(mom_scan, DISTANCES),
        _detector_path_stats(spec, elements, det, DISTANCES, edge), w_rtol=1e-4)


def test_scan_kernel_perturbed_chains_one_spec(base):
    """THE scan property: chains perturbed in pose (rotations, shifts, the
    OEPlacement distance axis) evaluate through the SAME compiled program —
    only the traced pose inputs change — and each reproduces its own
    streamed detector path."""
    chain, elements, det = base
    loops = (
        chain.get_OE_loop_list(1, "pitch", [0.02])[0],
        chain.get_OE_loop_list(2, "shift_normal", [0.5])[0],
        chain.get_OE_loop_list(1, "roll", [0.3])[0],
    )
    sizes = []
    for mod in loops:
        els = _f32_elements(mod)
        spec = mod.source_spec.baked()
        fn = xs.make_xla_moments_fn(spec, els, N)
        mom_scan = fn(det.centre, det.normal, det._plane_rotation())
        sizes.append(xs._moments_run._cache_size())
        _assert_stats_close(_stats_of_moments(mom_scan, DISTANCES),
                            _detector_path_stats(spec, els, det, DISTANCES))
    assert sizes[0] == sizes[-1]  # no recompile across the scan


def test_scan_kernel_chunking_matches_single_pass(base):
    """>2^23-ray chunking via the (phase, k_frac) law: two half-range calls
    must sum to the full call."""
    chain, elements, det = base
    spec = chain.source_spec.baked()
    kw = dict(det_centre=det.centre, det_normal=det.normal,
              det_rot=det._plane_rotation())
    full = xs.xla_source_moments(spec, elements, N, **kw)
    half = N // 2
    parts = np.zeros(len(pm.MOMENT_FIELDS))
    for off in (0, half):
        parts += xs.xla_source_moments(
            spec, elements, half, opl_ref=full["opl_ref"],
            phase=float(np.mod(off * psrc.PHI_FRAC, 1.0)), k_frac=off / N,
            n_total=N, **kw)["moments"]
    np.testing.assert_allclose(parts, full["moments"], rtol=1e-4, atol=1e-4)


def test_optimizer_with_scan_moments_fn(base):
    """FindOptimalDistanceFused driven by a scan closure lands on the
    one-shot optimum; last_moments records the surviving weight."""
    from attosecondraytracing_tpu.analysis.optimizer import (
        FindOptimalDistanceFused,
    )

    chain, elements, det = base
    baked_src = chain.source_spec.baked()
    d_ref, spot_ref, _ = FindOptimalDistanceFused(
        baked_src, elements, N, det, OptFor="spotsize", Amplitude=30.0,
        Precision=3)
    rec = {}
    fn = xs.make_xla_moments_fn(baked_src, elements, N)
    d_scan, spot_scan, _ = FindOptimalDistanceFused(
        baked_src, elements, N, det, OptFor="spotsize", Amplitude=30.0,
        Precision=3, moments_fn=fn, last_moments=rec)
    assert d_scan.get_distance() == pytest.approx(d_ref.get_distance(), abs=0.05)
    assert spot_scan == pytest.approx(spot_ref, rel=5e-3, abs=1e-6)
    assert rec["moments"][0] > 0  # surviving weight recorded


def test_total_source_weight_closed_form():
    edge = float(1 / np.e**2)
    n = 12345
    direct = float(np.exp(np.log(edge) * np.arange(n) / n).sum())
    assert psrc.total_source_weight(n, edge) == pytest.approx(direct, rel=1e-12)
    assert psrc.total_source_weight(n, None) == n


def test_scan_scalars_composed_in_float64(base):
    """Contract (bf16/TF32-matmul hazard): the pose inputs of the fused
    engine — the source frame folded into element 0's affine, then one
    affine per element — are composed in float64 on the host and equal an
    independent float64 composition to f32-storage precision. Eager
    reduced-precision device composition would put ~1e-3 rotation errors
    into the traced geometry (~0.5 mm of displacement)."""
    from attosecondraytracing_tpu.ops.trace import MirrorElement, compose_chain

    chain, elements, det = base
    baked_src = chain.source_spec.baked()
    Rs = np.asarray(baked_src.rot, np.float64)
    origin = np.asarray(baked_src.origin, np.float64)
    _els, maps_x, _final, premasks = xs._source_inputs(baked_src, elements)

    maps, _final64 = compose_chain(elements)
    pos0 = np.asarray(elements[0].position, np.float64)
    cen0 = (np.asarray(elements[0].centre, np.float64)
            if isinstance(elements[0], MirrorElement) else np.zeros(3))
    M0, _b0 = maps[0]
    maps = [(np.asarray(M0) @ Rs, np.asarray(M0) @ (origin - pos0) + cen0)] + [
        (np.asarray(M), np.asarray(b)) for M, b in maps[1:]]
    # the leading mask is folded into the first toroid as a premask test
    assert len(premasks[0]) == 1 and len(maps_x) == len(maps) - 1
    M1, b1 = maps[1]
    ref64 = [maps[0], (M1 @ maps[0][0], M1 @ maps[0][1] + b1)] + maps[2:]
    got = [premasks[0][0][1:]] + list(maps_x)
    for (M_ref, b_ref), (M_got, b_got) in zip(ref64, got):
        for ref, g in ((M_ref, M_got), (b_ref, b_got)):
            assert g.dtype == np.float32
            # f32 storage of exact f64 values: error <= 1 ulp of each entry
            ulp = np.maximum(np.abs(ref), 1.0) * 1.2e-7
            np.testing.assert_array_less(np.abs(g - ref), ulp + 1e-12)


def test_scan_kernel_divergence_axis(base):
    """The source divergence is a traced scalar: a divergence scan evaluates
    through the SAME compiled program (no recompile) and matches the
    streamed detector path at the new divergence."""
    chain, elements, det = base
    spec0 = chain.source_spec.baked()
    xs.make_xla_moments_fn(spec0, elements, N)(
        det.centre, det.normal, det._plane_rotation())
    size0 = xs._moments_run._cache_size()
    mod = chain.get_source_loop_list("divergence", [32e-3])[0]
    assert mod.source_spec is not None and mod.source_spec.param == 32e-3
    els = _f32_elements(mod)
    spec = mod.source_spec.baked()
    mom = xs.make_xla_moments_fn(spec, els, N)(
        det.centre, det.normal, det._plane_rotation())
    assert xs._moments_run._cache_size() == size0
    _assert_stats_close(_stats_of_moments(mom, DISTANCES),
                        _detector_path_stats(spec, els, det, DISTANCES))


def test_sharded_scan_moments_match_single_device(base):
    """scan_moments_sharded over the 8-virtual-device mesh == the
    single-device fused moments (same global spiral via per-shard
    (phase, k_frac) offsets; moment rows combined across shards) — the
    multi-device parameter-scan engine."""
    import jax

    from attosecondraytracing_tpu.parallel.mesh import scan_moments_sharded

    chain, elements, det = base
    baked_src = chain.source_spec.baked()
    kw = dict(det_centre=det.centre, det_normal=det.normal,
              det_rot=det._plane_rotation())
    n_total = 16384  # divides over 8 devices
    mom_1 = xs.xla_source_moments(baked_src, elements, n_total, **kw)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("rays",))
    mom_8 = scan_moments_sharded(baked_src, elements, n_total, mesh, **kw)
    assert mom_8["opl_ref"] == mom_1["opl_ref"]
    _assert_stats_close(_stats_of_moments(mom_8, DISTANCES),
                        _stats_of_moments(mom_1, DISTANCES))
    # alignment-constrained kinds refuse (shard offsets would split
    # sub-sources / grid rows)
    for kind in ("extended", "square"):
        with pytest.raises(NotImplementedError):
            scan_moments_sharded(baked_src._replace(kind=kind), elements,
                                 n_total, mesh, **kw)


def test_driver_fused_scan_monte_carlo(monkeypatch):
    """Monte-Carlo tolerancing (every element randomly rotated AND shifted,
    masks included) routes through the fused scan engine and matches the
    per-chain path — the all-poses-traced stress case."""
    import jax

    from attosecondraytracing_tpu import main as amain
    from attosecondraytracing_tpu.models import chain as mchain

    monkeypatch.setattr(mchain, "FUSED_MIN_RAYS", 1024)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(amain, "_CLI_ACTIVE", True)

    sp = {"NumberRays": 4096}
    do = {"AutoDetectorDistance": True, "DistanceDetector": 500.0,
          "OptFor": "spotsize"}
    ao = {"verbose": False, "save_results": False}

    # one chain list, reused by both paths: rotate_random_by draws its axis
    # from the GLOBAL NumPy RNG, so rebuilding would give different chains
    rng = np.random.default_rng(11)
    chains = _flagship(4096).get_OE_random_loop_list(0.05, 0.2, 3, rng=rng)
    kept = amain.main(chains, sp, do, ao)
    assert all(c.last_trace_engine == "xla-scan" for c in chains)

    monkeypatch.setattr(amain, "_prepare_fused_scan", lambda *a: None)
    kept_ref = amain.main(chains, sp, do, ao)
    # randomly misaligned chains are astigmatic: the spot-vs-distance valley
    # is flat over ~mm, so allow the distance a little slack
    for d_f, d_r in zip(kept["Detector"], kept_ref["Detector"]):
        assert d_f.get_distance() == pytest.approx(d_r.get_distance(), abs=1.0)
    np.testing.assert_allclose(kept["ETransmission"], kept_ref["ETransmission"],
                               rtol=0.02)
    np.testing.assert_allclose(kept["SpotSizeSD"], kept_ref["SpotSizeSD"],
                               rtol=0.1, atol=5e-4)
