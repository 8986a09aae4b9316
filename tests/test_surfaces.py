"""Device surface intersections vs. the independent host (np.roots) oracle,
plus reflection-law and normal checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.ops import surfaces as srf
from attosecondraytracing_tpu.ops import trace as tr
from attosecondraytracing_tpu.ops.bundle import make_bundle


def _mirrors():
    return [
        mmirror.MirrorPlane(msupp.SupportRound(20)),
        mmirror.MirrorSpherical(600, msupp.SupportRound(20)),
        mmirror.MirrorParabolic(100, 90, msupp.SupportRound(12)),
        mmirror.MirrorParabolic(25.4, 0, msupp.SupportRectangle(20, 20)),
        mmirror.MirrorToroidal(*mmirror.ReturnOptimalToroidalRadii(500, 80), msupp.SupportRectangle(150, 32)),
        mmirror.MirrorEllipsoidal(msupp.SupportRectangle(80, 30), *mmirror.ReturnOptimalEllipsoidalAxes(600, 75)),
        mmirror.MirrorCylindrical(800, msupp.SupportRectangle(60, 30)),
    ]


def _rays_towards(mirror, rng, n=200):
    """Random rays aimed at the neighborhood of the mirror patch centre,
    coming from the 'up' (+z from the centre) direction."""
    centre = mirror.get_centre()
    n_hat = mirror.get_normal(centre)
    # origin: 100-800 mm away against the normal, with lateral spread
    dist = rng.uniform(100, 800, size=n)
    lateral = rng.normal(scale=20.0, size=(n, 3))
    lateral -= np.outer(lateral @ n_hat, n_hat)
    origins = centre + np.outer(dist, n_hat) + lateral
    # aim at points spread around the centre
    targets = centre + rng.normal(scale=5.0, size=(n, 3))
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


@pytest.mark.parametrize("mirror", _mirrors(), ids=lambda m: m.type.replace(" ", ""))
def test_intersect_matches_host_oracle(mirror, rng):
    origins, dirs = _rays_towards(mirror, rng)
    surface = mirror.surface_params()
    t, hit = srf.intersect(surface, mirror.support, jnp.asarray(origins), jnp.asarray(dirs))
    t = np.asarray(t)
    hit = np.asarray(hit)

    n_hits = 0
    for i in range(len(origins)):
        q_host = mirror._intersect_host(origins[i], dirs[i])
        if q_host is None:
            assert not hit[i], f"ray {i}: device found hit {t[i]}, host found none"
        else:
            assert hit[i], f"ray {i}: host found hit, device missed"
            q_dev = origins[i] + t[i] * dirs[i]
            np.testing.assert_allclose(q_dev, q_host, atol=1e-8)
            n_hits += 1
    assert n_hits > 50, "test geometry produced too few hits to be meaningful"


@pytest.mark.parametrize("mirror", _mirrors(), ids=lambda m: m.type.replace(" ", ""))
def test_normals_match_host(mirror, rng):
    origins, dirs = _rays_towards(mirror, rng, n=50)
    surface = mirror.surface_params()
    t, hit = srf.intersect(surface, mirror.support, jnp.asarray(origins), jnp.asarray(dirs))
    q = np.asarray(origins + np.asarray(t)[:, None] * dirs)
    n_dev = np.asarray(srf.normal_at(surface, jnp.asarray(q)))
    for i in np.nonzero(np.asarray(hit))[0]:
        n_host = mirror.get_normal(q[i])
        np.testing.assert_allclose(n_dev[i], n_host, atol=1e-10)
        assert n_dev[i][2] > 0  # 'up' convention


def test_reflection_law(rng):
    """Angle of incidence equals angle of reflection; energy direction flips
    across the surface."""
    mirror = mmirror.MirrorSpherical(500, msupp.SupportRound(30))
    el = tr.MirrorElement(
        rot=jnp.eye(3),
        position=jnp.zeros(3),
        centre=jnp.asarray(mirror.get_centre()),
        surface=mirror.surface_params(),
        support=mirror.support,
    )
    origins, dirs = _rays_towards(mirror, rng, n=100)
    # to lab frame: element frame == lab shifted by centre
    b = make_bundle(origins - mirror.get_centre(), dirs)
    out = tr.trace(b, [el], keep_history=False)
    alive = np.asarray(out.alive)
    assert alive.sum() > 50
    q = np.asarray(out.p)[alive] + mirror.get_centre()
    d_in = dirs[alive]
    d_out = np.asarray(out.d)[alive]
    inc = np.asarray(out.incidence)[alive]
    for i in range(len(q)):
        n = mirror.get_normal(q[i])
        ang_in = np.arccos(np.clip(-d_in[i] @ n, -1, 1))
        ang_out = np.arccos(np.clip(d_out[i] @ n, -1, 1))
        np.testing.assert_allclose(ang_in, ang_out, atol=1e-10)
        np.testing.assert_allclose(inc[i], ang_in, atol=1e-9)
        # d_in, d_out, n coplanar
        assert abs(np.dot(np.cross(d_in[i], n), d_out[i])) < 1e-9


def test_toroid_float32_accuracy(rng):
    """The Newton-polished float32 toroid intersection stays within ~100 nm of
    the float64 result at 80 deg grazing incidence."""
    mirror = _mirrors()[4]
    origins, dirs = _rays_towards(mirror, rng, n=500)
    surface = mirror.surface_params()
    t64, hit64 = srf.intersect(surface, mirror.support, jnp.asarray(origins), jnp.asarray(dirs))
    t32, hit32 = srf.intersect(
        surface, mirror.support, jnp.asarray(origins, dtype=jnp.float32), jnp.asarray(dirs, dtype=jnp.float32)
    )
    both = np.asarray(hit64) & np.asarray(hit32)
    agree = np.mean(np.asarray(hit64) == np.asarray(hit32))
    assert agree > 0.98  # support-edge rays may flip either way
    err = np.abs(np.asarray(t32)[both] - np.asarray(t64)[both])
    # t is O(100..800 mm): float32 ulp is ~3e-5..6e-5 mm, so a few-ulp error
    # (sub-micron) is the attainable floor
    assert np.median(err) < 3e-4
    assert np.percentile(err, 99) < 1.5e-3


def test_support_inclusion_vectorized():
    supp = msupp.SupportRoundHole(30, 5, 10, 5)
    from attosecondraytracing_tpu.ops import supports as sup

    xs = np.array([0.0, 10.0, 29.0, 31.0, 10.0])
    ys = np.array([0.0, 5.0, 0.0, 0.0, 9.0])
    res = np.asarray(sup.include(supp, xs, ys))
    # (10,5) is the hole centre; (31,0) is outside the disk; (10,9) is 4 mm
    # from the hole centre, i.e. inside the 5 mm hole
    assert list(res) == [True, False, True, False, False]


def test_float32_delay_noise_floor():
    """The float32 production trace stays within a ~0.2 fs delay noise floor
    and sub-um position noise of the float64 reference (README precision
    model; regression gate for future kernel optimizations)."""
    import jax
    from attosecondraytracing_tpu.models.placement import OEPlacement
    from attosecondraytracing_tpu.models.detector import Detector
    from attosecondraytracing_tpu.ops.trace import trace as trace_fn

    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(300, 50))
    props = {"Divergence": 15e-3, "SourceSize": 0, "Wavelength": 50e-6, "DeltaFT": 1, "NumberRays": 2000}
    chain = OEPlacement(props, [tor], [2 * focal], [inc])
    out64 = chain.get_output_rays()[-1]
    det = Detector(chain.optical_elements[0].position)
    det.autoplace(out64, 2 * focal)

    src32 = jax.tree.map(
        lambda x: np.asarray(x).astype(np.float32)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(x),
        chain.source_rays,
    )
    els32 = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    out32 = trace_fn(src32, els32, keep_history=False)
    a = np.asarray(out64.alive) & np.asarray(out32.alive)
    dl64 = np.asarray(det.get_Delays(out64))[a]
    dl32 = np.asarray(det.get_Delays(out32))[a]
    # fs; measured 0.37. Floor set by per-leg intersection-t rounding,
    # ~ulp(1000 mm)/c ~ 0.2 fs per leg (two legs + detector projection).
    # Round-3 note: this used to read 0.197 because to_device(f32) left
    # surface scalars as STRONG np.float64 — under the x64 test env those
    # silently promoted the intersection math to f64, which an accelerator
    # run (no x64) never does. Since round 4 the scalars are weak python floats,
    # so this measures the honest all-f32 floor the hardware actually has.
    assert np.std(dl32 - dl64) < 0.45
    dp = np.asarray(out32.p)[a] - np.asarray(out64.p)[a]
    assert np.std(dp) < 2e-3  # mm


def test_kahan_opl_sign_convention():
    """Regression test for the round-1 sign bug: kahan_add stores the rounding
    *excess* (classic convention), so the refined readout is s - c, never
    s + c. Accumulate 64 metre-scale float32 segments and check that s - c
    recovers the float64 sum to ~1 ulp while s + c roughly doubles the plain
    float32 error."""
    from attosecondraytracing_tpu.ops.geometry import kahan_add

    rng = np.random.default_rng(7)
    xs64 = rng.uniform(900.0, 1100.0, size=64)
    xs32 = xs64.astype(np.float32)
    exact = np.sum(xs32.astype(np.float64))

    s = np.float32(0.0)
    c = np.float32(0.0)
    plain = np.float32(0.0)
    for x in xs32:
        s, c = kahan_add(s, c, x)
        plain = np.float32(plain + x)

    err_fixed = abs(float(s) - float(c) - exact)
    err_old = abs(float(s) + float(c) - exact)
    err_plain = abs(float(plain) - exact)
    ulp = np.spacing(np.float32(exact))
    assert err_fixed <= 1.5 * ulp
    assert err_fixed <= err_plain
    assert err_old >= err_plain  # the old sign is strictly worse than no Kahan


def test_float32_transmission_error_bound():
    """Energy transmission is a headline physics output; the f32 fast toroid
    path may flip individual edge rays' hit/miss, but the resulting
    transmission-% error must stay below 0.1% absolute on the flagship
    grazing chain (mask + 2 toroids at 80 deg) with 1e6 rays
    (reference semantics: getETransmission, ART/ModuleAnalysisAndPlots.py:62-77)."""
    import jax
    from attosecondraytracing_tpu.analysis import stats
    from attosecondraytracing_tpu.models import masks as mmask
    from attosecondraytracing_tpu.models.placement import OEPlacement
    from attosecondraytracing_tpu.ops.trace import trace as trace_fn

    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": 1_000_000}
    chain = OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, inc, -inc], [0, 0, 0])

    src64 = chain.source_rays
    els64 = chain.device_elements()
    out64 = trace_fn(src64, els64, keep_history=False)
    et64 = float(stats.energy_transmission(src64, out64))

    src32 = jax.tree.map(
        lambda x: np.asarray(x).astype(np.float32)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(x),
        src64,
    )
    els32 = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    out32 = trace_fn(src32, els32, keep_history=False)
    et32 = float(stats.energy_transmission(src32, out32))

    assert 0.0 < et64 < 100.0  # the mask and the finite supports both clip
    assert abs(et32 - et64) < 0.1, (et32, et64)


def test_toroid_fast_path_matches_exact_ferrari_solve(monkeypatch):
    """The float32 fast toroid path (paraboloid seed + Newton,
    _toroid_fast_root) must agree with the exact Ferrari solve
    (ART_TPU_TOROID_EXACT mode) on hit masks and roots across geometries
    including extreme grazing and a small minor radius (round-2 advisor
    item: silent fast-path divergence would change transmission)."""
    import jax.numpy as jnp

    from attosecondraytracing_tpu.ops import supports as sup
    from attosecondraytracing_tpu.ops import surfaces as srf

    rng = np.random.default_rng(7)
    cases = [
        (8795.0, 269.0, 150.0, 32.0),   # flagship grazing toroid (80 deg)
        (2000.0, 50.0, 80.0, 20.0),     # small minor radius
        (500.0, 400.0, 60.0, 40.0),     # nearly spherical
        (30000.0, 120.0, 200.0, 30.0),  # extreme grazing (R/r large)
    ]
    for R, r, dimx, dimy in cases:
        surface = srf.Toroid(jnp.float32(R), jnp.float32(r))
        support = sup.RectangleSupport(jnp.float32(dimx), jnp.float32(dimy)) \
            if hasattr(sup, "RectangleSupport") else None
        if support is None:
            from attosecondraytracing_tpu.models.supports import SupportRectangle

            support = SupportRectangle(dimx, dimy)
        n = 4000
        # aim rays from a distant grazing origin at points scattered over
        # (and beyond) the support patch on the z = -(R+r) apex region
        tx = rng.uniform(-0.75 * dimx, 0.75 * dimx, n)
        ty = rng.uniform(-0.75 * dimy, 0.75 * dimy, n)
        rho = np.sqrt(np.maximum((R + r) ** 2 - 0.0, 0.0))
        tz = -(R + r) + tx**2 / (2 * (R + r)) + ty**2 / (2 * r)
        origin = np.array([0.0, 0.0, -(R + r) + 400.0]) + rng.normal(0, 5.0, (n, 3))
        targets = np.stack([tx, ty, tz], axis=-1)
        d = targets - origin
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        q = tuple(jnp.asarray(origin[:, i], jnp.float32) for i in range(3))
        u = tuple(jnp.asarray(d[:, i], jnp.float32) for i in range(3))

        monkeypatch.setattr(srf, "_TOROID_EXACT", False)
        t_fast, hit_fast = srf.intersect_c(surface, support, q, u)
        monkeypatch.setattr(srf, "_TOROID_EXACT", True)
        t_ex, hit_ex = srf.intersect_c(surface, support, q, u)
        # float64 oracle (exact Ferrari in f64): ground truth
        q64 = tuple(jnp.asarray(np.asarray(v), jnp.float64) for v in q)
        u64 = tuple(jnp.asarray(np.asarray(v), jnp.float64) for v in u)
        t_64, hit_64 = srf.intersect_c(surface, support, q64, u64)

        hf, he, h64 = (np.asarray(h) for h in (hit_fast, hit_ex, hit_64))
        # Both f32 paths sit on the same noise floor: surface-frame
        # coordinates are ~(R+r) mm, so one f32 ulp (~1e-3 mm at 9 m) is the
        # size of HIT_TOL and near-boundary decisions flip in BOTH paths.
        # The requirement is that the fast path adds no SYSTEMATIC loss over
        # the exact f32 solve against the f64 oracle.
        err_fast = (hf != h64).mean()
        err_exact = (he != h64).mean()
        assert err_fast <= 2.5 * err_exact + 5e-3, (R, r, err_fast, err_exact)
        both = hf & he
        # targets span +-0.75*dim, beyond the +-0.5*dim support: ~40% hit
        assert both.sum() > 0.3 * n, (R, r, both.sum())
        np.testing.assert_allclose(
            np.asarray(t_fast)[both], np.asarray(t_ex)[both], rtol=2e-5,
            atol=2e-3, err_msg=f"R={R} r={r}")
        # and where both f32 paths agree a hit exists, roots match the oracle
        ok = both & h64
        np.testing.assert_allclose(
            np.asarray(t_fast)[ok], np.asarray(t_64)[ok], rtol=1e-4,
            atol=5e-3, err_msg=f"R={R} r={r} (vs f64 oracle)")


def test_paraboloid_seed_pick_matches_two_division_form(rng):
    """The single-division numerator/denominator seed selection
    (surfaces._paraboloid_seed_pick) must reproduce the reference
    two-division form (_paraboloid_seeds roots + the rank/select chain it
    replaced) on every lane: same selected candidate, seed value equal to a
    few ulp (the _recip reciprocal), and the complex-pair fallback -1."""
    import jax.numpy as jnp

    from attosecondraytracing_tpu.ops import surfaces as srf
    from attosecondraytracing_tpu.ops.precision import T_EPS

    for R, r in [(8795.0, 269.0), (2000.0, 50.0), (500.0, 400.0)]:
        surface = srf.Toroid(jnp.float32(R), jnp.float32(r))
        n = 5000
        # origins near the apex region, directions covering hits, misses,
        # backward rays, and near-axial (a ~ 0) lanes
        origin = np.array([0.0, 0.0, -(R + r) + 300.0]) + rng.normal(0, 40.0, (n, 3))
        d = rng.normal(0, 1.0, (n, 3))
        d[: n // 8, :2] *= 1e-6  # near-axial: quadratic coefficient a -> 0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        q = tuple(jnp.asarray(origin[:, i], jnp.float32) for i in range(3))
        u = tuple(jnp.asarray(d[:, i], jnp.float32) for i in range(3))

        t_new = np.asarray(srf._paraboloid_seed_pick(surface, q, u, T_EPS))

        # reference semantics: sanitize, rank by validity, nearer valid wins
        s1, s2 = srf._paraboloid_seeds(surface, q, u)
        qz, uz = origin[:, 2].astype(np.float32), d[:, 2].astype(np.float32)

        def rank(t):
            t = np.where(np.isfinite(np.asarray(t)), np.asarray(t), -1.0)
            ok = (t > T_EPS) & (qz + t * uz < 0.0)
            return np.where(ok, t, np.inf), t

        r1, s1v = rank(s1)
        r2, s2v = rank(s2)
        t_ref = np.where(r1 <= r2, s1v, s2v)

        # a lane may legitimately differ only where (a) the two candidates tie
        # to float precision (either pick is the same root), or (b) both forms
        # return far-beyond-scene garbage roots (near-axial a ~ 0 lanes whose
        # ~1e18 mm 'roots' the downstream validity test rejects either way)
        close = np.isclose(t_new, t_ref, rtol=5e-6, atol=1e-5)
        tied = np.isclose(s1v, s2v, rtol=1e-5, atol=1e-5)
        garbage = (np.abs(t_new) > 1e9) & (np.abs(t_ref) > 1e9)
        close = close | garbage
        assert (close | tied).all(), (
            R, r, int((~(close | tied)).sum()),
            t_new[~(close | tied)][:5], t_ref[~(close | tied)][:5],
        )
        assert np.isfinite(t_new).all()
