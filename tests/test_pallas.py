"""Chained-frame fused-source engine vs the streamed trace: the same
component step functions, so identical results up to float32
reassociation; and the premask folding that the chained-frame engine
relies on."""

import numpy as np
import jax.numpy as jnp

from attosecondraytracing_tpu.models import mirrors as mmirror, masks as mmask, supports as msupp
from attosecondraytracing_tpu.models.placement import OEPlacement


def _cast32(b):
    import jax
    return jax.tree.map(
        lambda x: np.asarray(x).astype(np.float32) if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x),
        b,
    )


def _chained_and_streamed(chain, ignore_defects=True):
    """The same float32 bundle (the spec's own spiral) through the
    chained-frame fused-source engine and the streamed lab-frame trace."""
    from attosecondraytracing_tpu.ops.source import source_bundle
    from attosecondraytracing_tpu.ops.trace import trace
    from attosecondraytracing_tpu.ops.xla_source import xla_trace_source

    spec = chain.source_spec.baked()
    n = chain.source_rays.n_rays
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    out_x = trace(source_bundle(spec, n, wavelength=chain.source_spec.wavelength),
                  elements, ignore_defects=ignore_defects, keep_history=False)
    out_c = xla_trace_source(spec, elements, n,
                             wavelength=chain.source_spec.wavelength,
                             ignore_defects=ignore_defects)
    return out_x, out_c


def test_pallas_zernike_defect_parity():
    """Zernike-deformed chains trace on the chained-frame fused-source engine
    (in-jit polynomial defect evaluation) and agree ray-for-ray with the
    streamed trace, both with and without slope composition
    (ignore_defects)."""
    from attosecondraytracing_tpu.models import defects as mdef
    from attosecondraytracing_tpu.ops.trace import trace

    support = msupp.SupportRound(20)
    base = mmirror.MirrorParabolic(100, 90, support)
    defect = mdef.Zernike(support, {(2, 0): 2e-4, (3, 1): -1e-4, (4, 2): 5e-5})
    deformed = mmirror.DeformedMirror(base, [defect])
    props = {"Divergence": 0, "SourceSize": 30, "Wavelength": 50e-6,
             "DeltaFT": 1.0, "NumberRays": 1500}
    chain = OEPlacement(props, [deformed], [200.0], [0.0])
    for ignore in (True, False):
        out_x, out_c = _chained_and_streamed(chain, ignore_defects=ignore)
        ax, ac = np.asarray(out_x.alive), np.asarray(out_c.alive)
        assert (ax == ac).mean() > 0.999
        alive = ax & ac
        assert alive.sum() > 1000
        np.testing.assert_allclose(
            np.asarray(out_c.p)[alive], np.asarray(out_x.p)[alive], atol=2e-3)
        np.testing.assert_allclose(
            np.asarray(out_c.d)[alive], np.asarray(out_x.d)[alive], atol=2e-5)
    # the defect must actually matter (slope composition changes directions)
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    src = _cast32(chain.source_rays)
    out_ig = trace(src, elements, ignore_defects=True, keep_history=False)
    out_no = trace(src, elements, ignore_defects=False, keep_history=False)
    a = np.asarray(out_ig.alive) & np.asarray(out_no.alive)
    assert np.abs(np.asarray(out_ig.d)[a] - np.asarray(out_no.d)[a]).max() > 1e-5


def test_pallas_mixed_surface_chain_fuzz():
    """Every surface type through the chained-frame fused-source engine in
    ONE chain, over several randomized source divergences and
    misalignments: parity with the streamed trace on alive masks, impacts,
    directions, and OPL. Covers the surface-specific intersect/normal
    branches (plane, sphere, parabola, ellipsoid, cylinder, toroid + mask)
    that the flagship-chain tests don't reach."""
    rng = np.random.default_rng(3)
    R, r = mmirror.ReturnOptimalToroidalRadii(500.0, 75.0)
    optics = [
        mmask.Mask(msupp.SupportRoundHole(30, 4, 0, 0)),
        mmirror.MirrorPlane(msupp.SupportRectangle(60, 60)),
        mmirror.MirrorSpherical(4000.0, msupp.SupportRound(30)),
        mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32)),
        mmirror.MirrorCylindrical(3000.0, msupp.SupportRectangle(60, 40)),
        mmirror.MirrorParabolic(300.0, 15.0, msupp.SupportRound(25)),
        mmirror.MirrorEllipsoidal(
            msupp.SupportRound(20), OffAxisAngle=20.0, f_object=600.0, f_image=300.0
        ),
    ]
    distances = [350.0, 300.0, 600.0, 450.0, 500.0, 350.0, 620.0]
    incidences = [0.0, 40.0, 10.0, 75.0, 8.0, 0.0, 0.0]

    for trial in range(3):
        div = float(rng.uniform(0.5e-3, 3e-3))
        props = {"Divergence": div, "SourceSize": 0, "Wavelength": 50e-6,
                 "DeltaFT": 0.5, "NumberRays": 1200}
        chain = OEPlacement(props, optics, distances, incidences,
                            [0.0] * len(optics))
        if trial:
            k = int(rng.integers(1, len(optics)))
            chain.rotate_OE(k, "pitch", float(rng.normal(0, 0.02)))
            chain.shift_OE(k, "normal", float(rng.normal(0, 0.05)))
        out_x, out_c = _chained_and_streamed(chain)
        ax, ac = np.asarray(out_x.alive), np.asarray(out_c.alive)
        # float32 reassociation can flip support-edge hits; require ~identical
        # masks and enough survivors that the comparison is meaningful
        assert (ax == ac).mean() > 0.995, (trial, (ax != ac).sum())
        a = ax & ac
        assert a.sum() > 300, (trial, a.sum())
        dp = np.abs(np.asarray(out_c.p)[a] - np.asarray(out_x.p)[a])
        assert np.median(dp) < 2e-3 and dp.max() < 0.1, (trial, np.median(dp), dp.max())
        np.testing.assert_allclose(
            np.asarray(out_c.d)[a], np.asarray(out_x.d)[a], atol=5e-5)
        np.testing.assert_allclose(
            np.asarray(out_c.opl)[a], np.asarray(out_x.opl)[a], atol=0.2)


def test_premask_folding_semantics():
    """fold_premasks: non-terminal masks become alive-predicates with their
    frame map composed into the next element's affine. Checks (on the
    chained-frame XLA reference, f64 so rounding cannot blur the comparison):
    identical alive masks and identical alive-ray outputs vs the unfolded
    chain, a terminal mask is never folded, and consecutive masks compose."""
    import jax

    from attosecondraytracing_tpu.ops.trace import (
        bundle_to_state, compose_chain, fold_premasks, run_chain_chained,
        state_to_bundle, MaskElement,
    )

    # chain with TWO consecutive masks then two toroids, plus a terminal mask
    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask1 = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    mask2 = mmask.Mask(msupp.SupportRoundHole(25, 5, 1.0, 0.5))
    mask3 = mmask.Mask(msupp.SupportRoundHole(30, 10, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": 2000}
    chain = OEPlacement(props, [mask1, mask2, tor, tor, mask3],
                        [300, 80, 120, 100, 2 * focal],
                        [0, 0, inc, -inc, 0], [0, 0, 0, 0, 0])
    elements = chain.device_elements()  # f64 on the x64 test backend

    maps, final = compose_chain(elements)
    f_els, f_maps, f_pre = fold_premasks(elements, maps)
    # the two leading masks fold into the first toroid; the terminal mask stays
    assert len(f_els) == 3
    assert len(f_pre[0]) == 2 and not any(f_pre[1:])
    assert isinstance(f_els[-1], MaskElement)

    s0 = bundle_to_state(chain.source_rays)
    out_ref = run_chain_chained(s0, elements, maps, final)
    out_fold = run_chain_chained(s0, f_els, f_maps, final, premasks=f_pre)

    np.testing.assert_array_equal(np.asarray(out_fold.alive),
                                  np.asarray(out_ref.alive))
    a = np.asarray(out_ref.alive)
    assert 100 < a.sum() < len(a)  # masks and supports actually clip
    for leaf in ("px", "py", "pz", "dx", "dy", "dz", "incidence"):
        np.testing.assert_allclose(
            np.asarray(getattr(out_fold, leaf))[a],
            np.asarray(getattr(out_ref, leaf))[a], rtol=1e-12, atol=1e-9,
            err_msg=leaf)
    # OPL: one direct leg vs two collinear legs — equal to f64 rounding
    np.testing.assert_allclose(np.asarray(out_fold.opl)[a],
                               np.asarray(out_ref.opl)[a], atol=1e-6)


def test_premask_folding_tilted_grazing_mask_parity():
    """Regression: a folded mask never advances the ray, so without a per-ray
    t-floor the NEXT element's forward test (t > eps) would run from the
    pre-mask position — a tilted/grazing mask whose plane crossing lies
    beyond a later element then transmits rays the unfolded chain kills
    (observed: ~half the bundle flipping alive). premask_alive's t_floor must
    reproduce the advance-to-the-mask-plane semantics exactly."""
    from attosecondraytracing_tpu.ops.trace import (
        bundle_to_state, compose_chain, fold_premasks, run_chain_chained,
    )

    # perpendicular mask, then an 85-deg (grazing) mask whose plane crossings
    # land tens of metres downstream for off-axis rays, then a terminal mask
    m1 = mmask.Mask(msupp.SupportRoundHole(50, 10, 0, 0))
    m2 = mmask.Mask(msupp.SupportRoundHole(50, 10, 0, 0))
    m3 = mmask.Mask(msupp.SupportRoundHole(80, 30, 0, 0))
    props = {"Divergence": 0.09, "SourceSize": 0, "Wavelength": 50e-6,
             "DeltaFT": 0.5, "NumberRays": 2001}
    chain = OEPlacement(props, [m1, m2, m3], [300.0, 10.0, 690.0],
                        [0.0, 85.0, 0.0], [0.0, 0.0, 0.0])
    elements = chain.device_elements()

    maps, final = compose_chain(elements)
    f_els, f_maps, f_pre = fold_premasks(elements, maps)
    assert len(f_els) == 1 and len(f_pre[0]) == 2

    s0 = bundle_to_state(chain.source_rays)
    out_ref = run_chain_chained(s0, elements, maps, final)
    out_fold = run_chain_chained(s0, f_els, f_maps, final, premasks=f_pre)
    a_ref = np.asarray(out_ref.alive)
    a_fold = np.asarray(out_fold.alive)
    np.testing.assert_array_equal(a_fold, a_ref)
    # the geometry actually exercises the trap: some rays' grazing-mask plane
    # crossing lies beyond the terminal mask (they must die there)
    assert 0 < a_ref.sum() < len(a_ref)
    np.testing.assert_allclose(np.asarray(out_fold.opl)[a_ref],
                               np.asarray(out_ref.opl)[a_ref], atol=1e-6)
