"""Fused-source engine: in-jit Vogel synthesis vs the plain-jnp builder,
and physics-statistics agreement with the host (float64) source factory."""

import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.models import masks as mmask
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import sources as msource
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement
from attosecondraytracing_tpu.ops.source import make_source_spec, source_bundle
from attosecondraytracing_tpu.ops.trace import trace
from attosecondraytracing_tpu.ops.xla_source import xla_trace_source


def _flagship(n):
    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": n}
    return OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, inc, -inc], [0, 0, 0])


def test_source_bundle_spiral_properties():
    spec = make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)
    b = source_bundle(spec, 5000)
    d = np.asarray(b.d, dtype=np.float64)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)
    # exact Vogel radii: tan(angle to axis) = tan(div) * sqrt(k/N); measure
    # via the transverse/axial ratio (arccos of an f32 direction quantizes
    # small angles to ~sqrt(2 ulp) and is unusable here)
    tan_ang = np.hypot(d[:, 1], d[:, 2]) / d[:, 0]
    np.testing.assert_allclose(
        tan_ang, np.tan(25e-3) * np.sqrt(np.arange(5000) / 5000), atol=2e-6
    )
    # golden-angle equidistribution: azimuth histogram is flat to ~sqrt(N)
    az = np.arctan2(d[:, 2], d[:, 1])
    counts, _ = np.histogram(az, bins=16)
    assert counts.min() > 0.8 * 5000 / 16 and counts.max() < 1.2 * 5000 / 16

    disk = make_source_spec("disk", np.array([1.0, 2, 3]), np.array([0, 1.0, 0]), 10.0)
    bd = source_bundle(disk, 3000)
    p = np.asarray(bd.p, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(bd.d), np.tile([0, 1.0, 0], (3000, 1)), atol=1e-6)
    r = np.linalg.norm(p - [1, 2, 3], axis=1)
    np.testing.assert_allclose(r, 10.0 * np.sqrt(np.arange(3000) / 3000), atol=1e-5)


def test_fused_source_kernel_matches_jnp_builder():
    """xla_trace_source == trace(source_bundle(...)) ray for ray (both
    float32, same synthesized source; chained vs lab frames)."""
    chain = _flagship(2000)
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    spec = make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)

    src = source_bundle(spec, 2000, wavelength=80e-6)
    xla = trace(src, elements, keep_history=False)
    fused = xla_trace_source(spec, elements, 2000, wavelength=80e-6)

    a_x, a_f = np.asarray(xla.alive), np.asarray(fused.alive)
    assert (a_x == a_f).mean() > 0.999  # edge rays may flip by reassociation
    a = a_x & a_f
    dp = np.abs(np.asarray(fused.p)[a] - np.asarray(xla.p)[a])
    assert np.median(dp) < 1e-3 and dp.max() < 5e-2
    np.testing.assert_allclose(np.asarray(fused.opl)[a], np.asarray(xla.opl)[a], atol=0.1)


def test_fused_source_statistics_match_host_source():
    """Spot/duration/transmission from the fused-source trace agree with the
    host-f64-source trace (different ray sets, same physics)."""
    n = 20000
    chain = _flagship(n)
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    spec = make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)

    fused = xla_trace_source(spec, elements, n, wavelength=80e-6)
    host_out = chain.trace_final()

    # transmission (uniform intensities): surviving fraction
    t_fused = np.asarray(fused.alive).mean()
    t_host = np.asarray(host_out.alive).mean()
    assert abs(t_fused - t_host) < 0.005

    det = Detector(np.zeros(3))
    det.autoplace(host_out, 2 * 500.0)
    s_host, d_host = (float(v) for v in det.get_SpotAndDuration(host_out))
    s_fused, d_fused = (float(v) for v in det.get_SpotAndDuration(fused))
    assert s_fused == pytest.approx(s_host, rel=0.02, abs=1e-6)
    assert d_fused == pytest.approx(d_host, rel=0.05, abs=5e-3)
