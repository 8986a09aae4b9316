"""Differentiability: gradients of detector metrics w.r.t. alignment and
surface parameters (checked against finite differences), and gradient-descent
re-alignment of a misaligned chain."""

import jax
import jax.numpy as jnp
import numpy as np

from attosecondraytracing_tpu.analysis import alignment as al
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement


def _chain_and_detector(misalign_roll_deg=0.0, n_rays=400):
    parabola = mmirror.MirrorParabolic(100, 90, msupp.SupportRound(12))
    props = {"Divergence": 0, "SourceSize": 20, "Wavelength": 50e-6, "DeltaFT": 1, "NumberRays": n_rays}
    chain = OEPlacement(props, [parabola], [200], [0.0])
    det = Detector(chain.optical_elements[0].position)
    det.autoplace(chain.trace_final(), 100.0)
    if misalign_roll_deg:
        chain.optical_elements[0].rotate_roll_by(misalign_roll_deg)
    return chain, det


def _loss_fn(chain, det):
    elements = chain.device_elements()
    source = chain.source_rays
    centre = jnp.asarray(det.centre)
    normal = jnp.asarray(det.normal)
    rot = jnp.asarray(det._plane_rotation())

    def loss(params):
        return al.focus_loss(params, source, elements, centre, normal, rot)

    return loss


def test_alignment_gradient_matches_finite_difference():
    chain, det = _chain_and_detector(misalign_roll_deg=0.05)
    loss = _loss_fn(chain, det)
    params = al.zero_params(1, dtype=jnp.float64)
    g = jax.grad(loss)(params)
    # finite differences on each angle component
    eps = 1e-7
    for j in range(3):
        delta = np.zeros((1, 3))
        delta[0, j] = eps
        lp = float(loss(params._replace(angles=params.angles + delta)))
        lm = float(loss(params._replace(angles=params.angles - delta)))
        fd = (lp - lm) / (2 * eps)
        an = float(np.asarray(g.angles)[0, j])
        np.testing.assert_allclose(an, fd, rtol=5e-3, atol=1e-10)
    for j in range(3):
        delta = np.zeros((1, 3))
        delta[0, j] = eps
        lp = float(loss(params._replace(shifts=params.shifts + delta)))
        lm = float(loss(params._replace(shifts=params.shifts - delta)))
        fd = (lp - lm) / (2 * eps)
        an = float(np.asarray(g.shifts)[0, j])
        np.testing.assert_allclose(an, fd, rtol=5e-3, atol=1e-10)


def test_gradient_descent_realigns_rolled_parabola():
    """Start from a rolled OAP (blurred focus); gradient descent on the pose
    recovers a tighter focus (the BASELINE 'alignment-gradient descent'
    scenario)."""
    chain, det = _chain_and_detector(misalign_roll_deg=0.1)
    loss = _loss_fn(chain, det)
    params = al.zero_params(1, dtype=jnp.float64)
    l0 = float(loss(params))
    params, history = al.gradient_align(chain, det, iters=60, lr=2e-3)
    l1 = history[-1]
    assert l1 < 0.05 * l0, f"loss only went {l0} -> {l1}"


def test_grad_wrt_surface_parameters():
    """Gradients flow into surface shape parameters (e.g. toroid radii) —
    enabling design optimization, not just alignment."""
    from attosecondraytracing_tpu.ops.trace import trace
    from attosecondraytracing_tpu.analysis import stats

    focal, inc = 500.0, 80.0
    R0, r0 = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    mirror = mmirror.MirrorToroidal(R0, r0, msupp.SupportRectangle(300, 50))
    props = {"Divergence": 10e-3, "SourceSize": 0, "Wavelength": 50e-6, "DeltaFT": 1, "NumberRays": 300}
    chain = OEPlacement(props, [mirror], [2 * focal], [inc])
    det = Detector(chain.optical_elements[0].position)
    det.autoplace(chain.trace_final(), 2 * focal)
    elements = chain.device_elements()
    source = chain.source_rays
    centre = jnp.asarray(det.centre)
    normal = jnp.asarray(det.normal)
    rot = jnp.asarray(det._plane_rotation())

    def loss(radii):
        el = elements[0]
        el = el._replace(surface=el.surface._replace(major_radius=radii[0], minor_radius=radii[1]))
        out = trace(source, [el], keep_history=False)
        w = out.alive.astype(out.p.dtype)
        xy = stats.detector_points_2d(out, centre, normal, rot)
        return stats.std_points(xy, w) ** 2

    radii = jnp.array([R0, r0])
    g = jax.grad(loss)(radii)
    assert np.all(np.isfinite(np.asarray(g)))
    # finite-difference check on the major radius
    eps = 1e-4
    fd = (float(loss(radii + jnp.array([eps, 0.0]))) - float(loss(radii - jnp.array([eps, 0.0])))) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), fd, rtol=1e-3)


def _masked_oap(n_rays):
    """Aperture mask + 90 deg off-axis parabola (a cheap-to-differentiate
    stand-in for the grazing toroid chains, whose reverse-mode compile is
    slow on the CPU test backend)."""
    from attosecondraytracing_tpu.models import masks as mmask

    parabola = mmirror.MirrorParabolic(100, 90, msupp.SupportRound(12))
    mask = mmask.Mask(msupp.SupportRoundHole(15, 3, 0, 0))
    props = {"Divergence": 0, "SourceSize": 20, "Wavelength": 50e-6,
             "DeltaFT": 1, "NumberRays": n_rays}
    chain = OEPlacement(props, [mask, parabola], [100, 100], [0.0, 0.0])
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(engine="xla"), 100.0)
    return chain, det


def test_gradient_align_fused_descends():
    """gradient_align must descend the loss on a misaligned masked chain
    (reverse mode through the streamed trace, source and elements passed
    as jit arguments)."""
    chain, det = _masked_oap(2048)
    chain.rotate_OE(1, "roll", 0.1)  # misalign
    params, history = al.gradient_align(
        chain, det, iters=12, lr=2e-3, survival_weight=0.0,
    )
    assert history[-1] < 0.9 * history[0], history


def test_fused_grad_sharded_matches_single_device():
    """The alignment gradient with the ray axis sharded over the
    8-virtual-device mesh == the single-device gradient (XLA inserts the
    cross-device reduction of the loss and its cotangents)."""
    from attosecondraytracing_tpu.parallel import mesh as pmesh

    chain, det = _masked_oap(8192)
    elements = chain.device_elements()
    geom = tuple(jnp.asarray(v) for v in
                 (det.centre, det.normal, det._plane_rotation()))
    params = al.zero_params(len(elements), dtype=jnp.float64)
    params = params._replace(
        angles=params.angles.at[1, 1].set(2e-4).at[1, 2].set(-1e-4),
        shifts=params.shifts.at[1, 0].set(0.05))
    vg = jax.jit(jax.value_and_grad(al.focus_loss))

    loss_1, grads_1 = vg(params, chain.source_rays, elements, *geom)
    mesh = pmesh.make_mesh()
    src = pmesh.shard_bundle(chain.source_rays, mesh)  # 8192 divides: no pad
    loss_s, grads_s = vg(params, src, elements, *geom)
    assert float(loss_1) > 0
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-9)
    for g_s, g_1 in zip(jax.tree.leaves(grads_s), jax.tree.leaves(grads_1)):
        g_s, g_1 = np.asarray(g_s), np.asarray(g_1)
        scale = max(np.abs(g_1).max(), 1e-12)
        np.testing.assert_allclose(g_s, g_1, atol=1e-9 * scale, rtol=1e-7)
