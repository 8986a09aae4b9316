"""Gradient-based alignment optimization.

The reference explores misalignments by brute-force scan lists and Monte-Carlo
(ART/ModuleOpticalChain.py:371-657). Because this framework's trace is
differentiable end-to-end, the detector metrics are differentiable in every
element's pose, so alignment becomes *gradient descent on the real optical
figure of merit* — the "training step" of this framework:

    params (pitch/roll/yaw + shifts per element)
      -> perturbed element poses (device-side rotation composition)
      -> batched trace -> detector spot/duration metrics -> loss
      -> jax.grad -> optimizer update

Support clipping enters only through the alive mask; gradients flow through
the smooth geometry of surviving rays (straight-through treatment of the
mask, SURVEY.md §7).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..analysis import stats
from ..ops.bundle import RayBundle
from ..ops.geometry import rotation_around_axis
from ..ops.trace import trace


class AlignmentParams(NamedTuple):
    """Per-element pose perturbations: ``angles[k] = (pitch, roll, yaw)``
    [rad] and ``shifts[k] = (normal, major, cross)`` [mm] — the same six
    degrees of freedom as the reference's misalignment methods
    (ART/ModuleOpticalElement.py:169-265)."""

    angles: jnp.ndarray  # (K, 3)
    shifts: jnp.ndarray  # (K, 3)


def zero_params(n_elements: int, dtype=jnp.float32) -> AlignmentParams:
    return AlignmentParams(
        angles=jnp.zeros((n_elements, 3), dtype=dtype),
        shifts=jnp.zeros((n_elements, 3), dtype=dtype),
    )


def _perturb_one(element, angles, shifts):
    """Apply (pitch, roll, yaw) rotations about the element's (cross, major,
    normal) axes and shifts along (normal, major, cross) — differentiable
    device-side counterpart of rotate_*_by/shift_along_*."""
    rot = element.rot  # rows: majoraxis, cross(=n x m), normal (lab frame)
    m, c, n = rot[0], rot[1], rot[2]
    # full-f32 matmuls: a reduced-precision default (bf16 or TF32 passes)
    # would perturb the composed pose by ~1e-3 — far above any alignment
    # parameter being optimized
    with jax.default_matmul_precision("float32"):
        R_delta = (
            rotation_around_axis(c, angles[0])
            @ rotation_around_axis(m, angles[1])
            @ rotation_around_axis(n, angles[2])
        )
        new_rot = rot @ R_delta.T
    new_pos = element.position + shifts[0] * n + shifts[1] * m + shifts[2] * c
    return element._replace(rot=new_rot, position=new_pos)


def apply_params(elements, params: AlignmentParams):
    """Perturb every element's pose by the corresponding parameter row."""
    return [
        _perturb_one(el, params.angles[k], params.shifts[k])
        for k, el in enumerate(elements)
    ]


def focus_loss(
    params: AlignmentParams,
    source: RayBundle,
    elements,
    det_centre,
    det_normal,
    det_rot,
    duration_weight: float = 0.0,
    survival_weight: float = 1.0,
    ignore_defects: bool = True,
):
    """Scalar figure of merit: spot variance (+ weighted duration variance) on
    a fixed detector plane, for the chain perturbed by ``params``.

    ``survival_weight`` penalizes lost energy [mm^2 per unit transmission
    loss]: a purely survivor-weighted variance would otherwise reward walking
    the beam off the optics (zero survivors = zero variance)."""
    out = trace(source, apply_params(elements, params), ignore_defects=ignore_defects, keep_history=False)
    w = out.alive.astype(out.p.dtype) * out.intensity
    xy = stats.detector_points_2d(out, det_centre, det_normal, det_rot)
    spot2 = stats.std_points(xy, w) ** 2
    loss = spot2
    if duration_weight:
        delays = stats.detector_delays(out, det_centre, det_normal)
        loss = loss + duration_weight * stats.std_scalar(delays, w) ** 2
    if survival_weight:
        transmission = jnp.sum(w) / jnp.maximum(jnp.sum(source.intensity), 1e-30)
        loss = loss + survival_weight * (1.0 - transmission)
    return loss


@partial(jax.jit, static_argnames=("duration_weight", "survival_weight", "ignore_defects"))
def alignment_step(
    params: AlignmentParams,
    lr: float,
    source: RayBundle,
    elements,
    det_centre,
    det_normal,
    det_rot,
    duration_weight: float = 0.0,
    survival_weight: float = 1.0,
    ignore_defects: bool = True,
):
    """One SGD step on the alignment parameters. Under a sharded ray axis the
    gradient reduction becomes an all-reduce over the mesh (inserted by XLA).
    Returns (new_params, loss)."""
    loss, grads = jax.value_and_grad(focus_loss)(
        params, source, elements, det_centre, det_normal, det_rot,
        duration_weight=duration_weight, survival_weight=survival_weight,
        ignore_defects=ignore_defects,
    )
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return new_params, loss


_value_and_grad = jax.jit(
    jax.value_and_grad(focus_loss),
    static_argnames=("duration_weight", "survival_weight", "ignore_defects"))


def gradient_align(
    chain,
    detector,
    iters: int = 100,
    lr: float = 1e-5,
    duration_weight: float = 0.0,
    survival_weight: float = 1.0,
    params: AlignmentParams | None = None,
    verbose: bool = False,
):
    """Host convenience loop: Adam-descend the alignment of a chain onto a
    fixed detector plane; returns (params, loss history).

    Adam's per-parameter normalization matters here: spot-variance gradients
    w.r.t. angles are ~f^2 larger than w.r.t. shifts, so plain SGD needs
    per-axis learning rates. ``lr`` is therefore an angle/shift step scale
    (radians/mm per iteration ceiling). Gradients are reverse-mode through
    the streamed trace; the source bundle and elements are jit arguments
    (uploaded once), not compile-time constants.
    """
    import optax

    elements = chain.device_elements()
    source = jax.device_put(chain.source_rays)
    if params is None:
        params = zero_params(len(elements), dtype=jnp.float32)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    centre = jnp.asarray(detector.centre)
    normal = jnp.asarray(detector.normal)
    rot = jnp.asarray(detector._plane_rotation())

    history = []
    for i in range(iters):
        loss, grads = _value_and_grad(
            params, source, elements, centre, normal, rot,
            duration_weight=duration_weight, survival_weight=survival_weight,
        )
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        history.append(float(loss))
        if verbose and (i % max(1, iters // 10) == 0):
            print(f"align iter {i}: loss {history[-1]:.6g}")
    return params, history
