"""The ray-tracing engine: fused transform -> intersect -> reflect/mask steps.

Batched replacement for the reference's sequential per-ray loop
(ART/ModuleProcessing.py:250-313 + ART/ModuleMirror.py:912-939): one batched
step per optical element over the whole (N,)-ray bundle, with

* element frames applied as a single rotation matrix (lab->optic: rows
  (majoraxis, normal x majoraxis, normal); equivalent to the quaternion
  sequence at ART/ModuleProcessing.py:288-295),
* rays that miss marked dead via the ``alive`` mask (static shapes; the
  reference shrinks Python lists, ART/ModuleMirror.py:932-938),
* optical path accumulated with Kahan compensation (fs-scale delays from
  m-scale paths survive float32).

The per-element Python loop unrolls under ``jax.jit`` (chains are short), and
XLA fuses the whole chain into a handful of elementwise kernels. Everything
is differentiable end-to-end.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from . import supports as sup
from . import surfaces as srf
from .bundle import RayBundle
from .defects import defect_offset, defect_slopes
import jax

from .geometry import kahan_add
from .precision import T_EPS


class MirrorElement(NamedTuple):
    """Device-side description of one placed mirror.

    ``rot`` is the lab->optic rotation (3,3); ``position`` the element centre
    in the lab frame; ``centre`` the support-centre point on the surface in
    optic coordinates (reference get_centre()).
    """

    rot: jnp.ndarray
    position: jnp.ndarray
    centre: jnp.ndarray
    surface: NamedTuple
    support: NamedTuple
    defects: tuple = ()


class MaskElement(NamedTuple):
    """Device-side description of one placed mask (blocks rays on its support,
    transmits the rest; ART/ModuleMask.py)."""

    rot: jnp.ndarray
    position: jnp.ndarray
    support: NamedTuple


class TraceState(NamedTuple):
    """Pure component-form ray state: every leaf is an identically-shaped
    array (typically (N,)), one ray per element."""

    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    dx: jnp.ndarray
    dy: jnp.ndarray
    dz: jnp.ndarray
    opl: jnp.ndarray
    opl_c: jnp.ndarray
    alive: jnp.ndarray  # bool
    incidence: jnp.ndarray


def _acos(x):
    """arccos via the Abramowitz & Stegun 4.4.45 minimax polynomial
    (|error| < 2e-8 — below float32 resolution). Pure mul/add/sqrt: a
    fraction of the cost of a transcendental."""
    y = jnp.clip(jnp.abs(x), 0.0, 1.0)
    p = jnp.asarray(-0.0012624911, dtype=y.dtype)
    for c in (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
              0.0889789874, -0.2145988016, 1.5707963050):
        p = p * y + c
    r = jnp.sqrt(jnp.maximum(1.0 - y, 0.0)) * p
    return jnp.where(x < 0.0, jnp.pi - r, r)


def _unpack(v):
    return v[..., 0], v[..., 1], v[..., 2]


def bundle_to_state(b: RayBundle) -> TraceState:
    px, py, pz = _unpack(b.p)
    dx, dy, dz = _unpack(b.d)
    return TraceState(px, py, pz, dx, dy, dz, b.opl, b.opl_c, b.alive, b.incidence)


def state_to_bundle(s: TraceState, template: RayBundle) -> RayBundle:
    return RayBundle(
        p=jnp.stack([s.px, s.py, s.pz], axis=-1),
        d=jnp.stack([s.dx, s.dy, s.dz], axis=-1),
        opl=s.opl,
        opl_c=s.opl_c,
        alive=s.alive,
        intensity=template.intensity,
        incidence=s.incidence,
        wavelength=template.wavelength,
    )


def _to_local_c(element, s: TraceState):
    """Lab->optic frame transform in component form. ``element.rot`` etc. may
    be jnp arrays or nested tuples of python floats; both support
    ``rot[i][j]`` indexing."""
    R = element.rot
    pos = element.position
    rx, ry, rz = s.px - pos[0], s.py - pos[1], s.pz - pos[2]
    qx = R[0][0] * rx + R[0][1] * ry + R[0][2] * rz
    qy = R[1][0] * rx + R[1][1] * ry + R[1][2] * rz
    qz = R[2][0] * rx + R[2][1] * ry + R[2][2] * rz
    ux = R[0][0] * s.dx + R[0][1] * s.dy + R[0][2] * s.dz
    uy = R[1][0] * s.dx + R[1][1] * s.dy + R[1][2] * s.dz
    uz = R[2][0] * s.dx + R[2][1] * s.dy + R[2][2] * s.dz
    if isinstance(element, MirrorElement):
        cen = element.centre
        qx, qy, qz = qx + cen[0], qy + cen[1], qz + cen[2]
    return (qx, qy, qz), (ux, uy, uz)


def _to_lab_c(element, q, u):
    R = element.rot
    pos = element.position
    qx, qy, qz = q
    ux, uy, uz = u
    if isinstance(element, MirrorElement):
        cen = element.centre
        qx, qy, qz = qx - cen[0], qy - cen[1], qz - cen[2]
    px = R[0][0] * qx + R[1][0] * qy + R[2][0] * qz + pos[0]
    py = R[0][1] * qx + R[1][1] * qy + R[2][1] * qz + pos[1]
    pz = R[0][2] * qx + R[1][2] * qy + R[2][2] * qz + pos[2]
    dx = R[0][0] * ux + R[1][0] * uy + R[2][0] * uz
    dy = R[0][1] * ux + R[1][1] * uy + R[2][1] * uz
    dz = R[0][2] * ux + R[1][2] * uy + R[2][2] * uz
    return (px, py, pz), (dx, dy, dz)


def mirror_step_c(
    element: MirrorElement,
    s: TraceState,
    ignore_defects: bool,
    want_incidence: bool = True,
) -> TraceState:
    (qx, qy, qz), (ux, uy, uz) = _to_local_c(element, s)

    if element.defects:
        t, hit = srf.intersect_c(element.surface, element.support, (qx, qy, qz), (ux, uy, uz))
        # shift the hit along the ray by the local height error
        # (ART/ModuleMirror.py:969-980)
        x0, y0, z0 = qx + t * ux, qy + t * uy, qz + t * uz
        n0x, n0y, n0z = srf.normal_c(element.surface, x0, y0, z0)
        cen = element.centre
        h = jnp.zeros_like(t)
        for defect in element.defects:
            h = h + defect_offset(defect, x0 - cen[0], y0 - cen[1])
        cos_alpha = jnp.clip(-(ux * n0x + uy * n0y + uz * n0z), 1e-6, None)
        t = t - h / cos_alpha
        x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
        nx, ny, nz = srf.normal_c(element.surface, x, y, z)
    else:
        # fused hot path: intersection, hit point, and normal share the final
        # Newton evaluation (see surfaces.intersect_with_normal_c)
        t, hit, (nx, ny, nz), (x, y, z) = srf.intersect_with_normal_c(
            element.surface, element.support, (qx, qy, qz), (ux, uy, uz)
        )

    if element.defects and not ignore_defects:
        # compose base normal with defect slopes (ART/ModuleGeometry.py:394-407)
        cen = element.centre
        gx = -nx / nz
        gy = -ny / nz
        for defect in element.defects:
            dgx, dgy = defect_slopes(defect, x - cen[0], y - cen[1])
            gx = gx + dgx
            gy = gy + dgy
        inv = jax.lax.rsqrt(gx * gx + gy * gy + 1.0)
        nx, ny, nz = -gx * inv, -gy * inv, inv

    dn = ux * nx + uy * ny + uz * nz
    rx, ry, rz = ux - 2.0 * dn * nx, uy - 2.0 * dn * ny, uz - 2.0 * dn * nz

    upd = s.alive & hit
    if want_incidence:
        # incidence angle between -u and n; both unit vectors, so arccos(-u.n)
        # (the reference's arctan2 form, ART/ModuleGeometry.py:40-44, only
        # helps below micro-radian angles — irrelevant for this diagnostic)
        inc_out = jnp.where(upd, _acos(-dn), s.incidence)
    else:
        # history-free mode: only the final element's incidence is observable
        # (dead rays are excluded from every reduction), so skip the compute
        # AND the carried (N,) array — one less state leaf per fusion pass
        inc_out = s.incidence
    (px, py, pz), (dx, dy, dz) = _to_lab_c(element, (x, y, z), (rx, ry, rz))
    opl, opl_c = kahan_add(s.opl, s.opl_c, jnp.where(upd, t, 0.0))
    return TraceState(
        px=jnp.where(upd, px, s.px),
        py=jnp.where(upd, py, s.py),
        pz=jnp.where(upd, pz, s.pz),
        dx=jnp.where(upd, dx, s.dx),
        dy=jnp.where(upd, dy, s.dy),
        dz=jnp.where(upd, dz, s.dz),
        opl=opl,
        opl_c=opl_c,
        alive=upd,
        incidence=inc_out,
    )


def mask_step_c(element: MaskElement, s: TraceState, want_incidence: bool = True) -> TraceState:
    (qx, qy, qz), (ux, uy, uz) = _to_local_c(element, s)
    t = -qz / jnp.where(jnp.abs(uz) > 1e-30, uz, jnp.inf)
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    on_support = sup.include(element.support, x, y)
    # transmit rays that hit the plane *outside* the support
    # (ART/ModuleMask.py:51-61)
    transmitted = (t > T_EPS) & ~on_support

    upd = s.alive & transmitted
    if want_incidence:
        # mask incidence uses +u (not -u): ART/ModuleMask.py:99
        inc_out = jnp.where(upd, _acos(uz), s.incidence)
    else:
        inc_out = s.incidence
    (px, py, pz), _ = _to_lab_c(element, (x, y, z), (ux, uy, uz))
    opl, opl_c = kahan_add(s.opl, s.opl_c, jnp.where(upd, t, 0.0))
    return TraceState(
        px=jnp.where(upd, px, s.px),
        py=jnp.where(upd, py, s.py),
        pz=jnp.where(upd, pz, s.pz),
        dx=s.dx,
        dy=s.dy,
        dz=s.dz,
        opl=opl,
        opl_c=opl_c,
        alive=upd,
        incidence=inc_out,
    )


def state_step(
    element, s: TraceState, ignore_defects: bool = True, want_incidence: bool = True
) -> TraceState:
    if isinstance(element, MirrorElement):
        return mirror_step_c(element, s, ignore_defects, want_incidence=want_incidence)
    if isinstance(element, MaskElement):
        return mask_step_c(element, s, want_incidence=want_incidence)
    raise TypeError(f"unknown element type {type(element)}")


def _mirror_step(element: MirrorElement, b: RayBundle, ignore_defects: bool) -> RayBundle:
    return state_to_bundle(mirror_step_c(element, bundle_to_state(b), ignore_defects), b)


def _mask_step(element: MaskElement, b: RayBundle) -> RayBundle:
    return state_to_bundle(mask_step_c(element, bundle_to_state(b)), b)


def trace_step(element, bundle: RayBundle, ignore_defects: bool = True) -> RayBundle:
    """Propagate a bundle through one element (mirror or mask)."""
    if isinstance(element, MirrorElement):
        return _mirror_step(element, bundle, ignore_defects)
    if isinstance(element, MaskElement):
        return _mask_step(element, bundle)
    raise TypeError(f"unknown element type {type(element)}")


# ---------------------------------------------------------------------------
# chained-frame trace: one rotation per element instead of two
# ---------------------------------------------------------------------------


def compose_chain(elements):
    """Compose the per-element frame round-trips of a chain into one affine
    map per element plus a final to-lab map.

    The plain trace applies lab->optic then optic->lab around every element
    (two 3x3 rotations of both p and d per element, the analogue of
    ART/ModuleProcessing.py:288-309). Since element k's output frame feeds
    element k+1's input, the pair collapses to a single rotation
    ``M_k = R_{k+1} R_k^T`` with offset ``b_k``: ray state stays in each
    element's *local* frame through the chain and returns to the lab frame
    once at the end. Halves the transform arithmetic — the largest single
    compute block in the fused kernel.

    Float32 conditioning: the state handed between elements is kept
    *patch-relative* (hit point minus the element's ``centre``) — tens of mm
    instead of the ~1e3 mm surface-frame coordinates — so the 3x3 map runs on
    small numbers and the one large translation is a single baked constant
    ``b`` (computed here in float64). This matches the plain trace's rounding
    behaviour (its ``x - cen`` happens before any rotation too).

    Returns ``(maps, final)`` where ``maps[k] = (M, b)`` takes the
    patch-relative frame k-1 state (frame -1 = lab absolute) to element k's
    surface frame, and ``final = (R_K, pos_K)`` takes the patch-relative
    frame K state back to lab. Inputs may be jnp/NumPy arrays or baked
    python-float tuples (host numpy math; the results enter jit as
    constants)."""

    def rot(el):
        return np.asarray(el.rot, dtype=np.float64)

    def cen(el):
        if isinstance(el, MirrorElement):
            return np.asarray(el.centre, dtype=np.float64)
        return np.zeros(3)

    def pos(el):
        return np.asarray(el.position, dtype=np.float64)

    maps = []
    prev = None
    for el in elements:
        R = rot(el)
        if prev is None:
            M = R
            b = -R @ pos(el) + cen(el)
        else:
            M = R @ rot(prev).T
            b = R @ (pos(prev) - pos(el)) + cen(el)
        maps.append((M, b))
        prev = el
    final = (rot(prev), pos(prev))
    return maps, final


def fold_premasks(elements, maps):
    """Fold every non-terminal mask into the FOLLOWING element's composed
    affine, turning it into a pure alive-predicate ("premask") evaluated on
    the incoming state.

    A mask transmits or kills a ray but never bends it, so the ray line
    entering the next element is unchanged: the mask's frame handoff (full
    affine + position/OPL update + select chain, ~a fifth of the flagship
    kernel's per-ray work) is unnecessary. The mask-plane test still runs
    with the exact same arithmetic as the full step (same affine into the
    mask frame, same t and support test), only the state update is skipped
    and the mask's frame map is composed into the next element's.

    Observable differences vs the unfolded chain (both below the float32
    noise floor or dead-ray-only, see tests/test_pallas.py and
    tests/test_xla_source.py):

    * a transmitted ray's OPL accumulates the source->next-mirror leg in one
      piece instead of two collinear pieces (~1 ulp difference);
    * rays that pass a folded mask but die at the NEXT element keep their
      pre-mask position instead of the mask-plane position (dead rays are
      excluded from every reduction).

    The LAST element is never folded (its position/incidence are the trace's
    outputs). Returns ``(elements', maps', premasks)`` of equal length, where
    ``premasks[k]`` is a tuple of ``(support, M, b)`` tests to apply to
    element k's incoming state. Host-side float64 math like compose_chain.
    """
    new_els, new_maps, new_pre = [], [], []
    pending = []           # (support, M, b) tests in the current incoming frame
    carry = None           # affine incoming-frame -> last folded mask's frame
    for i, (el, (M, b)) in enumerate(zip(elements, maps)):
        M = np.asarray(M, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if carry is not None:
            Mc, bc = carry
            M, b = M @ Mc, M @ bc + b
        if isinstance(el, MaskElement) and i < len(elements) - 1:
            pending.append((el.support, M, b))
            carry = (M, b)
        else:
            new_els.append(el)
            new_maps.append((M, b))
            new_pre.append(tuple(pending))
            pending, carry = [], None
    return new_els, new_maps, new_pre


def premask_alive(premasks, s: TraceState):
    """(alive, t_floor) after applying folded mask tests to the incoming
    state. Arithmetic is identical to the full mask step (same affine, same
    plane t, same support test).

    Because folded masks never advance the ray, "forward" for everything
    downstream must still be measured from the mask plane the reference
    advances to: each mask's own crossing must lie beyond the previous one
    (``t > t_floor + T_EPS``, the unfolded chain's per-frame ``t > T_EPS``),
    and the returned ``t_floor`` (furthest crossing, per ray) becomes the
    minimum ray parameter for the NEXT element's intersection — otherwise a
    tilted/grazing mask whose plane crossing lies beyond a later element
    would transmit rays the unfolded chain kills (or vice versa)."""
    alive = s.alive
    t_floor = jnp.zeros_like(s.px)
    for support, Mm, bm in premasks:
        (mx, my, mz), (mux, muy, muz) = _affine_c(
            Mm, bm, s.px, s.py, s.pz, s.dx, s.dy, s.dz
        )
        t = -mz / jnp.where(jnp.abs(muz) > 1e-30, muz, jnp.inf)
        on_support = sup.include(support, mx + t * mux, my + t * muy)
        alive = alive & (t > t_floor + T_EPS) & ~on_support
        t_floor = jnp.maximum(t_floor, t)  # garbage on dead lanes: masked
    return alive, t_floor


def _affine_c(M, b, px, py, pz, dx, dy, dz):
    qx = M[0][0] * px + M[0][1] * py + M[0][2] * pz + b[0]
    qy = M[1][0] * px + M[1][1] * py + M[1][2] * pz + b[1]
    qz = M[2][0] * px + M[2][1] * py + M[2][2] * pz + b[2]
    ux = M[0][0] * dx + M[0][1] * dy + M[0][2] * dz
    uy = M[1][0] * dx + M[1][1] * dy + M[1][2] * dz
    uz = M[2][0] * dx + M[2][1] * dy + M[2][2] * dz
    return (qx, qy, qz), (ux, uy, uz)


def chained_step(element, M, b, s: TraceState, want_incidence: bool,
                 ignore_defects: bool = True, premasks=(),
                 freeze_dead: bool = True) -> TraceState:
    """One element step in chained-frame mode: input state patch-relative to
    the previous element (lab absolute for the first), output patch-relative
    to THIS element. Dead rays keep their coordinates and are re-expressed by
    every subsequent map, so their final lab position is preserved exactly
    like the plain trace.

    Defect-bearing mirrors follow the same semantics as :func:`mirror_step_c`
    (and the reference, ART/ModuleMirror.py:925-939): the intersection is
    always that of the *deformed* surface (hit shifted along the ray by the
    local height error), while ``ignore_defects`` gates only the slope
    composition into the reflecting normal.

    ``premasks``: folded mask tests (:func:`fold_premasks`) applied to the
    incoming state before this element's own step. They also raise this
    element's minimum ray parameter to the furthest folded-mask crossing
    (see :func:`premask_alive`), reproducing the unfolded chain's
    advance-to-the-mask-plane semantics exactly."""
    if premasks:
        alive, t_floor = premask_alive(premasks, s)
        s = s._replace(alive=alive)
        t_eps = t_floor + T_EPS  # (N,) per-ray floor; broadcasts everywhere
    else:
        t_eps = T_EPS
    (qx, qy, qz), (ux, uy, uz) = _affine_c(
        M, b, s.px, s.py, s.pz, s.dx, s.dy, s.dz
    )
    if isinstance(element, MaskElement):
        cen = (0.0, 0.0, 0.0)
        t = -qz / jnp.where(jnp.abs(uz) > 1e-30, uz, jnp.inf)
        x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
        on_support = sup.include(element.support, x, y)
        valid = (t > t_eps) & ~on_support
        rx, ry, rz = ux, uy, uz
        dn = -uz  # mask incidence uses +u: acos(uz)
    elif element.defects:
        cen = element.centre
        t, valid = srf.intersect_c(element.surface, element.support, (qx, qy, qz), (ux, uy, uz), t_eps=t_eps)
        # shift the hit along the ray by the local height error
        # (ART/ModuleMirror.py:969-980)
        x0, y0, z0 = qx + t * ux, qy + t * uy, qz + t * uz
        n0x, n0y, n0z = srf.normal_c(element.surface, x0, y0, z0)
        h = jnp.zeros_like(t)
        for defect in element.defects:
            h = h + defect_offset(defect, x0 - cen[0], y0 - cen[1])
        cos_alpha = jnp.clip(-(ux * n0x + uy * n0y + uz * n0z), 1e-6, None)
        t = t - h / cos_alpha
        x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
        nx, ny, nz = srf.normal_c(element.surface, x, y, z)
        if not ignore_defects:
            # compose base normal with defect slopes (ART/ModuleGeometry.py:394-407)
            gx = -nx / nz
            gy = -ny / nz
            for defect in element.defects:
                dgx, dgy = defect_slopes(defect, x - cen[0], y - cen[1])
                gx = gx + dgx
                gy = gy + dgy
            inv = jax.lax.rsqrt(gx * gx + gy * gy + 1.0)
            nx, ny, nz = -gx * inv, -gy * inv, inv
        dn = ux * nx + uy * ny + uz * nz
        rx, ry, rz = ux - 2.0 * dn * nx, uy - 2.0 * dn * ny, uz - 2.0 * dn * nz
    else:
        cen = element.centre
        t, valid, (nx, ny, nz), (x, y, z) = srf.intersect_with_normal_c(
            element.surface, element.support, (qx, qy, qz), (ux, uy, uz),
            t_eps=t_eps
        )
        dn = ux * nx + uy * ny + uz * nz
        rx, ry, rz = ux - 2.0 * dn * nx, uy - 2.0 * dn * ny, uz - 2.0 * dn * nz
    upd = s.alive & valid
    if not freeze_dead and isinstance(element, MirrorElement):
        # moments-epilogue mode: dead-ray state is consumed ONLY through
        # alive-masked reductions (moment_rows zeroes their weights), so the
        # per-component freeze selects are pure overhead. Dead rays advance
        # along whatever (bounded) path the mirror geometry gives them: a
        # valid hit has support-sized local coordinates and a unit reflected
        # direction, an invalid one has t = 0 (intersect_* returns
        # where(hit, t, 0)) and leaves the state unchanged — every value
        # stays BOUNDED, which is all the masked epilogue needs (w * inf
        # would be NaN; w * bounded-garbage is exactly 0). Mask steps are
        # excluded: their plane leg t = -qz/uz is unbounded for
        # near-parallel dead rays and its square would overflow to inf. NOT
        # valid for kernels whose per-ray outputs are the product (bundle
        # traces keep the reference's frozen dead-ray state).
        inc_out = _acos(-dn) if want_incidence else s.incidence
        opl, opl_c = kahan_add(s.opl, s.opl_c, t)
        return TraceState(
            px=x - cen[0], py=y - cen[1], pz=z - cen[2],
            dx=rx, dy=ry, dz=rz,
            opl=opl, opl_c=opl_c, alive=upd, incidence=inc_out,
        )
    inc_out = jnp.where(upd, _acos(-dn), s.incidence) if want_incidence else s.incidence
    opl, opl_c = kahan_add(s.opl, s.opl_c, jnp.where(upd, t, 0.0))
    # hand off patch-relative coordinates: x (or the frozen q) is within the
    # support's extent of cen, so the subtraction is nearly exact and the next
    # 3x3 map operates on small numbers (float32 conditioning; see
    # compose_chain)
    return TraceState(
        px=jnp.where(upd, x, qx) - cen[0],
        py=jnp.where(upd, y, qy) - cen[1],
        pz=jnp.where(upd, z, qz) - cen[2],
        dx=jnp.where(upd, rx, ux),
        dy=jnp.where(upd, ry, uy),
        dz=jnp.where(upd, rz, uz),
        opl=opl,
        opl_c=opl_c,
        alive=upd,
        incidence=inc_out,
    )


def run_chain_chained(s: TraceState, elements, maps, final,
                      ignore_defects: bool = True, premasks=None,
                      freeze_dead: bool = True) -> TraceState:
    """Run a whole chain in chained-frame mode and restore lab coordinates.
    Equivalent to folding state_step over the chain with
    ``keep_history=False`` (incidence computed only at the last element).
    ``premasks`` (from :func:`fold_premasks`, aligned with ``elements``)
    carries folded mask tests; None = no folding. ``freeze_dead=False``
    skips the dead-ray freeze selects (see :func:`chained_step`) — legal
    whenever every consumer masks by ``alive`` (all analysis/stats/plot/
    histogram consumers do; measured ~20-30% kernel speedup)."""
    last = len(elements) - 1
    if premasks is None:
        premasks = ((),) * len(elements)
    for i, (el, (M, b)) in enumerate(zip(elements, maps)):
        s = chained_step(el, M, b, s, want_incidence=(i == last),
                         ignore_defects=ignore_defects, premasks=premasks[i],
                         freeze_dead=freeze_dead)
    R_K, pos_K = final
    # p_lab = R_K^T x + pos_K ; d_lab = R_K^T d  (x already patch-relative)
    x = s.px
    y = s.py
    z = s.pz
    px = R_K[0][0] * x + R_K[1][0] * y + R_K[2][0] * z + pos_K[0]
    py = R_K[0][1] * x + R_K[1][1] * y + R_K[2][1] * z + pos_K[1]
    pz = R_K[0][2] * x + R_K[1][2] * y + R_K[2][2] * z + pos_K[2]
    dx = R_K[0][0] * s.dx + R_K[1][0] * s.dy + R_K[2][0] * s.dz
    dy = R_K[0][1] * s.dx + R_K[1][1] * s.dy + R_K[2][1] * s.dz
    dz = R_K[0][2] * s.dx + R_K[1][2] * s.dy + R_K[2][2] * s.dz
    return s._replace(px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz)


from functools import partial


@partial(jax.jit, static_argnames=("meta", "ignore_defects", "keep_history"))
def _trace_packed(source, flat_elements, meta, ignore_defects, keep_history):
    # elements arrive as ONE flat array (single host->device transfer
    # instead of one per tiny leaf)
    from .packing import unpack_tree

    elements = unpack_tree(flat_elements, meta)
    return trace(source, elements, ignore_defects=ignore_defects,
                 keep_history=keep_history)


def trace_jit(source, elements, ignore_defects: bool = True,
              keep_history: bool = False):
    """Jitted trace with the element list packed into one flat transfer
    (ops/packing.py). Chains with the same *structure* (same element types /
    leaf shapes) reuse the same XLA executable, so probe traces across a
    parameter scan compile once.

    Tradeoff (deliberate, ADVICE r4): python/NumPy *scalar* leaves — surface
    radii, support dimensions — are compile-time constants (pack_tree folds
    them into the static meta to keep them weakly typed; packing them as 0-d
    arrays would strong-type them and silently promote the whole trace under
    x64). A scan that varies such a scalar therefore recompiles per distinct
    value. Pose scans (the reference's loop lists) vary only array leaves
    and share one executable; if you need a no-recompile *shape* scan, wrap
    the varying scalar in a 0-d float32 np.ndarray at construction time."""
    from .packing import pack_tree

    flat, meta = pack_tree(elements)
    return _trace_packed(source, flat, meta, ignore_defects, keep_history)


def trace(
    source: RayBundle,
    elements: Sequence,
    ignore_defects: bool = True,
    keep_history: bool = True,
):
    """Trace a bundle through a chain of elements.

    Equivalent of ART's RayTracingCalculation (ART/ModuleProcessing.py:250-313):
    returns the list of bundles *after* each element (``keep_history=True``),
    or only the final bundle. Wrap in ``jax.jit`` for compiled execution; the
    element list is a pytree argument, so re-jitting only happens when the
    chain *structure* changes, not its parameters.
    """
    history = []
    s = bundle_to_state(source)
    last = len(elements) - 1
    for i, element in enumerate(elements):
        s = state_step(
            element,
            s,
            ignore_defects=ignore_defects,
            want_incidence=keep_history or i == last,
        )
        if keep_history:
            history.append(state_to_bundle(s, source))
    return history if keep_history else state_to_bundle(s, source)
