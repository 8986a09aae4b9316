"""Mirror surfaces as implicit functions with batched, differentiable,
Newton-polished intersections (JAX).

Batched replacement for ART/ModuleMirror.py's per-ray ``np.roots`` calls
(ART/ModuleGeometry.py:80-106): every surface provides

* a closed-form (quadratic, or Ferrari-quartic for the toroid) seed for the
  ray parameter ``t``,
* a few Newton iterations on a *well-conditioned, distance-like* residual
  ``g(t)`` (values ~mm near the surface, no 1e12-scale cancellations), which
  restores near machine precision even in float32,
* branch filters and vectorized support clipping identical in semantics to the
  reference (candidate roots are filtered by t>0, the surface branch
  constraint, and support inclusion; the nearest valid hit wins —
  ART/ModuleMirror.py:27-38 and the per-surface ``_get_intersection``).

All functions are batched over rays and fully differentiable, so detector
metrics are differentiable w.r.t. surface parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import supports as sup
from .precision import T_EPS

#: a candidate root counts as a real hit if the polished point lies within
#: this distance [mm] of the surface (also rejects Newton non-convergence).
HIT_TOL = 1e-3


def _hit_tol_for(surface, dtype, tol):
    """Scale-aware hit tolerance: in float32 the residual is evaluated from
    surface-frame coordinates of magnitude ~(R+r), so its rounding noise is
    a few ulps of that scale — for very large toroids (R ~ 30 m) one f32 ulp
    (~2e-3 mm) already exceeds the nominal HIT_TOL and real hits would be
    rejected at random (lost transmission). Raise the tolerance to a few
    ulps of the coordinate scale; the admitted off-surface error stays at
    the same magnitude as the f32 coordinate noise itself, so no accuracy is
    actually given up. (float64 keeps the nominal tolerance: its noise floor
    is ~1e-9 mm.)"""
    if dtype != jnp.float32:
        return tol
    if isinstance(surface, Toroid):
        scale = surface.major_radius + surface.minor_radius
    elif isinstance(surface, (Sphere, Cylinder)):
        scale = surface.radius
    elif isinstance(surface, Ellipsoid):
        scale = jnp.maximum(surface.a, surface.b)
    else:
        return tol
    # symbolic (works for traced jit inputs AND baked python-float constants)
    return jnp.maximum(tol, 6.0 * float(np.finfo(np.float32).eps) * scale)

_NEWTON_ITERS = 3
_NEWTON_ITERS_TOROID = 6
# the osculating-paraboloid seed converges in ONE iteration on every tested
# geometry (grazing/steep/shallow, scripts/sweep_newton_iters.py); the fast
# path (_toroid_fast_root) therefore applies FAST-1 corrections and reads the
# validity residual from one final shared evaluation at the corrected root —
# i.e. FAST counts residual *evaluations*. 2 is the working floor: the
# residual is evaluated at the once-corrected (converged) root and results
# are bit-identical to 3+ on every tested geometry. For geometries outside
# the swept set, set ART_TPU_TOROID_EXACT=1 to cross-check the fast hit masks
# against the exact Ferrari solve (see tests/test_surfaces.py).
_NEWTON_ITERS_TOROID_FAST = 2

import os as _os

_TOROID_EXACT = _os.environ.get("ART_TPU_TOROID_EXACT", "0") == "1"


class Plane(NamedTuple):
    """z = 0 plane (mirror: ART/ModuleMirror.py:42-113; also masks)."""


class Sphere(NamedTuple):
    """Full sphere x^2+y^2+z^2 = R^2, mirror patch on the z<0 branch
    (ART/ModuleMirror.py:117-208). ``radius`` is stored positive; convex
    mirrors are realized by flipping the incidence at placement, exactly like
    the reference (ART/ModuleProcessing.py:93-95)."""

    radius: jnp.ndarray


class Parabola(NamedTuple):
    """Paraboloid z = (x^2+y^2)/(2p) with vertex at the origin
    (ART/ModuleMirror.py:212-387). ``center_x`` = f_eff*sin(alpha) is the
    off-axis distance of the support centre (used for support clipping)."""

    p: jnp.ndarray
    center_x: jnp.ndarray


class Toroid(NamedTuple):
    """Torus (sqrt(x^2+z^2)-R)^2 + y^2 = r^2, mirror patch on the outer
    z < -R branch (ART/ModuleMirror.py:391-527)."""

    major_radius: jnp.ndarray
    minor_radius: jnp.ndarray


class Ellipsoid(NamedTuple):
    """Ellipsoid (x/a)^2 + (y^2+z^2)/b^2 = 1, patch on z<0
    (ART/ModuleMirror.py:565-751). ``center_x``/``center_z`` locate the
    support centre on the surface (reference get_centre,
    ART/ModuleMirror.py:695-714)."""

    a: jnp.ndarray
    b: jnp.ndarray
    center_x: jnp.ndarray
    center_z: jnp.ndarray


class Cylinder(NamedTuple):
    """Cylinder y^2 + z^2 = R^2 (axis along x), patch on z<0
    (ART/ModuleMirror.py:781-874)."""

    radius: jnp.ndarray


# ---------------------------------------------------------------------------
# residuals g(t): distance-like implicit functions, conditioned for float32
# ---------------------------------------------------------------------------


def _residual_sphere(surface, q, u):
    r = jnp.linalg.norm(q, axis=-1)
    g = r - surface.radius
    gp = jnp.sum(q * u, axis=-1) / jnp.maximum(r, 1e-30)
    return g, gp


def _residual_cylinder(surface, q, u):
    r = jnp.hypot(q[..., 1], q[..., 2])
    g = r - surface.radius
    gp = (q[..., 1] * u[..., 1] + q[..., 2] * u[..., 2]) / jnp.maximum(r, 1e-30)
    return g, gp


# component-form residuals: all operands are (N,)-shaped so every VPU lane
# carries a ray (a trailing candidate/xyz axis of size 2..6 would occupy the
# 128-wide lane dimension and waste ~98% of the vector unit)


def _residual_c(surface, x, y, z, ux, uy, uz):
    if isinstance(surface, Sphere):
        rr = x * x + y * y + z * z
        inv_r = jax.lax.rsqrt(jnp.maximum(rr, 1e-30))
        return rr * inv_r - surface.radius, (x * ux + y * uy + z * uz) * inv_r
    if isinstance(surface, Cylinder):
        rr = y * y + z * z
        inv_r = jax.lax.rsqrt(jnp.maximum(rr, 1e-30))
        return rr * inv_r - surface.radius, (y * uy + z * uz) * inv_r
    if isinstance(surface, Parabola):
        p = surface.p
        h = z - (x * x + y * y) / (2.0 * p)
        hp = uz - (x * ux + y * uy) / p
        scale = p * jax.lax.rsqrt(x * x + y * y + p * p)
        return h * scale, hp * scale
    if isinstance(surface, Ellipsoid):
        inv_a2 = 1.0 / (surface.a * surface.a)
        inv_b2 = 1.0 / (surface.b * surface.b)
        f = x * x * inv_a2 + (y * y + z * z) * inv_b2 - 1.0
        fp = 2.0 * (x * ux * inv_a2 + (y * uy + z * uz) * inv_b2)
        gg = (x * inv_a2) ** 2 + (y * inv_b2) ** 2 + (z * inv_b2) ** 2
        scale = 0.5 * jax.lax.rsqrt(jnp.maximum(gg, 1e-30))
        return f * scale, fp * scale
    if isinstance(surface, Toroid):
        R, r = surface.major_radius, surface.minor_radius
        rho2 = x * x + z * z
        inv_rho = jax.lax.rsqrt(jnp.maximum(rho2, 1e-30))
        w = rho2 * inv_rho - R
        s2 = w * w + y * y
        inv_s = jax.lax.rsqrt(jnp.maximum(s2, 1e-30))
        g = s2 * inv_s - r
        drho_dt = (x * ux + z * uz) * inv_rho
        gp = (w * drho_dt + y * uy) * inv_s
        return g, gp
    raise TypeError(f"unknown surface {type(surface)}")


def _polish_candidates(surface, q, u, cands, iters):
    """Newton-polish a static list of (N,) candidate roots; returns a list of
    (t, |g|, (x, y, z)) with all arrays (N,)-shaped. ``q``/``u`` are component
    triples — never stacked into (N,3), so every intermediate stays a flat
    (N,) stream that XLA fuses elementwise.

    The validity residual |g| is the one evaluated in the *final* iteration
    (i.e. at the (iters-1)-times-corrected root), while the returned t and
    hit point carry all ``iters`` corrections — one residual evaluation
    cheaper than polishing and then re-evaluating, at the same rejection
    power: converged roots have |g| at the rounding floor an iteration early,
    and spurious candidates keep an |g| far above HIT_TOL throughout."""
    assert iters >= 1
    px, py, pz = q
    ux, uy, uz = u
    out = []
    for t in cands:
        g_abs = None
        for _ in range(iters):
            x = px + t * ux
            y = py + t * uy
            z = pz + t * uz
            g, gp = _residual_c(surface, x, y, z, ux, uy, uz)
            g_abs = jnp.abs(g)
            # guard: keep t fixed where the derivative vanishes (grazing
            # turning point)
            t = t - g / jnp.where(jnp.abs(gp) > 1e-12, gp, jnp.inf)
        x = px + t * ux
        y = py + t * uy
        z = pz + t * uz
        out.append((t, g_abs, (x, y, z)))
    return out


# ---------------------------------------------------------------------------
# closed-form seeds
# ---------------------------------------------------------------------------


def _solve_quadratic(a, b, c):
    """Stable quadratic roots (citardauq form); invalid roots -> nan.

    All guards use the safe-operand double-where pattern so reverse-mode
    gradients stay finite (sqrt'(0)/0-division in unselected branches would
    otherwise poison the cotangents with 0*inf)."""
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
    sq = jnp.where(ok, sq, 0.0)
    qq = -0.5 * (b + jnp.sign(b) * sq)
    # sign(0) = 0 -> qq = -b/2; fine since then disc = -4ac and roots are +-sq/2a
    qq = jnp.where(b == 0.0, -0.5 * sq, qq)
    tiny = 1e-30
    linear = jnp.abs(a) < tiny
    # one division with operand-selected numerator/denominator instead of a
    # division per branch (a divide costs several multiplies)
    num1 = jnp.where(linear, -c, qq)
    den1 = jnp.where(
        linear,
        jnp.where(jnp.abs(b) > tiny, b, jnp.inf),
        jnp.where(jnp.abs(a) > tiny, a, jnp.inf),
    )
    t1 = num1 / den1
    t2 = jnp.where(linear, jnp.inf, c / jnp.where(jnp.abs(qq) > tiny, qq, jnp.inf))
    nan = jnp.full_like(t1, jnp.nan)
    return jnp.where(ok, t1, nan), jnp.where(ok, t2, nan)


def _quadratic_coeffs(surface, q, u):
    x, y, z = q
    ux, uy, uz = u
    if isinstance(surface, Sphere):
        a = jnp.ones_like(x)
        b = 2.0 * (ux * x + uy * y + uz * z)
        c = x * x + y * y + z * z - surface.radius**2
    elif isinstance(surface, Cylinder):
        a = uy * uy + uz * uz
        b = 2.0 * (uy * y + uz * z)
        c = y * y + z * z - surface.radius**2
    elif isinstance(surface, Parabola):
        pp = surface.p
        a = ux * ux + uy * uy
        b = 2.0 * (ux * x + uy * y) - 2.0 * pp * uz
        c = x * x + y * y - 2.0 * pp * z
    elif isinstance(surface, Ellipsoid):
        a2, b2 = surface.a**2, surface.b**2
        a = (uy * uy + uz * uz) / b2 + ux * ux / a2
        b = 2.0 * ((uy * y + uz * z) / b2 + ux * x / a2)
        c = (y * y + z * z) / b2 + x * x / a2 - 1.0
    else:
        raise TypeError(f"not a quadratic surface: {type(surface)}")
    return a, b, c


def _cbrt(x):
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)


def _largest_real_cubic_root(a2, a1, a0):
    """Largest real root of y^3 + a2 y^2 + a1 y + a0 = 0, vectorized and
    branchless (trigonometric / Cardano forms selected by jnp.where)."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * a2**3 / 27.0 - a2 * a1 / 3.0 + a0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    tri = disc <= 0.0  # (implies p <= 0)
    # three-real-root case: trigonometric solution (safe-operand guards keep
    # gradients finite in the unselected branch)
    p_safe = jnp.where(p < 0.0, p, -1.0)
    mp3 = jnp.sqrt(-p_safe / 3.0)
    denom = 2.0 * p_safe * mp3
    # epsilon inside the clip: arccos' diverges at +-1 and would inject inf
    # into the backward pass; Newton polishing absorbs the ~1e-6 root shift
    cos_arg = jnp.clip(3.0 * q / denom, -1.0 + 1e-12, 1.0 - 1e-12)
    cos_arg = jnp.where(jnp.abs(p) > 1e-30, cos_arg, 0.0)
    theta = jnp.arccos(cos_arg) / 3.0
    y_tri = 2.0 * mp3 * jnp.cos(theta)  # largest of the three roots
    # one-real-root case (disc > 0): Cardano
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    u_c = _cbrt(jnp.where(disc > 0.0, -q / 2.0 + sq, 1.0))
    v_c = _cbrt(jnp.where(disc > 0.0, -q / 2.0 - sq, 1.0))
    y_car = u_c + v_c
    w = jnp.where(tri, y_tri, y_car)
    return w - a2 / 3.0


def _quartic_roots(b, c, d, e):
    """Real roots of t^4 + b t^3 + c t^2 + d t + e (Ferrari); complex-pair
    slots are filled with nan. Returns (..., 4)."""
    # depressed quartic s^4 + P s^2 + Q s + R0, t = s - b/4
    b2 = b * b
    P = c - 3.0 * b2 / 8.0
    Q = d - b * c / 2.0 + b * b2 / 8.0
    R0 = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0
    # resolvent cubic y^3 + 2P y^2 + (P^2-4R0) y - Q^2 = 0 (root y0 >= 0)
    y0 = _largest_real_cubic_root(2.0 * P, P * P - 4.0 * R0, -Q * Q)
    y0 = jnp.maximum(y0, 0.0)
    safe_u = y0 > 1e-24
    u = jnp.sqrt(jnp.where(safe_u, y0, 1.0))
    u = jnp.where(safe_u, u, 0.0)
    qu = jnp.where(safe_u, Q / jnp.where(safe_u, 2.0 * u, 1.0), 0.0)
    A = (P + y0) / 2.0 - qu
    B = (P + y0) / 2.0 + qu
    # biquadratic fallback when Q ~ 0 (u ~ 0): s^2 = (-P +- sqrt(P^2-4R0))/2
    db = P * P - 4.0 * R0
    sq_db = jnp.sqrt(jnp.where(db > 0.0, db, 1.0))
    sq_db = jnp.where(db > 0.0, sq_db, 0.0)
    A_bq = (P + sq_db) / 2.0
    B_bq = (P - sq_db) / 2.0
    A = jnp.where(safe_u, A, A_bq)
    B = jnp.where(safe_u, B, B_bq)
    # factors: (s^2 + u s + A)(s^2 - u s + B)
    s1a, s1b = _solve_quadratic(jnp.ones_like(u), u, A)
    s2a, s2b = _solve_quadratic(jnp.ones_like(u), -u, B)
    shift = b / 4.0
    return [s1a - shift, s1b - shift, s2a - shift, s2b - shift]


def _recip(x):
    """Sign-correct ~1/x as ``x * rsqrt(x*x)^2`` — ~3 multiplies + one rsqrt
    instead of the f32 VPU divide (~7x a multiply, scripts/diag_vpu_ops.py;
    rsqrt is nearly free and full f32 precision on this backend — the
    residual/normal paths already rely on that). ``x == 0`` maps to 0; |x|
    below ~1e-18 saturates smoothly (callers reject or mask those lanes).
    Relative error ~2-3 ulp, absorbed by Newton polishing wherever it feeds a
    root update."""
    rr = jax.lax.rsqrt(jnp.maximum(x * x, 1e-36))
    return x * rr * rr


def _paraboloid_seed_pick(surface, q, u, t_eps):
    """Osculating-paraboloid seed for the float32 toroid fast path with the
    candidate *selection done in numerator/denominator form*, so only the one
    selected root is ever divided out (and that by :func:`_recip`).

    Semantics match ``_paraboloid_seeds`` + the old rank/select chain exactly:
    the nearer forward (t > t_eps) crossing on the mirror side (z(t) < 0)
    wins; with one valid candidate that one wins; with none, the first
    (sanitized) root is returned as a Newton fallback and the post-polish
    validity test rejects genuine misses. Sign tests used (d = denominator,
    n = numerator, t = n/d):

    * ``t > t_eps``      <=>  ``(n - t_eps d) d > 0``
    * ``z(t) < 0``       <=>  ``d (qz d + n uz) < 0``
    * ``t1 <= t2``       <=>  ``(n1 d2 - n2 d1) d1 d2 <= 0``

    The citardauq pair (t1 = qq/a, t2 = c/qq) degrades gracefully at the
    linear edge a -> 0 (only possible for rays along +-z, where |b| = 1):
    there qq -> -b and t2 -> -c/b is exactly the linear root, while t1's
    denominator vanishes and its validity tests go False."""
    R, r = surface.major_radius, surface.minor_radius
    x, y, z = q
    ux, uy, uz = u
    inv_2A = 0.5 / (R + r)
    inv_2B = 0.5 / r
    a = -(ux * ux * inv_2A + uy * uy * inv_2B)
    b = uz - 2.0 * (x * ux * inv_2A + y * uy * inv_2B)
    c = z + (R + r) - (x * x * inv_2A + y * y * inv_2B)
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.where(ok, jnp.sqrt(jnp.where(ok, disc, 1.0)), 0.0)
    qq = jnp.where(b == 0.0, -0.5 * sq, -0.5 * (b + jnp.sign(b) * sq))
    n1, d1 = qq, a
    n2, d2 = c, qq

    def _valid(n, d):
        forward = (n - t_eps * d) * d > 0.0
        mirror_side = d * (z * d + n * uz) < 0.0
        return forward & mirror_side

    v1 = _valid(n1, d1)
    v2 = _valid(n2, d2)
    t1_nearer = (n1 * d2 - n2 * d1) * (d1 * d2) <= 0.0
    pick1 = (~v2) | (v1 & t1_nearer)
    t = jnp.where(pick1, n1, n2) * _recip(jnp.where(pick1, d1, d2))
    # complex-pair parity with the sanitized-candidate path: no real root
    # falls back to -1 (same Newton start as the old nan -> -1 sanitize)
    return jnp.where(ok, t, -1.0)


def _paraboloid_seeds(surface, q, u):
    """Roots of the osculating paraboloid of the torus patch at its apex
    (0, 0, -(R+r)):  z = -(R+r) + x^2/(2(R+r)) + y^2/(2r).

    This matches BOTH principal curvatures of the mirror patch (the sphere of
    radius R+r only matches the major one; its error grows as y^2/2·(1/r -
    1/(R+r)), ~0.7 mm across a 32-mm-wide support of a typical grazing
    toroid, where the paraboloid's quartic-order error is ~1e-3 mm). The
    near-exact seed converges in 2-3 Newton iterations instead of 8 — the
    single hottest saving in the fused kernel."""
    R, r = surface.major_radius, surface.minor_radius
    x, y, z = q
    ux, uy, uz = u
    inv_2A = 0.5 / (R + r)
    inv_2B = 0.5 / r
    a = -(ux * ux * inv_2A + uy * uy * inv_2B)
    b = uz - 2.0 * (x * ux * inv_2A + y * uy * inv_2B)
    c = z + (R + r) - (x * x * inv_2A + y * y * inv_2B)
    return _solve_quadratic(a, b, c)


def _sphere_seeds(surface, q, u):
    """Roots of the osculating sphere |q| = R + r through the mirror patch at
    (0,0,-R-r): cheap, robust Newton seeds for realistic toroidal mirrors."""
    R, r = surface.major_radius, surface.minor_radius
    x, y, z = q
    ux, uy, uz = u
    b_s = 2.0 * (ux * x + uy * y + uz * z)
    c_s = x * x + y * y + z * z - (R + r) ** 2
    s1, s2 = _solve_quadratic(jnp.ones_like(b_s), b_s, c_s)
    return [s1, s2]


def _toroid_seeds(surface, q, u):
    """Candidate t seeds for the toroid: 4 Ferrari roots of the exact quartic
    (coefficients as in ART/ModuleMirror.py:443-466) + the 2 roots of the
    osculating sphere of radius R+r."""
    R, r = surface.major_radius, surface.minor_radius
    x, y, z = q
    ux, uy, uz = u
    K = 2.0 * (ux * x + uy * y + uz * z)
    L = x * x + y * y + z * z + R * R - r * r
    G = 4.0 * R * R * (ux * ux + uz * uz)
    H = 8.0 * R * R * (ux * x + uz * z)
    II = 4.0 * R * R * (x * x + z * z)
    b = 2.0 * K
    c = K * K + 2.0 * L - G
    dd = 2.0 * K * L - H
    e = L * L - II
    # nondimensionalize t -> t/R before solving: raw coefficients reach
    # ~1e12 (mm^4) and their resolvent-cubic discriminant ~(coeff)^3 would
    # overflow float32; scaled to O(1) the whole solve is f32-safe
    s = R
    quartic = _quartic_roots(b / s, c / s**2, dd / s**3, e / s**4)
    # sanitize *before* rescaling: nan lanes (complex root pairs) would leak
    # into s's cotangent through 0*nan in the product rule
    quartic = [jnp.where(jnp.isfinite(t), t, -1.0) * s for t in quartic]
    return quartic + _sphere_seeds(surface, q, u)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def support_offset_xy(surface):
    """Offset of the support centre in the local x-y plane: support clipping
    tests (x,y) relative to this point (reference tests Intersect minus
    get_centre() for parabola/ellipsoid, Intersect directly otherwise —
    ART/ModuleMirror.py:344, :678-680)."""
    if isinstance(surface, (Parabola, Ellipsoid)):
        return surface.center_x, 0.0
    return 0.0, 0.0


def _branch_ok_z(surface, z):
    """Physical-branch filter for candidate hits (reference's z<0 / z<-R
    conditions in each _get_intersection)."""
    if isinstance(surface, (Sphere, Cylinder, Ellipsoid)):
        return z < 0.0
    if isinstance(surface, Toroid):
        return z < -surface.major_radius
    return jnp.ones(z.shape, dtype=bool)


def intersect(surface, support, p, d, t_eps=T_EPS, tol=HIT_TOL):
    """Nearest valid ray/surface intersection for a batch of rays.

    Parameters: local-frame ray origins ``p`` (N,3) and unit directions ``d``.
    Returns ``(t, hit)`` where ``hit`` is False for rays that miss (wrong
    branch, outside support, behind the ray, or no real root).
    """
    t, hit = intersect_c(
        surface, support,
        (p[..., 0], p[..., 1], p[..., 2]),
        (d[..., 0], d[..., 1], d[..., 2]),
        t_eps=t_eps, tol=tol,
    )
    return t, hit


def _toroid_fast_root(surface, q, u, t_eps):
    """Shared float32 fast path for the toroid: pick a SINGLE seed — the
    nearest forward crossing of the osculating paraboloid on the mirror side
    (z<0); Newton converges to the torus root on the same side, which is
    exactly the reference's nearest-valid pick (ART/ModuleMirror.py:27-38 +
    the z<-R branch filter) — then apply ``_NEWTON_ITERS_TOROID_FAST - 1``
    Newton corrections and ONE final residual evaluation at the corrected
    root that is *shared* between root validation, the hit point, and (in the
    fused caller) the normal.

    Both :func:`intersect_c` and :func:`intersect_with_normal_c` call this,
    so the two return bit-identical roots for the defect and non-defect
    mirror paths. Returns ``(t, g_abs, (x, y, z), (inv_rho, inv_s, w))`` with
    the latter tuple holding the torus-geometry factors of the final
    evaluation (``w = rho - R``; the unnormalized normal has magnitude
    ``1/inv_s``)."""
    qx, qy, qz = q
    ux, uy, uz = u
    R, r = surface.major_radius, surface.minor_radius
    # nearer valid crossing wins, selected in numerator/denominator form so
    # only ONE root is divided out (see _paraboloid_seed_pick); with neither
    # valid this falls back to the (sanitized) first root, and the post-polish
    # validity test rejects it if it is a genuine miss
    t = _paraboloid_seed_pick(surface, q, u, t_eps)
    # Newton updates (the paraboloid seed converges in one; see
    # _NEWTON_ITERS_TOROID_FAST) ...
    for _ in range(_NEWTON_ITERS_TOROID_FAST - 1):
        x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
        g, gp = _residual_c(surface, x, y, z, ux, uy, uz)
        # grazing-turning-point guard: |gp| ~ 0 keeps t fixed (update -> 0)
        t = t - g * jnp.where(jnp.abs(gp) > 1e-12, _recip(gp), 0.0)
    # ... then ONE shared evaluation at the polished root yields the validity
    # residual, the hit point, and the normal factors
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    inv_rho = jax.lax.rsqrt(jnp.maximum(x * x + z * z, 1e-30))
    w = (x * x + z * z) * inv_rho - R
    s2_ = w * w + y * y
    inv_s = jax.lax.rsqrt(jnp.maximum(s2_, 1e-30))
    g_abs = jnp.abs(s2_ * inv_s - r)
    return t, g_abs, (x, y, z), (inv_rho, inv_s, w)


def intersect_c(surface, support, q, u, t_eps=T_EPS, tol=HIT_TOL):
    """Component-form intersection: ``q = (x, y, z)``, ``u = (ux, uy, uz)``
    as (N,) arrays. Returns (t, hit)."""
    qx, qy, qz = q
    ux, uy, uz = u

    if isinstance(surface, Plane):
        t = -qz / jnp.where(jnp.abs(uz) > 1e-30, uz, jnp.inf)
        ox, oy = support_offset_xy(surface)
        on_sup = sup.include(support, qx + t * ux - ox, qy + t * uy - oy)
        return t, (t > t_eps) & on_sup

    if isinstance(surface, Toroid):
        # float32 = production mode: the osculating-paraboloid seed +
        # Newton reaches the patch root without the transcendental-heavy
        # Ferrari solve (arccos/cbrt per ray); float64 = parity mode: all 4
        # exact quartic roots, matching the reference's np.roots-based
        # selection even for exotic geometries. Override with
        # ART_TPU_TOROID_EXACT=1.
        fast = qx.dtype == jnp.float32 and not _TOROID_EXACT
        if fast:
            t, g_abs, (x, y, z), _ = _toroid_fast_root(surface, q, u, t_eps)
            ox, oy = support_offset_xy(surface)
            hit = (
                (t > t_eps)
                & (g_abs < _hit_tol_for(surface, qx.dtype, tol))
                & (z < -surface.major_radius)
                & sup.include(support, x - ox, y - oy)
            )
            return jnp.where(hit, t, 0.0), hit
        cands = _toroid_seeds(surface, q, u)
        iters = _NEWTON_ITERS_TOROID
    else:
        a, b, c = _quadratic_coeffs(surface, q, u)
        t1, t2 = _solve_quadratic(a, b, c)
        cands = [t1, t2]
        iters = _NEWTON_ITERS

    cands = [jnp.where(jnp.isfinite(t), t, -1.0) for t in cands]
    polished = _polish_candidates(surface, q, u, cands, iters)
    ox, oy = support_offset_xy(surface)
    tol_eff = _hit_tol_for(surface, qx.dtype, tol)
    t_best = jnp.full(qx.shape, jnp.inf, dtype=qx.dtype)
    for t, g_abs, (x, y, z) in polished:
        valid = (
            (t > t_eps)
            & (g_abs < tol_eff)
            & _branch_ok_z(surface, z)
            & sup.include(support, x - ox, y - oy)
        )
        t_best = jnp.minimum(t_best, jnp.where(valid, t, jnp.inf))
    hit = jnp.isfinite(t_best)
    return jnp.where(hit, t_best, 0.0), hit


def normal_at_root_c(surface, x, y, z):
    """Unit 'up' normal for a point ON the surface (post-polish hit points).

    Exploits root identities to skip the normalizing rsqrt where the
    unnormalized gradient has a known magnitude at the surface: sphere
    ``|(x,y,z)| = R``, cylinder ``|(y,z)| = R``, toroid ``|(w~x, y, w~z)| = r``
    (the minor-circle radius). For points off the surface use
    :func:`normal_c`. The relative normalization error equals the polish
    residual over the radius (~1e-4 mm / R) — far below float32 resolution."""
    if isinstance(surface, Sphere):
        inv = -1.0 / surface.radius
        return x * inv, y * inv, z * inv
    if isinstance(surface, Cylinder):
        inv = -1.0 / surface.radius
        return jnp.zeros_like(x), y * inv, z * inv
    if isinstance(surface, Toroid):
        R, r = surface.major_radius, surface.minor_radius
        inv_rho = jax.lax.rsqrt(jnp.maximum(x * x + z * z, 1e-30))
        a = (1.0 - R * inv_rho) / r
        return -a * x, -y / r, -a * z
    return normal_c(surface, x, y, z)


def intersect_with_normal_c(surface, support, q, u, t_eps=T_EPS, tol=HIT_TOL):
    """Fused intersection + unit normal + hit point in component form.

    Returns ``(t, hit, (nx, ny, nz), (x, y, z))``. This is the hot-path entry
    used by the trace step: for the float32 toroid it shares the final
    Newton-residual evaluation between root validation, the hit point, and
    the normal (the unnormalized toroid normal has magnitude ``s`` — the
    distance to the tube axis — and ``1/s`` is exactly the rsqrt the validity
    residual already computes), saving two rsqrt, a divide, and a full
    point/normal re-evaluation per ray versus composing :func:`intersect_c`
    with :func:`normal_c`. Values for missed rays (``hit=False``) are finite
    garbage; callers mask by ``hit``."""
    qx, qy, qz = q
    ux, uy, uz = u

    fast = (
        isinstance(surface, Toroid)
        and jnp.result_type(qx) == jnp.float32
        and not _TOROID_EXACT
    )
    if fast:
        t, g_abs, (x, y, z), (inv_rho, inv_s, w) = _toroid_fast_root(
            surface, q, u, t_eps
        )
        a = w * inv_rho * inv_s
        nx, ny, nz = -a * x, -y * inv_s, -a * z
        ox, oy = support_offset_xy(surface)
        hit = (
            (t > t_eps)
            & (g_abs < _hit_tol_for(surface, qx.dtype, tol))
            & (z < -surface.major_radius)
            & sup.include(support, x - ox, y - oy)
        )
        return jnp.where(hit, t, 0.0), hit, (nx, ny, nz), (x, y, z)

    t, hit = intersect_c(surface, support, q, u, t_eps=t_eps, tol=tol)
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    return t, hit, normal_at_root_c(surface, x, y, z), (x, y, z)


def normal_c(surface, x, y, z):
    """Unit 'up' normal in component form; returns (nx, ny, nz) as (N,)."""
    one = jnp.ones_like(x)
    if isinstance(surface, Plane):
        zero = jnp.zeros_like(x)
        return zero, zero, one
    if isinstance(surface, Sphere):
        nx, ny, nz = -x, -y, -z
    elif isinstance(surface, Cylinder):
        nx, ny, nz = jnp.zeros_like(x), -y, -z
    elif isinstance(surface, Parabola):
        nx, ny, nz = -x, -y, jnp.broadcast_to(surface.p, x.shape)
    elif isinstance(surface, Ellipsoid):
        inv_a2 = 1.0 / (surface.a * surface.a)
        inv_b2 = 1.0 / (surface.b * surface.b)
        nx, ny, nz = -x * inv_a2, -y * inv_b2, -z * inv_b2
    elif isinstance(surface, Toroid):
        R = surface.major_radius
        inv_rho = jax.lax.rsqrt(jnp.maximum(x * x + z * z, 1e-30))
        w = 1.0 - R * inv_rho
        nx, ny, nz = -w * x, -y, -w * z
    else:
        raise TypeError(f"unknown surface {type(surface)}")
    inv = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


def normal_at(surface, q):
    """Unit surface normal pointing to the +z ('up') side, batched
    (reference get_normal methods return the same orientation)."""
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    if isinstance(surface, Plane):
        n = jnp.zeros_like(q).at[..., 2].set(1.0)
        return n
    if isinstance(surface, Sphere):
        n = -q
    elif isinstance(surface, Cylinder):
        n = jnp.stack([jnp.zeros_like(x), -y, -z], axis=-1)
    elif isinstance(surface, Parabola):
        n = jnp.stack([-x, -y, jnp.broadcast_to(surface.p, x.shape)], axis=-1)
    elif isinstance(surface, Ellipsoid):
        a2, b2 = surface.a**2, surface.b**2
        n = jnp.stack([-x / a2, -y / b2, -z / b2], axis=-1)
    elif isinstance(surface, Toroid):
        # grad of ((rho-R)^2 + y^2 - r^2), rho = sqrt(x^2+z^2); normal = -grad
        R = surface.major_radius
        inv_rho = jax.lax.rsqrt(jnp.maximum(x * x + z * z, 1e-30))
        w = 1.0 - R * inv_rho
        n = jnp.stack([-w * x, -y, -w * z], axis=-1)
    else:
        raise TypeError(f"unknown surface {type(surface)}")
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def slope_normal_add(n1, n2):
    """Compose two 'up' normals by adding their surface slopes
    (vectorized ART/ModuleGeometry.py:394-407). Returns an unnormalized
    [-sum gx, -sum gy, 1] normal."""
    g1x = -n1[..., 0] / n1[..., 2]
    g1y = -n1[..., 1] / n1[..., 2]
    g2x = -n2[..., 0] / n2[..., 2]
    g2y = -n2[..., 1] / n2[..., 2]
    return jnp.stack([-(g1x + g2x), -(g1y + g2y), jnp.ones_like(g1x)], axis=-1)
