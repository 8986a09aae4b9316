"""In-jit source synthesis: Vogel-spiral sources from the ray index.

A factory source (point-source cone, plane-wave disk, extended source, square
grid) is pure math of the ray index, so the fused engines
(:mod:`attosecondraytracing_tpu.ops.xla_source`) synthesize it inside the same
XLA program that traces it: no host bundle is built and no per-ray source is
read from device memory. Every formula here uses float operations only and
is exact in float32 over a chunk of < 2^24 rays; larger sources are covered
by chunks (or shards) that carry a (phase, k_frac) offset of the global
spiral (:func:`source_chunks`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .bundle import RayBundle


class FusedEngineUnsupported(ValueError):
    """A fused engine cannot take this input (the streamed trace can): the
    one error a caller may answer by falling back to the streamed path."""


def bake(x):
    """Nested python-float tuples from an array: hashable (usable as a jit
    static argument) and weakly typed, so they never upcast float32 math."""
    arr = np.asarray(x)
    if arr.ndim == 0:
        return float(arr)
    if arr.ndim == 1:
        return tuple(float(v) for v in arr)
    return tuple(tuple(float(v) for v in row) for row in arr)


#: golden-ratio turn fraction 1 - 1/phi and its 2^8 / 2^16 multiples mod 1,
#: so frac(k * phi) splits into exact small-float products (see _vogel_xy_c)
PHI_FRAC = 0.3819660112501051
_PHI_G = tuple(float(np.mod(PHI_FRAC * 256.0**i, 1.0)) for i in range(3))

# minimax-fit sin(pi x) / cos(pi x) on [-1, 1] (max err ~1e-9, below f32;
# regenerate: least-squares on cos-spaced nodes)
_SIN_PI = (3.1415926362231827, -5.16771212974953, 2.550156988459466,
           -0.599230762176276, 0.08206264637303859, -0.007259921822795766,
           0.00039054382726498024)
_COS_PI = (0.999999999885547, -4.934802185862838, 4.058711817231867,
           -1.3352602860924583, 0.2353208253010271, -0.025785808393817295,
           0.0019043286626063097, -8.869084444024393e-05)


def _sincos_pi(x):
    """(sin(pi x), cos(pi x)) for x in [-1, 1] via even/odd polynomials —
    pure mul/add, so every backend (and the host NumPy path) evaluates the
    spiral with the same arithmetic."""
    x2 = x * x
    s = jnp.asarray(_SIN_PI[-1], x.dtype)
    for c in _SIN_PI[-2::-1]:
        s = s * x2 + c
    s = s * x
    c_ = jnp.asarray(_COS_PI[-1], x.dtype)
    for c in _COS_PI[-2::-1]:
        c_ = c_ * x2 + c
    return s, c_


def _vogel_xy_c(kf, n_rays: int, radius: float, phase=0.0, k_frac=0.0):
    """Vogel-spiral coordinates from exact-integer-valued float ray indices
    ``kf`` (float ops only).

    The golden angle ``frac(k * phi)`` is computed by splitting k into base-256
    digits so every product is exactly representable in float32 and the final
    frac() loses at most ~6e-5 turns (~4e-4 rad of spiral phase — irrelevant
    to the spiral's equidistribution, and identical in every engine). Radii
    are exact: ``radius * sqrt(k / N)`` (host Vogel semantics,
    ops/host_geometry.py).

    Sharded giga-ray sources: a device responsible for global rays
    ``[off, off + n_local)`` passes local indices ``kf`` in [0, n_local),
    ``phase = frac(off * phi)`` (computed host-side in float64 — the global
    golden angle is then EXACT), and ``k_frac = off / n_total`` with
    ``n_rays = n_total`` — the global radius law without ever forming a
    > 2^24 float index."""
    # NOTE: ``kf`` values (local indices) must stay < 2^24 for float
    # exactness — callers chunk/shard larger ranges and pass phase/k_frac;
    # ``n_rays`` (the global total) may be arbitrarily large (it only enters
    # the smooth radius law).
    a = jnp.floor(kf * (1.0 / 65536.0))
    rem = kf - a * 65536.0
    b = jnp.floor(rem * (1.0 / 256.0))
    c = rem - b * 256.0
    tt = a * _PHI_G[2] + b * _PHI_G[1] + c * _PHI_G[0] + phase
    fr = tt - jnp.floor(tt)  # theta in turns, [0, 1)
    x = 2.0 * fr - 1.0       # [-1, 1): theta = pi (x + 1)
    s, co = _sincos_pi(x)
    r = radius * jnp.sqrt(kf * (1.0 / n_rays) + k_frac)
    return -r * co, -r * s   # (r cos theta, r sin theta)


def _divmod_exact(kf, n: int):
    """(q, r) = divmod(kf, n) for exact-integer-valued float ``kf`` < 2^23
    and integer 64 <= n < 2^22: q comes from a rounded reciprocal product
    (off by at most one) and is corrected so r = kf - q*n is the EXACT
    remainder (every product stays exactly representable in float32)."""
    q = jnp.round(kf * (1.0 / n))
    r = kf - q * n
    too_low = r < 0.0
    q = jnp.where(too_low, q - 1.0, q)
    r = jnp.where(too_low, r + n, r)
    too_high = r >= n
    q = jnp.where(too_high, q + 1.0, q)
    r = jnp.where(too_high, r - n, r)
    return q, r


def synth_source_c(kind, kf, n_total, radius, phase=0.0, k_frac=0.0, *,
                   pos_radius=0.0, n_each=0, n_sources=0):
    """Canonical-frame source synthesis from float ray indices (float ops
    only). Returns ``((px,py,pz), (dx,dy,dz), rr)`` where ``rr`` is the
    Gaussian radial-law argument in [0, 1]
    (ApplyGaussianIntensityToRayList semantics: (tan th / tan div)^2 for
    diverging sources, (r/R)^2 for plane waves; weight = edge**rr).

    ``kind='extended'``: ray k decodes to (sub-source i, cone ray j) =
    divmod(k, n_each); ``phase``/``k_frac`` then offset the POSITION spiral
    (i), so chunked/sharded calls must align chunk boundaries to whole
    sub-sources. The cone spiral (j) needs no offset — every sub-source
    emits the identical cone.

    ``kind='square'`` (ART PlaneWaveSquare, ModuleSource.py:173-207 — broken
    there, fixed in models.sources): ray k decodes to grid indices (row i,
    col j) = divmod(k, n_side) with ``n_side`` in ``n_each`` and the side
    length in ``radius``; ``phase`` carries the integer ROW offset for
    chunked calls (the grid has no spiral phase), so chunk boundaries must
    align to whole rows. ``rr`` is corner-normalized: (x²+y²)/(L²/2), the
    exact ApplyGaussianIntensityToRayList law for this grid (the corner ray
    IS the farthest ray)."""
    zeros = jnp.zeros_like(kf)
    ones = zeros + 1.0

    def _rr(x, y):  # Gaussian radial law; radius may be a traced scalar
        return (x * x + y * y) / (jnp.maximum(radius, 1e-300) ** 2)

    if kind == "extended":
        qi, rj = _divmod_exact(kf, n_each)
        sx, sy = _vogel_xy_c(qi, n_sources, 1.0, phase, k_frac)
        sx, sy = sx * pos_radius, sy * pos_radius
        ax, ay = _vogel_xy_c(rj, n_each, 1.0)
        ax, ay = ax * radius, ay * radius
        inv = jax.lax.rsqrt(ax * ax + ay * ay + 1.0)
        return (sx, sy, zeros), (ax * inv, ay * inv, inv), _rr(ax, ay)
    if kind == "square":
        qi, rj = _divmod_exact(kf, n_each)
        qi = qi + phase  # chunk row offset (integer-valued float)
        # host parity: np.linspace(-L/2, L/2, n_side) -> step L/(n_side-1)
        inv_step = 1.0 / (n_each - 1) if n_each > 1 else 0.0
        x = (qi * inv_step - 0.5) * radius
        y = (rj * inv_step - 0.5) * radius
        rr = (x * x + y * y) / (jnp.maximum(radius, 1e-300) ** 2 * 0.5)
        return (x, y, zeros), (zeros, zeros, ones), rr
    cx, cy = _vogel_xy_c(kf, n_total, 1.0, phase, k_frac)
    cx, cy = cx * radius, cy * radius
    if kind == "cone":
        inv = jax.lax.rsqrt(cx * cx + cy * cy + 1.0)
        return (zeros, zeros, zeros), (cx * inv, cy * inv, inv), _rr(cx, cy)
    # 'disk': parallel rays on the spiral
    return (cx, cy, zeros), (zeros, zeros, ones), _rr(cx, cy)


def source_chunks(kind, n_rays, n_total, n_each=0, n_sources=0,
                  chunk=1 << 23, phase=0.0, k_frac=0.0):
    """Kind-aware [(n_local, phase, k_frac)] chunk list covering the global
    source. Plain spirals chunk at arbitrary ray offsets (exact global
    golden angle via frac(off * phi)); 'extended' chunks align to whole
    sub-sources and offset the POSITION spiral instead; 'square' chunks
    align to whole grid rows with the row offset riding in the phase slot."""
    chunks = []
    if kind == "square":
        n_side = n_each
        per = max(1, chunk // n_side) * n_side
        off = 0
        while off < n_rays:
            chunks.append((min(per, n_rays - off),
                           float(phase) + off // n_side, 0.0))
            off += per
        return chunks
    if kind == "extended":
        if n_each >= 1 << 22:
            raise FusedEngineUnsupported(
                f"extended-source cones of {n_each} rays exceed the exact "
                f"float div-mod range (2^22); use the streamed trace")
        per = max(1, chunk // n_each) * n_each
        off = 0
        while off < n_rays:
            i0 = off // n_each
            chunks.append((
                min(per, n_rays - off),
                float(np.mod(float(phase) + i0 * PHI_FRAC, 1.0)),
                float(k_frac) + i0 / max(n_sources, 1),
            ))
            off += per
        return chunks
    off = 0
    while off < n_rays:
        n_local = min(chunk, n_rays - off)
        chunks.append((
            n_local,
            float(np.mod(float(phase) + off * PHI_FRAC, 1.0)),
            float(k_frac) + off / n_total,
        ))
        off += n_local
    return chunks


class BakedSource(NamedTuple):
    """Hashable description of a synthesizable source (canonical frame:
    beam along +z; ``rot``/``origin`` place it in the lab).

    ``kind='extended'`` (ART ExtendedSource, ModuleSource.py:85-131) is a
    Vogel grid of ``n_sources`` point sources over a disk of radius
    ``pos_radius``, each emitting the SAME ``n_each``-ray cone of
    half-divergence atan(``radius``): ray k decodes into (source i, cone
    ray j) = divmod(k, n_each) with an exact float div-mod."""

    kind: str       # 'cone' (point source) | 'disk' (plane-wave disk) | 'extended' | 'square'
    rot: tuple      # 3x3 canonical->lab rotation
    origin: tuple   # lab-frame source point / disk centre
    radius: float   # tan(divergence) for 'cone'/'extended', beam radius [mm] for 'disk'
    pos_radius: float = 0.0   # source-disk radius [mm] ('extended')
    n_each: int = 0           # cone rays per sub-source ('extended'), grid side ('square')
    n_sources: int = 0        # sub-source count ('extended')


def make_source_spec(kind: str, S, Axis, param: float, diameter: float = 0.0,
                     n_rays: int = 0) -> BakedSource:
    """BakedSource from reference-style source arguments.

    ``kind='cone'``: point source at ``S`` with half-divergence ``param``
    [rad] (ART PointSource, ModuleSource.py:54-81). ``kind='disk'``:
    plane-wave disk of radius ``param`` [mm] centred at ``S`` (ART
    PlaneWaveDisk, ModuleSource.py:135-169). ``kind='extended'``: Vogel grid
    of point sources over a disk of ``diameter``, each a ``param``-rad cone
    (ART ExtendedSource, ModuleSource.py:85-131 — same sub-source count
    heuristics as models.sources.ExtendedSource, which need ``n_rays``)."""
    from .host_geometry import rotation_from_to

    axis = np.asarray(Axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    # canonical->lab: p_lab = R p_c (sources._finish applies points @ R.T)
    rot = rotation_from_to(np.array([0.0, 0.0, 1.0]), axis)
    base = dict(rot=bake(rot), origin=bake(np.asarray(S, float)))
    if kind == "extended":
        from .host_geometry import extended_source_counts

        n_sources, n_each = extended_source_counts(diameter, n_rays)
        return BakedSource(kind=kind, radius=float(np.tan(param)),
                           pos_radius=float(diameter) / 2.0,
                           n_each=n_each, n_sources=n_sources, **base)
    if kind == "square":
        # collimated square grid: param = side length [mm]; the emitted
        # count is n_side^2 (models.sources.PlaneWaveSquare semantics)
        n_side = max(int(np.sqrt(n_rays)), 1)
        return BakedSource(kind=kind, radius=float(param), n_each=n_side,
                           **base)
    radius = float(np.tan(param)) if kind == "cone" else float(param)
    return BakedSource(kind=kind, radius=radius, **base)


def source_bundle(spec: BakedSource, n_rays: int, wavelength=50e-6, phase=0.0,
                  k_frac=0.0, n_total=None) -> RayBundle:
    """Plain-jnp builder of the exact float32 bundle the fused engines
    synthesize, for probes, tests and consumers that need the source side
    (e.g. the transmission denominator)."""
    kf = jnp.arange(n_rays, dtype=jnp.float32)
    (px, py, pz), (dx, dy, dz), _rr = synth_source_c(
        spec.kind, kf, n_total or n_rays, spec.radius, jnp.float32(phase),
        jnp.float32(k_frac), pos_radius=spec.pos_radius, n_each=spec.n_each,
        n_sources=spec.n_sources)
    zeros = jnp.zeros((n_rays,), dtype=jnp.float32)
    p = jnp.stack([px + zeros, py + zeros, pz + zeros], axis=-1)
    d = jnp.stack([dx + zeros, dy + zeros, dz + zeros], axis=-1)
    rot = jnp.asarray(spec.rot, jnp.float32)
    origin = jnp.asarray(spec.origin, jnp.float32)
    # full-f32 matmul: a reduced-precision default (bf16 or TF32 passes)
    # would tilt probe rays by ~1e-3 rad, throwing the chief-ray reference
    # path off by millimetres
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return RayBundle(
        p=mm(p, rot.T) + origin,
        d=mm(d, rot.T),
        opl=zeros, opl_c=zeros,
        alive=jnp.ones((n_rays,), dtype=bool),
        intensity=jnp.ones((n_rays,), dtype=jnp.float32),
        incidence=zeros,
        wavelength=jnp.asarray(wavelength, jnp.float32),
    )


def total_source_weight(n_rays: int, gaussian_edge: float | None,
                        n_each: int = 0, n_sources: int = 0,
                        kind: str | None = None) -> float:
    """Closed-form total source weight Sum_k exp(ln(edge) * rr_k) — the
    transmission denominator for fused scans. For plain spirals rr_k = k/n
    (geometric series, O(1) at any ray count); for extended sources every
    sub-source emits the identical cone, so the total is n_sources times
    the per-cone series; for 'square' grids the corner-normalized law
    edge**((x²+y²)/(L²/2)) separates into a product of two identical
    O(n_side) 1-D sums."""
    if gaussian_edge is None:
        return float(n_rays)
    if kind == "square":
        n_side = n_each
        # normalized coordinates x/L in [-1/2, 1/2]; rr = 2 (x/L)² + 2 (y/L)²
        xs = (np.linspace(-0.5, 0.5, n_side) if n_side > 1
              else np.array([-0.5]))
        s = float(np.exp(np.log(gaussian_edge) * 2.0 * xs * xs).sum())
        return s * s
    if n_each:
        return n_sources * total_source_weight(n_each, gaussian_edge)
    c = float(np.log(gaussian_edge) / n_rays)
    # sum_{k=0}^{n-1} e^{ck} = (e^{cn} - 1) / (e^c - 1)
    return float(np.expm1(c * n_rays) / np.expm1(c))
