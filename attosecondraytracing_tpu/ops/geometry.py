"""Vectorized geometry kernels (JAX).

Batched replacement for the reference's per-ray quaternion geometry
(ART/ModuleGeometry.py). Rotations are plain 3x3 matrices applied as batched
matmuls; everything is shape-static and differentiable.

Host-side (NumPy, float64) counterparts used for scene *construction* live in
:mod:`attosecondraytracing_tpu.ops.host_geometry`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize(v, axis=-1, eps=0.0):
    """Unit vector(s) along ``axis`` (ART/ModuleGeometry.py:17)."""
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def angle_between(u, v, axis=-1):
    """Angle between vectors, W. Kahan's numerically stable formula
    (ART/ModuleGeometry.py:40-44). Works on batched inputs."""
    nu = jnp.linalg.norm(u, axis=axis, keepdims=True)
    nv = jnp.linalg.norm(v, axis=axis, keepdims=True)
    a = jnp.linalg.norm(u * nv - v * nu, axis=axis)
    b = jnp.linalg.norm(u * nv + v * nu, axis=axis)
    return 2.0 * jnp.arctan2(a, b)


def rotation_around_axis(axis, angle):
    """Rodrigues rotation matrix for rotation by ``angle`` around ``axis``.

    Matrix equivalent of the reference's quaternion exponential
    (ART/ModuleGeometry.py:321-329). ``R @ v`` rotates ``v``.
    """
    k = normalize(jnp.asarray(axis, dtype=jnp.result_type(float)))
    kx, ky, kz = k[0], k[1], k[2]
    K = jnp.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]], dtype=k.dtype)
    eye = jnp.eye(3, dtype=k.dtype)
    s, c = jnp.sin(angle), jnp.cos(angle)
    # full-f32 matmul: a reduced-precision default (bf16 or TF32 passes)
    # would put ~1e-3 error on
    # rotation entries (~0.5 mm of traced-geometry displacement per 500 mm)
    KK = jnp.matmul(K, K, precision=jax.lax.Precision.HIGHEST)
    return eye + s * K + (1.0 - c) * KK


def frame_rotation(normal, majoraxis):
    """Rotation matrix mapping the lab frame onto the optic frame.

    ``R @ majoraxis = ex``, ``R @ normal = ez`` — the matrix form of the
    reference's two successive quaternion rotations in the tracing loop
    (ART/ModuleProcessing.py:288-295). Rows are the optic-frame basis vectors
    expressed in lab coordinates, so this is exactly the unique proper rotation
    carrying (majoraxis, normal x majoraxis, normal) -> (ex, ey, ez).
    """
    n = jnp.asarray(normal)
    m = jnp.asarray(majoraxis)
    return jnp.stack([m, jnp.cross(n, m), n], axis=0)


def vogel_spiral(n_points: int, radius, dtype=None):
    """(n_points, 2) Vogel golden-angle spiral filling a disk of ``radius``
    (ART/ModuleGeometry.py:61-76). Deterministic, matches the reference's
    point layout exactly."""
    dtype = dtype or jnp.result_type(float)
    golden = jnp.pi * (3.0 - jnp.sqrt(5.0))
    k = jnp.arange(n_points, dtype=dtype)
    r = jnp.sqrt(k / n_points) * radius
    theta = golden * k
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def reflect(d, n):
    """Specular reflection of direction(s) ``d`` on unit normal(s) ``n``.

    Equivalent to the reference's SymmetricalVector(-d, n) (rotate -d by pi
    around n; ART/ModuleGeometry.py:272-276, ModuleMirror.py:878-906):
    d' = d - 2 (d.n) n.
    """
    dn = jnp.sum(d * n, axis=-1, keepdims=True)
    return d - 2.0 * dn * n


def kahan_add(s, c, x):
    """One step of classic Kahan-compensated accumulation.

    ``c`` holds the rounding *excess* already absorbed into ``s`` (classic
    convention: ``c = (t - s) - y``), so the invariant is
    ``s' - c' ~= (s - c) + x`` to roughly twice the working precision. The
    refined readout is therefore ``s - c`` (see ``bundle.total_path``).
    """
    y = x - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def line_plane_intersection(p, d, plane_point, plane_normal):
    """Batched line/plane intersection (ART/ModuleGeometry.py:48-57).

    ``p``/``d`` are (..., 3); returns (t, point)."""
    num = jnp.sum(plane_normal * (plane_point - p), axis=-1)
    den = jnp.sum(d * plane_normal, axis=-1)
    t = num / den
    return t, p + t[..., None] * d
