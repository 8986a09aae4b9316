"""Device-side surface-defect evaluation (height offsets and slopes).

The reference wraps mirrors in a DeformedMirror whose intersection is shifted
along the ray by the local height error, and whose normal is composed from the
base normal and per-defect slope normals (ART/ModuleMirror.py:945-981,
ART/ModuleGeometry.py:394-407). Host-side construction (PSD synthesis,
measured-map ingestion) lives in :mod:`attosecondraytracing_tpu.models.defects`;
here are the batched, jittable lookup kernels that run inside the trace.

Two device representations:

* :class:`GridDefect` — height + precomputed slope maps on a regular grid,
  bilinearly interpolated (the JAX equivalent of the reference's
  RegularGridInterpolator usage, ART/ModuleDefects.py:34-146);
* :class:`ZernikeDefect` — coefficients evaluated exactly on device through
  the Andersen recurrence (differentiable in the coefficients, enabling
  Zernike-coefficient fitting; ART/ModuleDefects.py:149-181).

Note: the reference's Fourrier/MeasuredMap ``get_normal`` returns
[+dX, +dY, ...] while its Zernike returns [-dX, -dY, 1]
(ART/ModuleDefects.py:52-58 vs :156-166). For a height map h(x, y) the correct
'up' normal is [-dh/dx, -dh/dy, 1]; we use that consistently for all defect
types (divergence noted per SURVEY.md §7 "implement the intended behavior").
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .zernike import zernike_value_and_grad


class GridDefect(NamedTuple):
    """Regular-grid height/slope maps, indexed [ix, iy]."""

    height: jnp.ndarray  # (Nx, Ny)
    slope_x: jnp.ndarray  # (Nx, Ny) dh/dx
    slope_y: jnp.ndarray  # (Nx, Ny) dh/dy
    x0: jnp.ndarray  # () grid origin
    y0: jnp.ndarray
    dx: jnp.ndarray  # () grid spacing
    dy: jnp.ndarray


class ZernikeDefect(NamedTuple):
    """Zernike-sum height error over the circumscribed circle of radius R.

    ``coeffs`` maps the Andersen (n, m) index (static) to a scalar coefficient
    (traced), so gradients flow into the coefficients. A hashable tuple of
    ((n, m), float) pairs is accepted too.
    """

    coeffs: dict  # or tuple[((n, m), float), ...]
    radius: jnp.ndarray  # () circumscribed-circle radius used to normalize


def _coeff_items(coeffs):
    return coeffs.items() if isinstance(coeffs, dict) else coeffs


def _bilinear_multi(grids, x0, y0, dx, dy, x, y):
    """Clamped bilinear interpolation of several SAME-SHAPE grids at physical
    (x, y), sharing one index/weight computation and gathering each corner as
    a packed ``len(grids)``-wide row from a flattened (nx*ny, K) view.

    The packed rows turn 4 gathers per map into 4 gathers per pass (one
    row read serves every map); whether this beats per-grid 2-D
    ``grid[ix, iy]`` gathers on the H100 is not measured. Returns a list of
    (N,) values, one per grid."""
    nx, ny = grids[0].shape
    fx = (x - x0) / dx
    fy = (y - y0) / dy
    fx = jnp.clip(fx, 0.0, nx - 1.000001)
    fy = jnp.clip(fy, 0.0, ny - 1.000001)
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
    wx = fx - ix
    wy = fy - iy
    # (nx*ny, K) packed view: one cheap elementwise copy per trace (XLA
    # hoists/CSEs it), repaid by 3x fewer, better-lowered gathers
    packed = jnp.stack([g.reshape(-1) for g in grids], axis=-1)
    base = ix * ny + iy
    c00 = packed[base]
    c10 = packed[base + ny]
    c01 = packed[base + 1]
    c11 = packed[base + ny + 1]
    w00 = ((1 - wx) * (1 - wy))[..., None]
    w10 = (wx * (1 - wy))[..., None]
    w01 = ((1 - wx) * wy)[..., None]
    w11 = (wx * wy)[..., None]
    vals = c00 * w00 + c10 * w10 + c01 * w01 + c11 * w11
    return [vals[..., k] for k in range(len(grids))]


def _bilinear(grid, x0, y0, dx, dy, x, y):
    """Clamped bilinear interpolation of one grid at physical (x, y)."""
    return _bilinear_multi((grid,), x0, y0, dx, dy, x, y)[0]


def defect_offset(defect, x, y):
    """Height error h(x, y) [mm] at local support coordinates, batched."""
    if isinstance(defect, GridDefect):
        return _bilinear(defect.height, defect.x0, defect.y0, defect.dx, defect.dy, x, y)
    if isinstance(defect, ZernikeDefect):
        items = tuple(_coeff_items(defect.coeffs))
        xn = x / defect.radius
        yn = y / defect.radius
        max_order = max(k[0] for k, _ in items)
        Z, _, _ = zernike_value_and_grad(xn, yn, max_order)
        h = jnp.zeros_like(xn)
        for k, c in items:
            h = h + c * Z[k]
        return h
    raise TypeError(f"unknown defect type {type(defect)}")


def defect_slopes(defect, x, y):
    """(dh/dx, dh/dy) at local support coordinates, batched."""
    if isinstance(defect, GridDefect):
        gx, gy = _bilinear_multi((defect.slope_x, defect.slope_y),
                                 defect.x0, defect.y0, defect.dx, defect.dy,
                                 x, y)
        return gx, gy
    if isinstance(defect, ZernikeDefect):
        items = tuple(_coeff_items(defect.coeffs))
        xn = x / defect.radius
        yn = y / defect.radius
        max_order = max(k[0] for k, _ in items)
        _, DX, DY = zernike_value_and_grad(xn, yn, max_order)
        gx = jnp.zeros_like(xn)
        gy = jnp.zeros_like(xn)
        for k, c in items:
            gx = gx + c * DX[k]
            gy = gy + c * DY[k]
        return gx / defect.radius, gy / defect.radius
    raise TypeError(f"unknown defect type {type(defect)}")
