"""Device-side detector images: intensity histograms and mean-delay maps.

The reference's analysis plots gather every ray to the host and scatter-plot
them (SpotDiagram / DelayGraph, ART/ModuleAnalysisAndPlots.py:133-440) —
fine at its 1e3 default rays, impossible at the 1e7–1e9 bundles this
framework traces. These functions bin the bundle **on device** into
fixed-size images, so only O(bins) bytes ever leave the chip, and they
compose with sharding: when the bundle is sharded over a ``('rays',)`` mesh,
each device bins its shard and XLA inserts the image all-reduce (histograms
are additive) — the gather-free production path for spot diagrams and the
spatio-temporal delay maps that are ART's raison d'être.

Everything is jittable and differentiable in the ray *weights* (binning
indices are discrete; gradients flow through intensities, not positions).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.bundle import RayBundle
from . import stats


def _detector_extent(xy, w, pad: float = 1.05):
    """Symmetric-padded bounding box of surviving impact points."""
    big = jnp.asarray(jnp.finfo(xy.dtype).max, dtype=xy.dtype)
    alive = w > 0
    lo = jnp.min(jnp.where(alive[:, None], xy, big), axis=0)
    hi = jnp.max(jnp.where(alive[:, None], xy, -big), axis=0)
    mid = 0.5 * (lo + hi)
    half = jnp.maximum(0.5 * (hi - lo) * pad, jnp.finfo(xy.dtype).tiny)
    return mid - half, mid + half


def _bin_indices(xy, lo, hi, bins):
    """Per-axis bin index + in-range mask (np.histogram2d edge semantics:
    points exactly on the upper edge fall in the last bin)."""
    nx, ny = bins
    sx = nx / (hi[0] - lo[0])
    sy = ny / (hi[1] - lo[1])
    fx = (xy[:, 0] - lo[0]) * sx
    fy = (xy[:, 1] - lo[1]) * sy
    ix = jnp.clip(fx.astype(jnp.int32), 0, nx - 1)
    iy = jnp.clip(fy.astype(jnp.int32), 0, ny - 1)
    inside = (fx >= 0) & (fx <= nx) & (fy >= 0) & (fy <= ny)
    return ix, iy, inside


_BIN_BLOCK = 8192  # rays per one-hot matmul block (operands stay ~8-16 MB)


def binned_sums(ix, iy, cols, bins, precision=None):
    """K weighted 2-D histograms via blocked ONE-HOT MATMULS instead of
    scatter-add.

    A histogram is an outer-product accumulation: ``W_k = Ex^T @ (col_k ∘
    Ey)`` with Ex/Ey the row/column one-hot matrices, a dense matrix product
    with no write conflicts (a scatter-add ``.at[flat].add`` is the plain
    alternative; which is faster on a given device is a measurement). All K
    images ride ONE matmul per block by stacking the K weighted Ey copies
    along the columns. One-hot entries are exact in every matmul precision;
    pass ``precision=jax.lax.Precision.HIGHEST`` for full input-dtype
    accuracy of the value columns (a default precision may round f32 inputs
    to TF32 or bf16, a 2⁻¹¹..2⁻⁸-relative unbiased per-element error that
    averages out in pixel sums — fine for images, not for exactness tests).
    Linear in ``cols`` ⇒ differentiable in the weights. Returns a tuple of
    K ``bins``-shaped images."""
    bx, by = bins
    dtype = cols[0].dtype
    n = ix.shape[0]
    nb = -(-n // _BIN_BLOCK)
    pad = nb * _BIN_BLOCK - n
    ixb = jnp.pad(ix, (0, pad)).reshape(nb, _BIN_BLOCK)
    iyb = jnp.pad(iy, (0, pad)).reshape(nb, _BIN_BLOCK)
    colsb = tuple(jnp.pad(c, (0, pad)).reshape(nb, _BIN_BLOCK) for c in cols)
    ax = jnp.arange(bx, dtype=jnp.int32)
    ay = jnp.arange(by, dtype=jnp.int32)

    def body(carry, blk):
        ixk, iyk = blk[0], blk[1]
        Ex = (ixk[:, None] == ax).astype(dtype)          # (B, bx)
        Ey = (iyk[:, None] == ay).astype(dtype)          # (B, by)
        rhs = jnp.concatenate([c[:, None] * Ey for c in blk[2:]], axis=1)
        return carry + jax.lax.dot(Ex.T, rhs, precision=precision), None

    init = jnp.zeros((bx, len(cols) * by), dtype)
    out, _ = jax.lax.scan(body, init, (ixb, iyb) + colsb)
    return tuple(out[:, k * by:(k + 1) * by] for k in range(len(cols)))


@partial(jax.jit, static_argnames=("bins", "intensity_weighted"))
def detector_image(
    bundle: RayBundle,
    centre,
    normal,
    rot,
    bins: tuple[int, int] = (256, 256),
    extent=None,
    intensity_weighted: bool = True,
):
    """Intensity image of the bundle on the detector plane.

    Returns ``(image, (lo, hi))`` where ``image`` is ``(bins[0], bins[1])``
    with x along axis 0 (np.histogram2d layout) and ``lo``/``hi`` are the
     2-vector in-plane corners in mm. ``extent=None`` auto-fits the surviving
    points with 5% padding; pass ``(lo, hi)`` to fix the window (required for
    comparable images across a parameter scan)."""
    xy = stats.detector_points_2d(bundle, centre, normal, rot)
    w = bundle.alive.astype(xy.dtype)
    if intensity_weighted:
        w = w * bundle.intensity
    if extent is None:
        lo, hi = _detector_extent(xy, w)
    else:
        lo = jnp.asarray(extent[0], dtype=xy.dtype)
        hi = jnp.asarray(extent[1], dtype=xy.dtype)
    ix, iy, inside = _bin_indices(xy, lo, hi, bins)
    wv = jnp.where(inside, w, 0.0)
    (img,) = binned_sums(ix, iy, (wv,), bins,
                         precision=jax.lax.Precision.HIGHEST)
    return img, (lo, hi)


@partial(jax.jit, static_argnames=("bins", "intensity_weighted"))
def value_map(
    bundle: RayBundle,
    values,
    centre,
    normal,
    rot,
    bins: tuple[int, int] = (256, 256),
    extent=None,
    intensity_weighted: bool = True,
):
    """Per-pixel weighted mean of an arbitrary per-ray scalar ``values`` on
    the detector plane (the binned generalization of the reference's
    ColorCoded scatter plots). Returns ``(mean_image, weight_image,
    (lo, hi))``; zero-weight pixels hold NaN."""
    xy = stats.detector_points_2d(bundle, centre, normal, rot)
    values = jnp.asarray(values)
    w = bundle.alive.astype(xy.dtype)
    if intensity_weighted:
        w = w * bundle.intensity
    if extent is None:
        lo, hi = _detector_extent(xy, w)
    else:
        lo = jnp.asarray(extent[0], dtype=xy.dtype)
        hi = jnp.asarray(extent[1], dtype=xy.dtype)
    ix, iy, inside = _bin_indices(xy, lo, hi, bins)
    wv = jnp.where(inside, w, 0.0)
    w_img, wd_img = binned_sums(ix, iy, (wv, wv * values), bins,
                                precision=jax.lax.Precision.HIGHEST)
    mean = jnp.where(w_img > 0, wd_img / jnp.where(w_img > 0, w_img, 1.0), jnp.nan)
    return mean, w_img, (lo, hi)


def delay_map(
    bundle: RayBundle,
    centre,
    normal,
    rot,
    bins: tuple[int, int] = (256, 256),
    extent=None,
    intensity_weighted: bool = True,
):
    """Spatio-temporal distortion image: per-pixel weighted mean delay [fs].

    Returns ``(mean_delay, weight_image, (lo, hi))``; pixels with zero weight
    hold NaN. The per-ray delays are the reference's detector delays
    (Detector.get_Delays, ART/ModuleDetector.py:254-279), so the image is the
    binned version of DelayGraph's scatter — at any bundle size."""
    delays = stats.detector_delays(bundle, centre, normal)
    return value_map(bundle, delays, centre, normal, rot, bins=bins,
                     extent=extent, intensity_weighted=intensity_weighted)
