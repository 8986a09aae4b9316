"""Giga-ray detector images: chunked fused-source tracing + device binning.

The fused-source engine (ops/xla_source.py) synthesizes and traces rays from
nothing but the ray index, so the number of rays in a "bundle" stops being
bounded by memory: this module runs the spot diagram and the spatio-temporal
delay map — ART's raison d'être (ART/ModuleAnalysisAndPlots.py:133-440) — at
billions of rays by streaming 2^23-ray chunks through the engine and
accumulating device-binned histograms. Per chunk, only the traced state
transiently exists in device memory (~300 MB) and only the O(bins^2) images
persist; nothing per-ray ever reaches the host.

Delays are accumulated against a fixed chief-ray reference (not the per-chunk
mean, which would shift chunk to chunk) and re-centred to the global weighted
mean at the end — identical semantics to Detector.get_Delays at any scale.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bundle import RayBundle
from ..ops.geometry import kahan_add
from ..ops.precision import LIGHT_SPEED_MM_S
from ..ops.source import PHI_FRAC, synth_source_c
from . import stats
from .histogram import _bin_indices, binned_sums


@partial(jax.jit, static_argnames=("bins",))
def _chunk_binned_sums(bundle: RayBundle, weights, centre, normal, rot,
                       lo, hi, opl_ref, bins):
    """(w_img, wd_img) for one traced chunk: weight and weight*delay
    histograms on a FIXED extent, delays [fs] relative to ``opl_ref``."""
    xy = stats.detector_points_2d(bundle, centre, normal, rot)
    _, t = stats.detector_points_3d(bundle, centre, normal)
    s, c = kahan_add(bundle.opl, bundle.opl_c, t)
    # (s - opl_ref) is a same-magnitude cancellation (exact); the Kahan
    # compensation then applies at full significance (see stats.detector_delays)
    delay_fs = ((s - opl_ref) - c) * (1e15 / LIGHT_SPEED_MM_S)
    w = jnp.where(bundle.alive, weights, 0.0).astype(delay_fs.dtype)
    ix, iy, inside = _bin_indices(xy, lo, hi, bins)
    wv = jnp.where(inside, w, 0.0)
    # one-hot matmul binning (analysis.histogram.binned_sums) pinned to full
    # float32: the default precision may round the value columns to TF32 or
    # bf16 (2^-11 .. 2^-8 relative per ray)
    return binned_sums(ix, iy, (wv, wv * delay_fs), bins,
                       precision=jax.lax.Precision.HIGHEST)


def _weights_c(kind, n_local, phase_i, k_frac_i, radius, pos_radius, n_each,
               n_sources, n_total, logedge):
    """Gaussian chunk weights edge**rr from the source's radial law (1.0
    when logedge is None) — jit-safe."""
    if logedge is None:
        return jnp.ones((n_local,), jnp.float32)
    kf = jnp.arange(n_local, dtype=jnp.float32)
    _p, _d, rr = synth_source_c(
        kind, kf, n_total, radius, phase_i, k_frac_i,
        pos_radius=pos_radius, n_each=n_each, n_sources=n_sources)
    return jnp.exp(logedge * rr)


@partial(jax.jit, static_argnames=(
    "baked", "bins", "chunk", "n_total", "group", "n_groups", "logedge",
    "ignore_defects", "wavelength"))
def _images_fused_xla(phases_arr, kfracs_arr, els_x, maps_x, final_x,
                      premasks_x, centre, normal, rotj, lo, hi, opl_ref, *,
                      baked, bins, chunk, n_total, group, n_groups, logedge,
                      ignore_defects, wavelength):
    """All full chunks in ONE dispatch: a fori_loop of fused-source traces
    (geometry as traced inputs; grid-defect chains included) + device
    binning into group-partitioned float32 accumulators. Module-level jit:
    repeated calls with the same chain/bins/chunk-count hit the cache."""
    from ..ops import xla_source as xs

    def body(i, carry):
        wg, wdg = carry
        s = xs._trace_run(
            els_x, maps_x, final_x, premasks_x, baked.kind,
            jnp.float32(baked.radius), phases_arr[i], kfracs_arr[i],
            jnp.float32(baked.pos_radius), chunk, n_total,
            baked.n_each, baked.n_sources, ignore_defects)
        bundle = RayBundle(
            p=jnp.stack([s.px, s.py, s.pz], axis=-1),
            d=jnp.stack([s.dx, s.dy, s.dz], axis=-1),
            opl=s.opl, opl_c=s.opl_c, alive=s.alive,
            intensity=jnp.ones((chunk,), jnp.float32),
            incidence=s.incidence,
            wavelength=jnp.asarray(wavelength, jnp.float32),
        )
        weights = _weights_c(baked.kind, chunk, phases_arr[i], kfracs_arr[i],
                             baked.radius, baked.pos_radius, baked.n_each,
                             baked.n_sources, n_total, logedge)
        wi, wdi = _chunk_binned_sums(bundle, weights, centre, normal, rotj,
                                     lo, hi, opl_ref, bins)
        g = i // group
        return wg.at[g].add(wi), wdg.at[g].add(wdi)

    init = (jnp.zeros((n_groups,) + bins, jnp.float32),
            jnp.zeros((n_groups,) + bins, jnp.float32))
    return jax.lax.fori_loop(0, phases_arr.shape[0], body, init)


def fused_source_images(
    source_spec,
    elements,
    detector,
    n_total: int | None = None,
    bins: tuple[int, int] = (512, 512),
    extent=None,
    chunk: int = 1 << 23,
    ignore_defects: bool = True,
):
    """Intensity image + mean-delay map of ``n_total`` fused-source rays.

    ``source_spec`` is a chain's FusedSourceInfo (models/chain.py);
    ``n_total`` defaults to its ray count but may be arbitrarily larger —
    the source is synthesized in-jit, so a billion-ray image costs only
    time, not memory. Returns a dict with ``image`` (weighted intensity
    histogram), ``mean_delay`` [fs, NaN off-beam, re-centred to the global
    weighted mean], ``weight_image``, ``extent`` (lo, hi) [mm], and
    ``sum_w``.

    Each chunk is synthesized + traced by the XLA fused-source engine
    (ops/xla_source.py; grid-defect chains included with
    ``ignore_defects=False``) and binned on device with full-float32 one-hot
    matmuls (analysis.histogram.binned_sums). The reference's
    SpotDiagram/DelayGraph scatter plots (ART/ModuleAnalysisAndPlots.py:
    133-440) fetch every ray to the host; nothing per-ray leaves the device
    here.
    """
    from ..ops import xla_source as xs
    from ..ops.moments import chief_ray_refs
    from ..ops.source import source_bundle
    from ..ops.trace import trace

    baked = source_spec.baked()
    n_total = int(n_total if n_total is not None else source_spec.n_rays)
    rot = detector._plane_rotation()
    centre = jnp.asarray(detector.centre, jnp.float32)
    normal = jnp.asarray(detector.normal, jnp.float32)
    rotj = jnp.asarray(rot, jnp.float32)

    opl_ref, _ = chief_ray_refs(baked, elements, detector.centre,
                                detector.normal)

    if extent is None:
        probe = source_bundle(baked, min(n_total, 1 << 17))
        pout = trace(probe, elements, keep_history=False,
                     ignore_defects=ignore_defects)
        xy = np.asarray(stats.detector_points_2d(pout, centre, normal, rotj))
        alive = np.asarray(pout.alive)
        if not alive.any():
            raise RuntimeError("no probe ray reaches the detector; cannot "
                               "auto-fit the image extent")
        lo = xy[alive].min(axis=0)
        hi = xy[alive].max(axis=0)
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo) * 1.05 + 1e-12
        lo, hi = mid - half, mid + half
    else:
        lo, hi = np.asarray(extent[0], float), np.asarray(extent[1], float)
    lo_j = jnp.asarray(lo, jnp.float32)
    hi_j = jnp.asarray(hi, jnp.float32)

    edge = source_spec.gaussian_edge
    logedge = None if edge is None else float(np.log(edge))
    if baked.kind in ("extended", "square"):
        # chunks must align to whole sub-sources / grid rows (the offset
        # laws of ops.source.synth_source_c)
        chunk = max(1, chunk // baked.n_each) * baked.n_each

    def _phase_kfrac(off):
        if baked.kind == "extended":
            i0 = off // baked.n_each
            return (float(np.mod(i0 * PHI_FRAC, 1.0)),
                    i0 / max(baked.n_sources, 1))
        if baked.kind == "square":
            return float(off // baked.n_each), 0.0  # row offset in the phase slot
        return float(np.mod(off * PHI_FRAC, 1.0)), off / n_total

    els_x, maps_x, final_x, premasks_x = xs.device_inputs(baked, elements)
    wavelength = float(source_spec.wavelength)

    # cross-group accumulation on host in float64: pixel weights can exceed
    # the f32 integer range (2^24) on giga-ray scans
    w_img = np.zeros(bins, np.float64)
    wd_img = np.zeros(bins, np.float64)

    # all FULL chunks run in ONE dispatch: a fori_loop of fused traces +
    # device binning, group-partitioned f32 accumulators (<= GROUP chunks per
    # group keeps pixel sums < 2^26, ~1e-6 relative reassociation), groups
    # summed on the host in f64 — no per-chunk host round trip
    GROUP = 8
    offs = list(range(0, n_total - chunk + 1, chunk))
    rest_off = len(offs) * chunk

    if len(offs) > 1:
        pk = [_phase_kfrac(o) for o in offs]
        phases = jnp.asarray([p for p, _ in pk], jnp.float32)
        kfracs = jnp.asarray([k for _, k in pk], jnp.float32)
        wg, wdg = _images_fused_xla(
            phases, kfracs, els_x, maps_x, final_x, premasks_x,
            centre, normal, rotj, lo_j, hi_j, jnp.float32(opl_ref),
            baked=baked, bins=bins, chunk=chunk, n_total=n_total,
            group=GROUP, n_groups=-(-len(offs) // GROUP), logedge=logedge,
            ignore_defects=ignore_defects, wavelength=wavelength)
        w_img += np.asarray(wg, np.float64).sum(axis=0)
        wd_img += np.asarray(wdg, np.float64).sum(axis=0)
    elif offs:
        rest_off = 0  # single full chunk: take the remainder path below

    # remainder (and the single-chunk case): per-chunk dispatch
    off = rest_off
    while off < n_total:
        n_local = min(chunk, n_total - off)
        phase_i, k_frac_i = _phase_kfrac(off)
        bundle = xs.xla_trace_source(
            baked, elements, n_local, wavelength=wavelength,
            phase=jnp.float32(phase_i), k_frac=jnp.float32(k_frac_i),
            n_total=n_total, ignore_defects=ignore_defects,
            inputs=(els_x, maps_x, final_x, premasks_x))
        weights = _weights_c(baked.kind, n_local, jnp.float32(phase_i),
                             jnp.float32(k_frac_i), baked.radius,
                             baked.pos_radius, baked.n_each, baked.n_sources,
                             n_total, logedge)
        wi, wdi = _chunk_binned_sums(bundle, weights, centre, normal, rotj,
                                     lo_j, hi_j, jnp.float32(opl_ref), bins)
        w_img += np.asarray(wi, np.float64)
        wd_img += np.asarray(wdi, np.float64)
        off += n_local

    sum_w = w_img.sum()
    global_mean = wd_img.sum() / max(sum_w, 1e-30)
    mean_delay = np.where(w_img > 0, wd_img / np.where(w_img > 0, w_img, 1.0) - global_mean,
                          np.nan)
    return {
        "image": w_img,
        "mean_delay": mean_delay,
        "weight_image": w_img,
        "extent": (lo, hi),
        "sum_w": sum_w,
        "n_total": n_total,
    }
