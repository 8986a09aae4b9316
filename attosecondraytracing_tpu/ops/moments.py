"""Detector moments: the distance-independent epilogue of the fused engines.

For a fixed traced bundle, every per-distance detector statistic the
optimizer needs (weighted spot means and variances, delay mean and variance)
is an EXACT quadratic in the detector shift d — the alive mask cannot depend
on where the detector sits. So a fused pass reduces 16 weighted moments
(:data:`MOMENT_FIELDS`) once, and any number of scan distances are evaluated
on the host in float64 (:func:`moments_to_distance_sums`,
:func:`sums_to_stats`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .source import BakedSource, FusedEngineUnsupported, bake, source_bundle
from .trace import TraceState, compose_chain


class BakedDetector(NamedTuple):
    """Detector plane expressed in the LAST element's patch-relative frame
    (so the fused pass never returns to lab coordinates): ``centre``/
    ``normal`` are the plane, ``e1``/``e2`` the in-plane axes of the detector
    frame (rows of the host Detector's plane rotation), ``opl_ref`` a
    chief-ray reference path subtracted before squaring so float32 delay
    accumulation never squares metre-scale numbers, and ``inv_dn_chief`` the
    chief ray's 1/(d.n): the epilogue subtracts it from each ray's own
    inverse plane-approach rate so the distance coefficient of the delay
    stays fs/mm-scale."""

    centre: tuple
    normal: tuple
    e1: tuple
    e2: tuple
    opl_ref: float = 0.0
    inv_dn_chief: float = 0.0


def bake_detector(elements, det_centre, det_normal, det_rot, opl_ref=0.0,
                  inv_dn_chief=0.0) -> BakedDetector:
    """Express a lab-frame detector plane in the final element's
    patch-relative frame (see run_chain_chained's output convention:
    p_lab = R_K^T x_rel + pos_K)."""
    _, final = compose_chain(elements)
    R_K, pos_K = final
    R_K = np.asarray(R_K, dtype=np.float64)
    c_rel = R_K @ (np.asarray(det_centre, np.float64) - np.asarray(pos_K, np.float64))
    n_rel = R_K @ np.asarray(det_normal, np.float64)
    rot = np.asarray(det_rot, np.float64)
    return BakedDetector(
        centre=bake(c_rel), normal=bake(n_rel), e1=bake(R_K @ rot[0]),
        e2=bake(R_K @ rot[1]), opl_ref=float(opl_ref),
        inv_dn_chief=float(inv_dn_chief),
    )


#: distance-independent weighted moments accumulated by the moment epilogue,
#: in output order. Per ray, with x0/y0/d0 the impact coordinates and (small)
#: delay at scan distance 0 and cx/cy/cd their (small) distance-coefficients
#: (x_j = x0 - d cx, y_j = y0 - d cy, delay_j = d0 - d cd), every
#: per-distance weighted sum the stats need is an EXACT quadratic in the
#: scan distance d.
MOMENT_FIELDS = (
    "w", "x0", "y0", "d0", "cx", "cy", "cd",
    "x0x0", "y0y0", "d0d0", "x0cx", "y0cy", "d0cd",
    "cxcx", "cycy", "cdcd",
)


def moment_sums(s: TraceState, det: BakedDetector, weights,
                centre_distance=0.0):
    """The 16 weighted moment sums of a traced state, a (16,) vector in
    :data:`MOMENT_FIELDS` order.

    Conditioning: ``d0`` is the delay relative to the chief ray (fs-scale),
    ``cd = inv_dn - inv_dn_chief`` the *deviation* of the ray's inverse
    plane-approach rate from the chief ray's, so no delay moment ever squares
    an mm-scale number. The spot moments square the impact coordinates AT
    THE EXPANSION POINT ``centre_distance`` [mm, a runtime scalar —
    shiftByDistance convention]: pass a point near the focus (e.g. from a
    cheap probe estimate) when the d=0 plane is far from it — squaring
    multi-mm off-focus coordinates in the f32 accumulator would otherwise
    bury the µm-scale focal variance in reconstruction cancellation.
    Host-side evaluation must use distances RELATIVE to the same expansion
    point (moments_to_distance_sums' ``centre_distance``)."""
    w = jnp.where(s.alive, weights, 0.0)
    c, n = det.centre, det.normal
    dn = s.dx * n[0] + s.dy * n[1] + s.dz * n[2]
    # keep the exact divide: a reciprocal approximation's noise on the
    # ~500 mm leg would add ~0.4 fs of per-ray delay noise
    inv_dn = 1.0 / jnp.where(jnp.abs(dn) > 1e-30, dn, jnp.inf)
    b0 = (c[0] - s.px) * n[0] + (c[1] - s.py) * n[1] + (c[2] - s.pz) * n[2]
    t0 = (b0 - centre_distance) * inv_dn  # leg to the d_c-shifted plane
    a1 = (s.px - c[0]) * det.e1[0] + (s.py - c[1]) * det.e1[1] + (s.pz - c[2]) * det.e1[2]
    a2 = (s.px - c[0]) * det.e2[0] + (s.py - c[1]) * det.e2[1] + (s.pz - c[2]) * det.e2[2]
    g1 = s.dx * det.e1[0] + s.dy * det.e1[1] + s.dz * det.e1[2]
    g2 = s.dx * det.e2[0] + s.dy * det.e2[1] + s.dz * det.e2[2]
    x0 = a1 + t0 * g1
    y0 = a2 + t0 * g2
    cx = inv_dn * g1
    cy = inv_dn * g2
    cd = inv_dn - det.inv_dn_chief
    # small residual path: (opl - ref) is a same-magnitude subtraction
    # (exact), then the Kahan compensation applies at full significance
    d0 = (s.opl - det.opl_ref) - s.opl_c + t0 + centre_distance * det.inv_dn_chief
    vals = {
        "w": w, "x0": w * x0, "y0": w * y0, "d0": w * d0,
        "cx": w * cx, "cy": w * cy, "cd": w * cd,
        "x0x0": w * x0 * x0, "y0y0": w * y0 * y0, "d0d0": w * d0 * d0,
        "x0cx": w * x0 * cx, "y0cy": w * y0 * cy, "d0cd": w * d0 * cd,
        "cxcx": w * cx * cx, "cycy": w * cy * cy, "cdcd": w * cd * cd,
    }
    return jnp.stack([jnp.sum(vals[name]) for name in MOMENT_FIELDS])


def moments_to_distance_sums(moments, distances, centre_distance=0.0):
    """Per-distance weighted sums (w, wx, wy, wxx, wyy, wd, wdd) from the 16
    moment sums, evaluated in float64 for arbitrarily many distances.

    ``moments``: (16,) array-like in MOMENT_FIELDS order (already reduced
    over chunks/devices); ``centre_distance`` must equal the expansion point
    the moments were accumulated about (moment_sums). Returns a dict of (J,)
    float64 arrays."""
    m = {name: np.float64(v) for name, v in zip(MOMENT_FIELDS, np.asarray(moments, np.float64))}
    d = np.asarray(distances, np.float64) - float(centre_distance)
    return {
        "w": np.broadcast_to(m["w"], d.shape).copy(),
        "wx": m["x0"] - d * m["cx"],
        "wy": m["y0"] - d * m["cy"],
        "wxx": m["x0x0"] - 2.0 * d * m["x0cx"] + d * d * m["cxcx"],
        "wyy": m["y0y0"] - 2.0 * d * m["y0cy"] + d * d * m["cycy"],
        "wd": m["d0"] - d * m["cd"],
        "wdd": m["d0d0"] - 2.0 * d * m["d0cd"] + d * d * m["cdcd"],
    }


def sums_to_stats(sums, opl_ref, distances):
    """Per-distance statistics dict from weighted sums — the single
    definition shared by the single-device and sharded paths (means, clamped
    variances, fs conversion)."""
    from .precision import LIGHT_SPEED_MM_S

    w = np.maximum(sums["w"], 1e-30)
    mean_x, mean_y = sums["wx"] / w, sums["wy"] / w
    var_x = np.maximum(sums["wxx"] / w - mean_x**2, 0.0)
    var_y = np.maximum(sums["wyy"] / w - mean_y**2, 0.0)
    mean_d = sums["wd"] / w
    var_d = np.maximum(sums["wdd"] / w - mean_d**2, 0.0)
    to_fs = 1e15 / LIGHT_SPEED_MM_S
    return {
        "spot_sd": np.sqrt(var_x + var_y),
        "duration_sd": np.sqrt(var_d) * to_fs,
        "mean_x": mean_x,
        "mean_y": mean_y,
        "mean_delay": mean_d * to_fs,  # relative to opl_ref, [fs]
        "sum_w": sums["w"],
        "opl_ref": opl_ref,
        "distances": np.asarray(distances, np.float64),
    }


def chief_ray_refs(spec: BakedSource, elements, det_centre, det_normal,
                   opl_ref: float | None = None):
    """(opl_ref, inv_dn_chief) for the moment epilogue: the optical path of a
    surviving probe ray to the detector plane (so accumulated delays stay
    fs-scale) and its inverse plane-approach rate.

    A small probe bundle is traced on the streamed path; if no probe ray
    survives the chain, the probe is retried with more rays before failing
    loudly — silently indexing a dead ray would return garbage statistics
    (argmax of an all-False mask is 0)."""
    from .trace import trace_jit

    pout = None
    for n_probe in (8, 256, 8192):
        probe = source_bundle(spec, n_probe, wavelength=50e-6)
        pout = trace_jit(probe, elements, keep_history=False)
        if bool(np.asarray(pout.alive).any()):
            break
    else:
        raise FusedEngineUnsupported(
            "chief-ray probe: no ray survives the chain (tried up to 8192 "
            "probe rays) — the detector statistics would be meaningless. "
            "Check the chain alignment/supports before running a stats scan."
        )
    k0 = int(np.argmax(np.asarray(pout.alive)))
    p = np.asarray(pout.p, np.float64)[k0]
    d = np.asarray(pout.d, np.float64)[k0]
    c = np.asarray(det_centre, np.float64)
    n = np.asarray(det_normal, np.float64)
    dn = float(d @ n)
    if abs(dn) < 1e-30:
        raise FusedEngineUnsupported(
            "chief-ray probe: surviving ray is parallel to the detector plane")
    t_leg = float((c - p) @ n) / dn
    if opl_ref is None:
        opl_ref = float(
            np.asarray(pout.opl, np.float64)[k0]
            - np.asarray(pout.opl_c, np.float64)[k0] + t_leg
        )
    return float(opl_ref), float(1.0 / dn)
