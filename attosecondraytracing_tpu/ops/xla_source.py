"""XLA fused-source engine: source synthesis, chain trace and detector
epilogue in one XLA program.

The reference traces every ray of a host-built source through the chain in
one Python loop (ART/ModuleMirror.py:912-939). Here, for a factory source:

* the source is synthesized IN-JIT from the ray index (exact-float Vogel
  formulas, ops/source.py) — no host bundle, no per-ray source read;
* the chain runs in chained-frame mode with folded premasks
  (ops/trace.run_chain_chained) — one affine per element, grid defects
  interpolated with XLA gathers from a device-resident map;
* :func:`xla_source_moments` fuses the detector MOMENT epilogue
  (ops/moments.moment_sums) into the same program, so the detector
  optimizer is one pass over all rays at any scan resolution.

Geometry (maps, poses, defect grids) enters as *traced inputs*, not baked
constants — pose changes and parameter scans reuse the compiled executable.
Ranges of 2^23 or more rays run as chunks of the global spiral
(ops/source.source_chunks), so float32 ray indices stay exact.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bundle import RayBundle
from .moments import (
    bake_detector,
    chief_ray_refs,
    moment_sums,
    moments_to_distance_sums,
    sums_to_stats,
)
from .source import BakedSource, source_chunks, synth_source_c
from .trace import (
    MirrorElement,
    TraceState,
    chained_step,
    compose_chain,
    fold_premasks,
    run_chain_chained,
)

#: rays per engine call: float32 ray indices stay exact below 2^24
CHUNK = 1 << 23


def _source_inputs(spec: BakedSource, elements):
    """(folded elements, maps, final, premasks) with the source frame folded
    into map 0 — float64 host math, returned as plain arrays (jit inputs)."""
    maps, final = compose_chain(elements)
    M0, _ = maps[0]
    R0 = np.asarray(M0, dtype=np.float64)
    Rs = np.asarray(spec.rot, dtype=np.float64)
    el0 = elements[0]
    pos0 = np.asarray(el0.position, dtype=np.float64)
    cen0 = (np.asarray(el0.centre, dtype=np.float64)
            if isinstance(el0, MirrorElement) else np.zeros(3))
    M = R0 @ Rs
    b = R0 @ (np.asarray(spec.origin, dtype=np.float64) - pos0) + cen0
    maps = [(M, b)] + list(maps[1:])
    elements, maps, premasks = fold_premasks(elements, maps)
    f32 = lambda a: np.asarray(a, np.float32)
    maps = tuple((f32(M_), f32(b_)) for M_, b_ in maps)
    final = tuple(f32(v) for v in final)
    premasks = tuple(
        tuple((sup_, f32(Mm), f32(bb)) for (sup_, Mm, bb) in pre)
        for pre in premasks
    )
    return tuple(elements), maps, final, premasks


def device_inputs(spec: BakedSource, elements):
    """:func:`_source_inputs` with ndarray leaves put on the device ONCE —
    the geometry and the (possibly ~10-100 MB) defect grids are jit
    *arguments* of the engine, and re-passing host NumPy would re-upload them
    on every dispatch. Python-scalar leaves stay as-is to keep their weak
    dtypes."""
    return jax.tree.map(
        lambda x: jax.device_put(x) if isinstance(x, np.ndarray) else x,
        _source_inputs(spec, elements))


def _synth_state(kind, radius, phase, k_frac, pos_radius, n_rays, n_total,
                 n_each, n_sources):
    """Fresh canonical-frame TraceState of one chunk + its radial-law
    argument ``rr`` (weight = edge**rr)."""
    kf = jnp.arange(n_rays, dtype=jnp.float32)
    (px, py, pz), (dx, dy, dz), rr = synth_source_c(
        kind, kf, n_total, radius, phase, k_frac, pos_radius=pos_radius,
        n_each=n_each, n_sources=n_sources)
    zeros = jnp.zeros((n_rays,), jnp.float32)
    s = TraceState(
        px=px + zeros, py=py + zeros, pz=pz + zeros,
        dx=dx + zeros, dy=dy + zeros, dz=dz + zeros,
        opl=zeros, opl_c=zeros,
        alive=jnp.ones((n_rays,), bool),
        incidence=zeros,
    )
    return s, rr


_STATICS = ("kind", "n_rays", "n_total", "n_each", "n_sources",
            "ignore_defects")


@partial(jax.jit, static_argnames=_STATICS)
def _trace_run(elements, maps, final, premasks, kind, radius, phase, k_frac,
               pos_radius, n_rays, n_total, n_each, n_sources, ignore_defects):
    """Synthesize + trace one chunk; returns the lab-frame TraceState.
    Dead rays keep unfrozen (bounded) values: every consumer masks by
    alive."""
    s, _ = _synth_state(kind, radius, phase, k_frac, pos_radius, n_rays,
                        n_total, n_each, n_sources)
    return run_chain_chained(s, elements, maps, final,
                             ignore_defects=ignore_defects,
                             premasks=premasks, freeze_dead=False)


@partial(jax.jit, static_argnames=_STATICS)
def _moments_run(elements, maps, premasks, det, kind, radius, phase, k_frac,
                 wcoef, centre_distance, pos_radius, n_rays, n_total, n_each,
                 n_sources, ignore_defects):
    """Synthesize + trace + reduce one chunk to the 16 detector moments.
    The state stays in the LAST element's patch-relative frame, where the
    baked detector plane lives (ops/moments.bake_detector)."""
    s, rr = _synth_state(kind, radius, phase, k_frac, pos_radius, n_rays,
                         n_total, n_each, n_sources)
    for el, (M, b), pre in zip(elements, maps, premasks):
        # incidence is never observed by the moments, and dead rays only
        # reach alive-masked sums: skip both
        s = chained_step(el, M, b, s, want_incidence=False,
                         ignore_defects=ignore_defects, premasks=pre,
                         freeze_dead=False)
    weights = jnp.exp(wcoef * rr)  # edge**rr, the normalized radial law
    return moment_sums(s, det, weights, centre_distance=centre_distance)


def _chunks(spec: BakedSource, n_rays, n_total, phase, k_frac):
    if n_rays <= CHUNK:
        return [(n_rays, phase, k_frac)]
    return source_chunks(spec.kind, n_rays, n_total, spec.n_each,
                         spec.n_sources, CHUNK, float(phase), float(k_frac))


def _state_to_bundle(s: TraceState, wavelength) -> RayBundle:
    n = s.px.shape[0]
    return RayBundle(
        p=jnp.stack([s.px, s.py, s.pz], axis=-1),
        d=jnp.stack([s.dx, s.dy, s.dz], axis=-1),
        opl=s.opl, opl_c=s.opl_c, alive=s.alive,
        intensity=jnp.ones((n,), jnp.float32),
        incidence=s.incidence,
        wavelength=jnp.asarray(wavelength, jnp.float32),
    )


def xla_trace_source(
    spec: BakedSource,
    elements,
    n_rays: int,
    wavelength=50e-6,
    phase=0.0,
    k_frac=0.0,
    n_total: int | None = None,
    ignore_defects: bool = True,
    inputs=None,
) -> RayBundle:
    """Trace ``n_rays`` of the in-jit-synthesized source through the chain
    (chained frames + folded premasks), defects of every kind supported.
    Returns the final lab-frame bundle (no history) with uniform
    intensities: apply the source's Gaussian weights downstream (the trace
    never reads them). Like ``trace(keep_history=False)``, ``incidence`` is
    only meaningful for surviving rays. ``inputs`` (from
    :func:`device_inputs`) reuses device-resident geometry across calls."""
    els, maps, final, premasks = (inputs if inputs is not None
                                  else device_inputs(spec, elements))
    n_total = n_total or n_rays
    states = [
        _trace_run(els, maps, final, premasks, spec.kind,
                   jnp.float32(spec.radius), jnp.float32(ph), jnp.float32(kf),
                   jnp.float32(spec.pos_radius), n_local, n_total,
                   spec.n_each, spec.n_sources, ignore_defects)
        for n_local, ph, kf in _chunks(spec, n_rays, n_total, phase, k_frac)
    ]
    s = states[0] if len(states) == 1 else jax.tree.map(
        lambda *xs: jnp.concatenate(xs), *states)
    return _state_to_bundle(s, wavelength)


def xla_source_moments(
    spec: BakedSource,
    elements,
    n_rays: int,
    det_centre,
    det_normal,
    det_rot,
    opl_ref: float | None = None,
    gaussian_edge: float | None = None,
    centre_distance: float = 0.0,
    ignore_defects: bool = True,
    inputs=None,
    phase=0.0,
    k_frac=0.0,
    n_total: int | None = None,
):
    """The 16 distance-independent weighted moments (:data:`MOMENT_FIELDS`,
    float64) of the traced bundle on the detector plane — the complete
    description of every per-distance statistic as an exact quadratic in
    the scan distance. One fused pass per chunk. Returns ``{"moments",
    "opl_ref", "inv_dn_chief", "centre_distance"}``.

    ``centre_distance`` [mm, shiftByDistance convention, runtime — no
    recompile] sets the expansion point the spot moments are squared about
    (see ops/moments.moment_sums); it is quantized to float32 so host
    reconstruction matches the device exactly, and the quantized value is
    returned. ``phase``/``k_frac``/``n_total`` select a sub-range of a
    larger global spiral (ops/source._vogel_xy_c)."""
    centre_distance = float(np.float32(centre_distance))
    opl_ref, inv_dn_chief = chief_ray_refs(spec, elements, det_centre,
                                           det_normal, opl_ref)
    det = bake_detector(elements, det_centre, det_normal, det_rot,
                        opl_ref=opl_ref, inv_dn_chief=inv_dn_chief)
    els, maps, _final, premasks = (inputs if inputs is not None
                                   else device_inputs(spec, elements))
    # weight = edge**rr, rr the normalized radial law (synth_source_c)
    wcoef = 0.0 if gaussian_edge is None else float(np.log(gaussian_edge))
    n_total = n_total or n_rays
    # dispatch every chunk before fetching: one host sync per call
    rows = [
        _moments_run(els, maps, premasks, det, spec.kind,
                     jnp.float32(spec.radius), jnp.float32(ph),
                     jnp.float32(kf), jnp.float32(wcoef),
                     jnp.float32(centre_distance),
                     jnp.float32(spec.pos_radius), n_local, n_total,
                     spec.n_each, spec.n_sources, ignore_defects)
        for n_local, ph, kf in _chunks(spec, n_rays, n_total, phase, k_frac)
    ]
    moments = np.asarray(jnp.stack(rows), np.float64).sum(axis=0)
    return {
        "moments": moments,
        "opl_ref": opl_ref,
        "inv_dn_chief": inv_dn_chief,
        "centre_distance": centre_distance,
    }


def xla_source_detector_stats(spec: BakedSource, elements, n_rays: int,
                              det_centre, det_normal, det_rot,
                              distances=(0.0,), **kwargs):
    """Per-distance detector statistics (``spot_sd`` [mm], ``duration_sd``
    [fs], ``mean_x``/``mean_y`` [mm], ``mean_delay`` [fs], ``sum_w``) at any
    number of ``distances`` (shifts along -normal, Detector.shiftByDistance
    semantics) from ONE fused moment pass; keyword arguments as
    :func:`xla_source_moments`.

    Precision floor: spot SDs are accurate to ~0.2%; duration SDs carry the
    float32 trace's per-ray OPL noise (~0.6 fs, quadrature-additive), so
    sub-femtosecond durations read as ~0.6-0.9 fs. For sub-fs focus
    metrology run the two-pass path (trace + detector_delays) in float64."""
    mom = xla_source_moments(spec, elements, n_rays, det_centre, det_normal,
                             det_rot, **kwargs)
    sums = moments_to_distance_sums(mom["moments"], distances,
                                    mom["centre_distance"])
    return sums_to_stats(sums, mom["opl_ref"], distances)


def make_xla_moments_fn(spec: BakedSource, elements, n_rays: int,
                        ignore_defects: bool = True):
    """``moments_fn`` for analysis.optimizer.FindOptimalDistanceFused: the
    geometry and defect grids are uploaded once (:func:`device_inputs`) and
    reused by every optimizer call; poses are traced inputs, so the chains
    of a structurally-uniform scan share one executable."""
    inputs = device_inputs(spec, elements)

    def moments_fn(det_centre, det_normal, det_rot, gaussian_edge=None,
                   centre_distance=0.0):
        return xla_source_moments(
            spec, elements, n_rays, det_centre, det_normal, det_rot,
            gaussian_edge=gaussian_edge, centre_distance=centre_distance,
            ignore_defects=ignore_defects, inputs=inputs,
        )

    return moments_fn
