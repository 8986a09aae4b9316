"""Device-mesh sharding for the ray tracer.

The domain's natural parallel axes (SURVEY.md §2.2, §5.7):

* ``rays`` — embarrassingly parallel data axis (the reference's per-ray Python
  loop, ART/ModuleMirror.py:912-939). Rays never interact; the only cross-ray
  operations are detector reductions (mean/SD/transmission), which XLA turns
  into ``psum``-style collectives over the mesh automatically when inputs are
  sharded and outputs are replicated.
* ``scan`` — the parameter-scan axis (the reference's serial
  ``OpticalChainList`` loop, ARTmain.py:326-332), mapped to ``jax.vmap`` over
  stacked element parameters and optionally sharded across devices.

Element parameters are tiny and replicated. Multi-host runs initialize via
:func:`distributed_init`; the tests use
``--xla_force_host_platform_device_count`` to fake an 8-device CPU mesh (same
code path as the cards of one host).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.bundle import RayBundle, pad_bundle
from ..ops.source import PHI_FRAC
from ..ops.trace import trace


def distributed_init(**kwargs):
    """Initialize JAX multi-host distributed runtime.

    Falls back to single-host mode when initialization is impossible
    (no coordinator configured / already initialized), but *says so*: a
    silently-degraded multi-host job would otherwise trace 1/N of the rays
    and report wrong statistics. Returns True if distributed mode is active."""
    try:
        jax.distributed.initialize(**kwargs)
        return True
    except (ValueError, RuntimeError) as exc:
        import sys

        print(
            f"[attosecondraytracing_tpu] jax.distributed.initialize failed "
            f"({type(exc).__name__}: {exc}); continuing single-host. This is "
            f"fine for single-process runs, but a multi-host launch reaching "
            f"this path would silently compute on one host only.",
            file=sys.stderr,
            flush=True,
        )
        return False


def make_mesh(rays: int | None = None, scan: int = 1, devices=None) -> Mesh:
    """Build a ('scan', 'rays') mesh. ``rays=None`` uses all remaining
    devices for the ray axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if rays is None:
        rays = n // scan
    if scan * rays != n:
        raise ValueError(f"scan*rays = {scan}*{rays} != {n} devices")
    return Mesh(devices.reshape(scan, rays), ("scan", "rays"))


def bundle_sharding(mesh: Mesh, axis: str = "rays", batched: bool = False):
    """NamedSharding for a RayBundle: leading ray axis sharded, wavelength
    replicated. ``batched=True`` expects a leading scan axis."""
    if batched:
        arr = NamedSharding(mesh, P("scan", axis))
        scalar = NamedSharding(mesh, P("scan"))
    else:
        arr = NamedSharding(mesh, P(axis))
        scalar = NamedSharding(mesh, P())
    return RayBundle(
        p=arr, d=arr, opl=arr, opl_c=arr, alive=arr, intensity=arr, incidence=arr, wavelength=scalar
    )


def shard_bundle(bundle: RayBundle, mesh: Mesh, axis: str = "rays") -> RayBundle:
    """Place a bundle on the mesh with the ray axis sharded (padding dead rays
    so N divides the axis size)."""
    n_dev = mesh.shape[axis]
    n = bundle.n_rays
    n_pad = ((n + n_dev - 1) // n_dev) * n_dev
    bundle = pad_bundle(bundle, n_pad)
    return jax.device_put(bundle, bundle_sharding(mesh, axis))


@partial(jax.jit, static_argnames=("ignore_defects", "keep_history"))
def _trace_jit(source, elements, ignore_defects, keep_history):
    return trace(source, elements, ignore_defects=ignore_defects, keep_history=keep_history)


def trace_sharded(
    source: RayBundle,
    elements,
    mesh: Mesh,
    ignore_defects: bool = True,
    keep_history: bool = False,
):
    """Trace with the ray axis sharded over ``mesh``. Element parameters are
    replicated; the per-ray math is local to each device (no communication
    until a reduction is taken on the result)."""
    src = shard_bundle(source, mesh)
    elements = jax.device_put(elements, NamedSharding(mesh, P()))
    return _trace_jit(src, elements, ignore_defects, keep_history)


# ---------------------------------------------------------------------------
# batched parameter scans (vmap over stacked chains)
# ---------------------------------------------------------------------------


def stack_chains(chains):
    """Stack the device elements of structurally-identical chains along a
    leading scan axis; returns (stacked_elements, stacked_sources).

    This replaces looping over ``OpticalChainList`` (ARTmain.py:326-332):
    one vmapped trace evaluates the whole scan at once.
    """
    element_lists = [c.device_elements() for c in chains]
    treedefs = {jax.tree_util.tree_structure(e) for e in element_lists}
    if len(treedefs) != 1:
        raise ValueError("chains have different element structures; cannot batch the scan")
    stacked_elements = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *element_lists)
    sources = [c.source_rays for c in chains]
    stacked_sources = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *sources)
    return stacked_elements, stacked_sources


@partial(jax.jit, static_argnames=("ignore_defects",))
def trace_scan(stacked_sources, stacked_elements, ignore_defects: bool = True):
    """vmapped trace over the scan axis; returns the stacked final bundles."""
    return jax.vmap(
        lambda src, els: trace(src, els, ignore_defects=ignore_defects, keep_history=False)
    )(stacked_sources, stacked_elements)


def trace_scan_sharded(chains, mesh: Mesh, ignore_defects: bool = True):
    """Batch a chain scan over the ('scan', 'rays') mesh: scan axis and ray
    axis both sharded."""
    stacked_elements, stacked_sources = stack_chains(chains)
    n_scan = mesh.shape["scan"]
    n_chains = len(chains)
    if n_chains % n_scan:
        raise ValueError(f"number of chains {n_chains} must divide the scan axis {n_scan}")
    src = jax.device_put(stacked_sources, bundle_sharding(mesh, batched=True))
    els = jax.device_put(stacked_elements, NamedSharding(mesh, P()))
    return trace_scan(src, els, ignore_defects=ignore_defects)


# ---------------------------------------------------------------------------
# sharded in-jit sources: giga-ray passes with O(bytes) communication
# ---------------------------------------------------------------------------


def shard_source_offsets(n_total: int, n_devices: int):
    """Per-device (n_local, phase, k_frac) partitioning of a Vogel-spiral
    source: device i synthesizes global rays [i*n_local, (i+1)*n_local).

    ``phase`` = frac(offset * phi) computed here in float64, so the global
    golden angle is exact on every shard; ``k_frac`` = offset / n_total feeds
    the global radius law without ever forming a > 2^24 float ray index —
    together they let a mesh trace bundles far beyond the 16M-ray float32
    index limit of a single engine call."""
    if n_total % n_devices:
        raise ValueError("n_total must divide evenly over the devices")
    n_local = n_total // n_devices
    offs = np.arange(n_devices, dtype=np.float64) * n_local
    phases = np.mod(offs * PHI_FRAC, 1.0).astype(np.float32)
    k_fracs = (offs / n_total).astype(np.float32)
    return n_local, jnp.asarray(phases), jnp.asarray(k_fracs)


def _check_spiral_kind(spec, what: str):
    if spec.kind in ("extended", "square"):
        raise NotImplementedError(
            f"sharded {what} for extended/square sources need "
            "sub-source/row-aligned shard offsets; use the single-device "
            "chunked path")


def scan_moments_sharded(
    spec,
    elements,
    n_total: int,
    mesh: Mesh,
    det_centre,
    det_normal,
    det_rot,
    opl_ref: float | None = None,
    gaussian_edge: float | None = None,
    centre_distance: float = 0.0,
    ignore_defects: bool = True,
):
    """The 16 detector moments of ops.xla_source.xla_source_moments with the
    ray axis sharded over a ``('rays',)`` mesh: each device synthesizes its
    slice of the global Vogel spiral (per-shard (phase, k_frac) offsets),
    traces it through the fused-source engine and reduces it to one 16-float
    moment row; only those rows cross the mesh. Poses and defect grids are
    replicated jit arguments, so every chain of a structurally-uniform scan
    reuses one executable. Same return dict as ``xla_source_moments``."""
    from ..ops import xla_source as xs
    from ..ops.moments import bake_detector, chief_ray_refs

    _check_spiral_kind(spec, "moments")
    n_local, phases, k_fracs = shard_source_offsets(n_total, mesh.devices.size)
    if n_local >= 1 << 24:
        raise ValueError("per-device ray count must stay < 2^24 (float "
                         "index exactness); use more devices")
    centre_distance = float(np.float32(centre_distance))
    opl_ref, inv_dn_chief = chief_ray_refs(spec, elements, det_centre,
                                           det_normal, opl_ref)
    det = bake_detector(elements, det_centre, det_normal, det_rot,
                        opl_ref=opl_ref, inv_dn_chief=inv_dn_chief)
    els, maps, _final, premasks = xs._source_inputs(spec, elements)
    wcoef = 0.0 if gaussian_edge is None else float(np.log(gaussian_edge))

    def local(phase, k_frac, geometry):
        els_l, maps_l, premasks_l = geometry
        row = xs._moments_run(
            els_l, maps_l, premasks_l, det, spec.kind,
            jnp.float32(spec.radius), phase[0], k_frac[0],
            jnp.float32(wcoef), jnp.float32(centre_distance),
            jnp.float32(spec.pos_radius), n_local, n_total, spec.n_each,
            spec.n_sources, ignore_defects)
        return row[None]

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P()),
        out_specs=P("rays", None),
    )
    rows = sharded(phases, k_fracs, (els, maps, premasks))
    return {
        "moments": np.asarray(rows, np.float64).sum(axis=0),
        "opl_ref": opl_ref,
        "inv_dn_chief": inv_dn_chief,
        "centre_distance": centre_distance,
    }


def source_stats_sharded(
    spec,
    elements,
    n_total: int,
    mesh: Mesh,
    det_centre,
    det_normal,
    det_rot,
    distances=(0.0,),
    gaussian_edge: float | None = None,
    centre_distance: float = 0.0,
    ignore_defects: bool = True,
):
    """Per-distance detector statistics (ops.xla_source.
    xla_source_detector_stats semantics) from one sharded moment pass
    (:func:`scan_moments_sharded`) — the cross-device traffic for a
    billion-ray scan is a few hundred bytes."""
    from ..ops.moments import moments_to_distance_sums, sums_to_stats

    mom = scan_moments_sharded(
        spec, elements, n_total, mesh, det_centre, det_normal, det_rot,
        gaussian_edge=gaussian_edge, centre_distance=centre_distance,
        ignore_defects=ignore_defects)
    sums = moments_to_distance_sums(mom["moments"], distances,
                                    mom["centre_distance"])
    return sums_to_stats(sums, mom["opl_ref"], distances)


def source_images_sharded(
    spec,
    elements,
    n_total: int,
    mesh: Mesh,
    centre,
    normal,
    rot,
    extent,
    bins: tuple[int, int] = (256, 256),
    chunk: int = 1 << 23,
    gaussian_edge: float | None = None,
    opl_ref: float = 0.0,
    wavelength: float = 50e-6,
    ignore_defects: bool = True,
):
    """Giga-ray detector images over every device of a ``('rays',)`` mesh:
    each device synthesizes + traces its slice of the global Vogel spiral
    through the fused-source engine and bins it locally
    (analysis.gigascan) — only the (bins) partial images cross the mesh, a
    few hundred kB for a billion-ray map.

    ``spec`` is an ops.source.BakedSource; ``extent = (lo, hi)`` must be
    fixed (use a probe image for auto-fitting — per-device auto extents
    would disagree). Returns ``(w_img, wd_img)`` as float64 host arrays
    (weight and weight*delay sums; delays relative to ``opl_ref``)."""
    from ..analysis.gigascan import _images_fused_xla
    from ..ops import xla_source as xs

    _check_spiral_kind(spec, "images")
    n_dev = mesh.devices.size
    if n_total % n_dev:
        raise ValueError("n_total must divide evenly over the devices")
    n_local = n_total // n_dev
    n_chunks = -(-n_local // chunk)
    if n_local % n_chunks:
        raise ValueError(
            f"per-device ray count {n_local} must split into equal chunks "
            f"(got {n_chunks} chunks); pick n_total accordingly")
    chunk_local = n_local // n_chunks
    if chunk_local >= 1 << 24:
        raise ValueError("per-chunk ray count must stay < 2^24")

    # (device, chunk) global spiral offsets, composed in float64 on the host
    offs = (np.arange(n_dev, dtype=np.float64)[:, None] * n_local
            + np.arange(n_chunks, dtype=np.float64)[None, :] * chunk_local)
    phases = np.mod(offs * PHI_FRAC, 1.0).astype(np.float32)
    k_fracs = (offs / n_total).astype(np.float32)

    geometry = xs._source_inputs(spec, elements)
    logedge = None if gaussian_edge is None else float(np.log(gaussian_edge))
    centre_j = jnp.asarray(centre, jnp.float32)
    normal_j = jnp.asarray(normal, jnp.float32)
    rot_j = jnp.asarray(rot, jnp.float32)
    lo_j = jnp.asarray(extent[0], jnp.float32)
    hi_j = jnp.asarray(extent[1], jnp.float32)

    def local(ph_rows, kf_rows, geometry_l):
        wg, wdg = _images_fused_xla(
            ph_rows[0], kf_rows[0], *geometry_l, centre_j, normal_j, rot_j,
            lo_j, hi_j, jnp.float32(opl_ref), baked=spec, bins=bins,
            chunk=chunk_local, n_total=n_total, group=8,
            n_groups=-(-n_chunks // 8), logedge=logedge,
            ignore_defects=ignore_defects, wavelength=float(wavelength))
        # per-device partial reduction: ship one image pair
        return wg.sum(axis=0)[None], wdg.sum(axis=0)[None]

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("rays", None), P("rays", None), P()),
        out_specs=(P("rays", None, None), P("rays", None, None)),
        # the binning scan's accumulator starts replicated (zeros) and turns
        # device-varying after the first block; its type check would refuse
        check_vma=False,
    )
    wgs, wdgs = sharded(jnp.asarray(phases), jnp.asarray(k_fracs), geometry)
    return (np.asarray(wgs, np.float64).sum(axis=0),
            np.asarray(wdgs, np.float64).sum(axis=0))
