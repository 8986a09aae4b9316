"""Smoke run of the tracer's main path on NVIDIA GPUs, at production size.

    python chip_smoke.py                # one card, phases 1-5 below
    python chip_smoke.py --four-cards   # the sharded engines on 4 cards only

One card: (1) the CONFIG_2toroidals_f-x-f driver scan at 1e7 rays per chain,
(2) CONFIG_singleparabola and (3) CONFIG_deformed through ``main.main`` at
1e7 rays, (4) a 1e9-ray 512x512 image of the giga-ray example chain, and
(5) five Adam steps of ``gradient_align`` at 1e6 rays. Each phase goes
through the entry points a user calls, checks the physics it should
produce, and compares the engine with a plain reference the engine does not
share (the streamed trace, a scatter histogram, float64 finite
differences), printing each difference beside its tolerance and the reason
for that tolerance. Engine times at 1e7 rays are printed as shares of their
floors (a copy-bandwidth probe and the float32 peak outside the tensor
cores), with the card's name and power limit.

The process exits non-zero, and prints no result, when JAX finds no GPU or
any phase fails. Its last line is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
EXAMPLES = ROOT / "examples"

#: float32 peak outside the tensor cores [FLOP/s] by JAX device_kind
#: (NVIDIA H100 data sheet, SXM part, 700 W)
PEAK_F32_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}

#: bytes written per ray by the bundle trace: 8 float32 + bool + float32
BUNDLE_BYTES_PER_RAY = 37

#: speed of light [mm/fs]
LIGHT_MM_PER_FS = 2.99792458e-4


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them ("not measured"
    without nvidia-smi). A plain child process: it never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.stdout.strip().splitlines()[0]


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, from its own
    monitoring events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_kwargs):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


class Phase:
    """Records and prints one phase's checks; ``ok`` is False after any
    failed check."""

    def __init__(self, name: str):
        self.name = name
        self.ok = True
        self.info = {}

    def _report(self, label, ok, text):
        self.ok &= bool(ok)
        print(f"  [{'ok' if ok else 'FAIL'}] {label}: {text}", flush=True)

    def within(self, label, value, lo, hi, why):
        ok = bool(np.isfinite(value) and lo <= value <= hi)
        self._report(label, ok, f"{value:.6g} in [{lo:.6g}, {hi:.6g}] ({why})")

    def below(self, label, value, limit, why):
        ok = bool(np.isfinite(value) and value <= limit)
        self._report(label, ok, f"{value:.6g} <= {limit:.6g} ({why})")

    def equal(self, label, value, expected):
        self._report(label, value == expected, f"{value!r} == {expected!r}")


def load_module(path: Path):
    """Execute a CONFIG or example file as a module."""
    spec = importlib.util.spec_from_file_location(path.stem.replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plots_off(options: dict) -> dict:
    return {k: (False if k.startswith("plot_") else v) for k, v in options.items()}


def best_time(fn, reps: int = 3) -> float:
    """Minimum wall time of ``fn()`` (which must block on its result) after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def copy_bandwidth() -> float:
    """Achievable device copy bandwidth [bytes/s]: read + write of a 1 GiB
    float32 array."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1 << 28,), jnp.float32)
    step = jax.jit(lambda v: v + 1.0)
    t = best_time(lambda: step(x).block_until_ready(), reps=5)
    return 2 * x.nbytes / t


def _relative(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _duration_gap(k, r):
    """Distance between two duration SDs [fs] net of float32 OPL noise,
    which adds in quadrature: min(|k - r|, sqrt(|k^2 - r^2|))."""
    return min(abs(k - r), abs(k * k - r * r) ** 0.5)


def _compare_bundles(ph, det, fused, streamed, pos_tol, delay_tol):
    """Per-ray comparison over rays alive in both bundles (same spiral).
    ``delay_tol=None`` derives the delay bound from the measured position
    agreement."""
    a_f, a_s = np.asarray(fused.alive), np.asarray(streamed.alive)
    ph.below("alive mismatch fraction", float((a_f != a_s).mean()), 1e-4,
             "float32 rounding flips only rays on a support edge")
    live = a_f & a_s
    dps = np.abs(np.asarray(fused.p)[live] - np.asarray(streamed.p)[live]).max(axis=1)
    dp = float(dps.max())
    print(f"  live rays {int(live.sum())}; position differs for "
          f"{float((dps > 0).mean()):.4g} of them, median {float(np.median(dps)):.3g} mm")
    ph.below("max |d position| [mm], fused vs streamed", dp, pos_tol,
             "float32, chained vs lab frames: reassociation of the hit "
             "distances, amplified where rays meet the surface steeply")
    dd = float(np.abs(np.asarray(det.get_Delays(fused))[live]
                      - np.asarray(det.get_Delays(streamed))[live]).max())
    if delay_tol is None:
        delay_tol = 1.0 + 2 * dp / LIGHT_MM_PER_FS
        why = ("float32 floor ~0.2 fs per leg on each side, plus the measured "
               "hit-point difference, which lengthens the legs on either "
               "side of it by at most that distance")
    else:
        why = ("float32 delay floor ~0.2 fs per chain leg (rounding of each "
               "leg's hit distance), on each side")
    ph.below("max |d delay| [fs], fused vs streamed", dd, delay_tol, why)


# ---------------------------------------------------------------------------
# phases (one card)
# ---------------------------------------------------------------------------


def phase_driver_scan(ph: Phase, n_rays: int = 10_000_000,
                      config: Path = EXAMPLES / "CONFIG_2toroidals_f-x-f.py"):
    """Driver scan: 11 chains through run_config_file on the fused scan
    engine; the middle chain checked against the streamed trace."""
    from attosecondraytracing_tpu.main import run_config_file
    from attosecondraytracing_tpu.ops import moments as pm
    from attosecondraytracing_tpu.ops import xla_source as xs
    from attosecondraytracing_tpu.ops.source import source_bundle
    from attosecondraytracing_tpu.ops.trace import trace_jit

    kept = run_config_file(str(config), n_rays=n_rays)
    chains = kept["OpticalChain"]
    ph.equal("chains", len(chains), 11)
    ph.equal("engines", sorted({c.last_trace_engine for c in chains}), ["xla-scan"])
    ph.info["engine"] = chains[0].last_trace_engine
    mid = len(chains) // 2
    det = kept["Detector"][mid]
    ph.within("middle chain optimal distance [mm]", det.get_distance(),
              450.0, 550.0, "f-x-f refocus near 500 mm")
    ph.within("middle chain spot SD [um]", kept["SpotSizeSD"][mid] * 1e3,
              1.0, 30.0, "about 10 um")
    ph.within("middle chain duration SD [fs]", kept["DurationSD"][mid],
              0.05, 3.0, "about 1 fs")

    chain = chains[mid]
    spec = chain.source_spec.baked()
    elements = chain.device_elements()
    rot = det._plane_rotation()
    fused = xs.xla_source_detector_stats(spec, elements, n_rays, det.centre,
                                         det.normal, rot)
    out = trace_jit(source_bundle(spec, n_rays,
                                  wavelength=chain.source_spec.wavelength),
                    elements, keep_history=False)
    spot, duration = (float(v) for v in det.get_SpotAndDuration(out))
    print(f"  fused (float32 moments, float64 host reduction): spot "
          f"{fused['spot_sd'][0] * 1e3:.6g} um, duration "
          f"{fused['duration_sd'][0]:.6g} fs; streamed (float32 trace + "
          f"float32 detector sums): spot {spot * 1e3:.6g} um, duration "
          f"{duration:.6g} fs")
    ph.below("spot SD relative difference", _relative(fused["spot_sd"][0], spot),
             5e-3, "float32 chained vs lab-frame impact points at grazing "
             "incidence (~1e-3 relative) plus float32 sums over 1e7 rays")
    ph.below("duration SD difference [fs]",
             _duration_gap(float(fused["duration_sd"][0]), duration), 0.8,
             "~0.6 fs float32 per-ray OPL noise adds in quadrature")

    # the moment pass alone, against its FLOP floor
    inputs = xs.device_inputs(spec, elements)
    opl_ref, inv_dn = pm.chief_ray_refs(spec, elements, det.centre, det.normal)
    bdet = pm.bake_detector(elements, det.centre, det.normal, rot,
                            opl_ref=opl_ref, inv_dn_chief=inv_dn)
    els, maps, _final, premasks = inputs
    import jax.numpy as jnp

    args = (els, maps, premasks, bdet, spec.kind, jnp.float32(spec.radius),
            jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
            jnp.float32(0.0), jnp.float32(spec.pos_radius), n_rays, n_rays,
            spec.n_each, spec.n_sources, True)
    t = best_time(lambda: xs._moments_run(*args).block_until_ready())
    cost = xs._moments_run.lower(*args).compile().cost_analysis() or {}
    flops = float(cost.get("flops", 0.0))
    ph.info["moments_ms"] = t * 1e3
    ph.info["moments_flops"] = flops
    return ph


def _main_one_chain(ph, config: Path, n_rays: int):
    """One CONFIG through main.main at ``n_rays`` with plots off; returns
    (chain, detector, kept)."""
    from attosecondraytracing_tpu.main import main

    cfg = load_module(config)
    chain = cfg.OpticalChainList
    chain.resize_source(n_rays)
    kept = main(chain, dict(cfg.SourceProperties, NumberRays=n_rays),
                cfg.DetectorOptions, plots_off(cfg.AnalysisOptions))
    ph.equal("engine", chain.last_trace_engine, "xla-source")
    ph.info["engine"] = chain.last_trace_engine
    return chain, kept["Detector"][0], kept


def _fused_and_streamed(chain, n_rays):
    from attosecondraytracing_tpu.ops.source import source_bundle
    from attosecondraytracing_tpu.ops.trace import trace_jit
    from attosecondraytracing_tpu.ops.xla_source import xla_trace_source

    spec = chain.source_spec.baked()
    elements = chain.device_elements()
    wl = chain.source_spec.wavelength
    fused = xla_trace_source(spec, elements, n_rays, wavelength=wl)
    streamed = trace_jit(source_bundle(spec, n_rays, wavelength=wl), elements,
                         keep_history=False)
    return fused, streamed


def phase_single_chain(ph: Phase, n_rays: int = 10_000_000,
                       config: Path = EXAMPLES / "CONFIG_singleparabola.py"):
    """Single chain, bundle output, plus the float64 refinement on the card."""
    import jax

    from attosecondraytracing_tpu.analysis import optimizer
    from attosecondraytracing_tpu.ops import xla_source as xs

    chain, det, kept = _main_one_chain(ph, config, n_rays)
    ph.within("energy transmission [%]", kept["ETransmission"][0], 91.0, 97.0,
              "about 94%")
    ph.within("spatial SD [um]", kept["SpotSizeSD"][0] * 1e3, 65.0, 90.0,
              "about 77 um")
    ph.within("temporal SD [fs]", kept["DurationSD"][0], 12.0, 16.0,
              "about 14 fs")
    fused, streamed = _fused_and_streamed(chain, n_rays)
    _compare_bundles(ph, det, fused, streamed, pos_tol=5e-2, delay_tol=1.0)

    spec = chain.source_spec.baked()
    elements = chain.device_elements()
    refined = optimizer._x64_refine_distance(
        spec, elements, n_rays, det, "intensity", amplitude=1.0,
        gaussian_edge=chain.source_spec.gaussian_edge, verbose=False)
    ph.equal("float64 refinement returns a result", refined is not None, True)
    ph.within("float64-refined distance [mm]", refined[0].get_distance(),
              det.get_distance() - 1.0, det.get_distance() + 1.0,
              "stays inside its 1 mm window")

    # the bundle trace alone, against its write floor
    inputs = xs.device_inputs(spec, elements)
    import jax.numpy as jnp

    args = (*inputs, spec.kind, jnp.float32(spec.radius), jnp.float32(0.0),
            jnp.float32(0.0), jnp.float32(spec.pos_radius), n_rays, n_rays,
            spec.n_each, spec.n_sources, True)
    t = best_time(lambda: jax.block_until_ready(xs._trace_run(*args)))
    ph.info["bundle_ms"] = t * 1e3
    return ph


def phase_deformed(ph: Phase, n_rays: int = 10_000_000,
                   config: Path = EXAMPLES / "CONFIG_deformed.py"):
    """Grid-defect chain at the config's own map resolution: heights are
    gathered from a device-resident map by XLA."""
    chain, det, kept = _main_one_chain(ph, config, n_rays)
    grid = chain.optical_elements[0].type.DeformationList[0]._height.shape
    print(f"  defect map: {grid[0]}x{grid[1]} grid points")
    ph.within("energy transmission [%]", kept["ETransmission"][0], 35.0, 41.0,
              "about 38%: 100 mm beam on a 40 mm support")
    ph.within("spatial SD [mm]", kept["SpotSizeSD"][0], 0.1, 20.0,
              "mm-scale spot from the 0.1 mm RMS defect")
    fused, streamed = _fused_and_streamed(chain, n_rays)
    _compare_bundles(ph, det, fused, streamed, pos_tol=5e-2, delay_tol=None)
    return ph


def phase_giga_image(ph: Phase, n_total: int = 1_000_000_000,
                     n_check: int = 10_000_000, bins=(512, 512),
                     example: Path = EXAMPLES / "gigaray_delay_map.py"):
    """Giga-ray image on the fused engine; at ``n_check`` rays compared with
    plain scatter histograms."""
    import jax
    import jax.numpy as jnp

    from attosecondraytracing_tpu.analysis import stats
    from attosecondraytracing_tpu.analysis.gigascan import fused_source_images
    from attosecondraytracing_tpu.analysis.histogram import _bin_indices
    from attosecondraytracing_tpu.ops.moments import chief_ray_refs
    from attosecondraytracing_tpu.ops.source import PHI_FRAC, source_bundle
    from attosecondraytracing_tpu.ops.trace import trace_jit
    from attosecondraytracing_tpu.ops.xla_source import xla_trace_source

    chain, det, elements = load_module(example).build_chain()
    info = chain.source_spec
    ph.info["engine"] = "xla-source"
    t0 = time.perf_counter()
    giga = fused_source_images(info, elements, det, n_total=n_total, bins=bins)
    ph.info["image_s"] = time.perf_counter() - t0
    ph.within("giga image surviving weight fraction", giga["sum_w"] / n_total,
              0.05, 1.0, "finite, nonzero image")
    ph.equal("giga image finite", bool(np.isfinite(giga["image"]).all()), True)

    res = fused_source_images(info, elements, det, n_total=n_check, bins=bins,
                              extent=giga["extent"])
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    lo, hi = (f32(v) for v in giga["extent"])
    spec = info.baked()

    @jax.jit
    def scatter(bundle, weights):
        xy = stats.detector_points_2d(bundle, f32(det.centre), f32(det.normal),
                                      f32(det._plane_rotation()))
        ix, iy, inside = _bin_indices(xy, lo, hi, bins)
        w = jnp.where(inside & bundle.alive, weights, 0.0)
        return jnp.zeros(bins, jnp.float32).at[ix, iy].add(w)

    def weights(n, offset=0):
        k = np.arange(offset, offset + n, dtype=np.float64)
        return jnp.asarray(np.exp(np.log(info.gaussian_edge) * k / n_check),
                           jnp.float32)

    # (a) the same traced rays binned by scatter-add: checks the binning
    chunk = 1 << 23
    own = np.zeros(bins)
    for off in range(0, n_check, chunk):
        n_local = min(chunk, n_check - off)
        phase = float(np.mod(off * PHI_FRAC, 1.0))
        b = xla_trace_source(spec, elements, n_local, phase=phase,
                             k_frac=off / n_check, n_total=n_check,
                             wavelength=info.wavelength)
        own += np.asarray(scatter(b, weights(n_local, off)), np.float64)
    ph.below("binning: L1(image - scatter of its own rays) / sum_w",
             float(np.abs(res["image"] - own).sum() / res["sum_w"]), 1e-3,
             "full-float32 one-hot matmul vs scatter-add; a ray exactly on a "
             "pixel edge may fall either side")

    # (b) the streamed bundle of the same spiral, scatter-added
    streamed = trace_jit(source_bundle(spec, n_check, wavelength=info.wavelength),
                         elements, keep_history=False)
    w_s = weights(n_check)
    t_scatter = best_time(lambda: scatter(streamed, w_s).block_until_ready())
    from attosecondraytracing_tpu.analysis.gigascan import _chunk_binned_sums

    opl_ref, _ = chief_ray_refs(spec, elements, det.centre, det.normal)
    t_onehot = best_time(lambda: jax.block_until_ready(_chunk_binned_sums(
        streamed, w_s, f32(det.centre), f32(det.normal),
        f32(det._plane_rotation()), lo, hi, jnp.float32(opl_ref), bins)))
    ph.info["onehot_binning_1e7_ms"] = t_onehot * 1e3
    ref = np.asarray(scatter(streamed, w_s), np.float64)
    ph.info["scatter_1e7_ms"] = t_scatter * 1e3
    ph.below("surviving weight, relative", _relative(res["sum_w"], ref.sum()),
             1e-4, "float32 sums of 1e7 weights")
    lo_np, hi_np = (np.asarray(v, np.float64) for v in giga["extent"])
    for k, name in enumerate("xy"):
        # pixel-centre coordinates [mm] along this axis
        pix = lo_np[k] + (np.arange(bins[k]) + 0.5) * (hi_np[k] - lo_np[k]) / bins[k]
        axis = pix[:, None] if k == 0 else pix[None, :]
        c_f = (res["image"] * axis).sum() / res["image"].sum()
        c_s = (ref * axis).sum() / ref.sum()
        sd_f = np.sqrt((res["image"] * (axis - c_f) ** 2).sum() / res["image"].sum())
        sd_s = np.sqrt((ref * (axis - c_s) ** 2).sum() / ref.sum())
        ph.below(f"centroid {name} difference [mm]", abs(c_f - c_s), 5e-4,
                 "the fused engine composes the element frames in float64 "
                 "but stores them as float32 maps: ulp(1000 mm) = 6e-5 mm "
                 "per map shifts the whole spot")
        ph.below(f"SD {name} relative difference", _relative(sd_f, sd_s), 2e-3,
                 "rounding noise adds in quadrature to the spot width")
    return ph


def phase_gradient(ph: Phase, n_rays: int = 1_000_000, iters: int = 5,
                   config: Path = EXAMPLES / "CONFIG_gradient_alignment.py"):
    """gradient_align at ``n_rays`` (reverse mode, float32) and one gradient
    against central finite differences of the float64 loss."""
    import jax
    import jax.numpy as jnp

    from attosecondraytracing_tpu.analysis import alignment as al

    def f64(x):
        x = np.asarray(x)
        return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x

    cfg = load_module(config)
    chain, det = cfg.OpticalChain, cfg.detector
    chain.resize_source(n_rays)
    ph.info["engine"] = "xla reverse mode"
    t0 = time.perf_counter()
    _params, history = al.gradient_align(chain, det, iters=iters, lr=2e-5)
    ph.info["align_s"] = time.perf_counter() - t0
    ph.equal("Adam steps", len(history), iters)
    ph.equal("losses finite", bool(np.isfinite(history).all()), True)

    elements = chain.device_elements()
    last = len(elements) - 1  # the mirror the config misaligned

    # the pose composition runs under default_matmul_precision("float32"):
    # it must be full float32 on the card (TF32 would err by ~1e-3)
    angles = np.array([3e-3, -2e-3, 1e-3])
    el32 = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else x,
                        elements[last])
    rot32 = np.asarray(jax.jit(al._perturb_one)(el32, jnp.asarray(angles, jnp.float32),
                                                jnp.zeros(3, jnp.float32)).rot, np.float64)
    with jax.enable_x64():
        rot64 = np.asarray(al._perturb_one(jax.tree.map(f64, elements[last]),
                                           jnp.asarray(angles), jnp.zeros(3)).rot)
    ph.below("pose composition max |float32 - float64|", float(np.abs(rot32 - rot64).max()),
             1e-6, "full float32 matmuls: a few ulps of 1; TF32 passes would give ~1e-3")

    geom = [det.centre, det.normal, det._plane_rotation()]
    params = al.zero_params(len(elements), dtype=jnp.float32)
    grad = jax.jit(jax.grad(al.focus_loss), static_argnames=("survival_weight",))(
        params, chain.source_rays, elements, *(jnp.asarray(g, jnp.float32) for g in geom),
        survival_weight=0.0)
    g32 = np.asarray(grad.angles[last], np.float64)

    eps = 1e-6  # rad
    with jax.enable_x64():
        src64 = jax.tree.map(f64, chain.source_rays)
        els64 = jax.tree.map(f64, elements)
        loss64 = jax.jit(al.focus_loss, static_argnames=("survival_weight",))
        fd = []
        for j in range(3):
            delta = np.zeros((len(elements), 3))
            delta[last, j] = eps
            p64 = al.zero_params(len(elements), dtype=jnp.float64)
            lp = loss64(p64._replace(angles=p64.angles + delta), src64, els64,
                        *geom, survival_weight=0.0)
            lm = loss64(p64._replace(angles=p64.angles - delta), src64, els64,
                        *geom, survival_weight=0.0)
            fd.append((float(lp) - float(lm)) / (2 * eps))
    fd = np.asarray(fd)
    print(f"  d(spot variance)/d(pitch, roll, yaw) of the last mirror [mm^2/rad]: "
          f"float32 reverse mode {g32.tolist()}, float64 central differences "
          f"{fd.tolist()}")
    ph.below("max |grad - finite difference| / max |finite difference|",
             float(np.abs(g32 - fd).max() / max(np.abs(fd).max(), 1e-30)), 2e-2,
             "float32 gradient sums over 1e6 rays (~1e-4 relative) plus "
             "O(eps^2) and support-edge crossings in the differences")
    return ph


# ---------------------------------------------------------------------------
# four cards: the sharded engines against one device
# ---------------------------------------------------------------------------


def phase_four_cards(ph: Phase, n_total: int = 40_000_000, n_devices: int = 4,
                     bins=(256, 256),
                     example: Path = EXAMPLES / "gigaray_delay_map.py"):
    """The sharded engines of parallel.mesh on a 1-D ('rays',) mesh of all
    four cards (joined all to all, so the mesh order is the device order),
    each compared in this process with the one-device engine."""
    import jax

    from attosecondraytracing_tpu.analysis.gigascan import fused_source_images
    from attosecondraytracing_tpu.ops import moments as pm
    from attosecondraytracing_tpu.ops import xla_source as xs
    from attosecondraytracing_tpu.ops.source import source_bundle
    from attosecondraytracing_tpu.parallel import mesh as pmesh

    devices = jax.devices()
    ph.equal("devices", len(devices), n_devices)
    mesh = jax.sharding.Mesh(np.asarray(devices[:n_devices]), ("rays",))
    chain, det, elements = load_module(example).build_chain()
    info = chain.source_spec
    spec = info.baked()
    geom = dict(det_centre=det.centre, det_normal=det.normal,
                det_rot=det._plane_rotation())
    ph.info["engine"] = "xla-source sharded"

    t0 = time.perf_counter()
    mom_4 = pmesh.scan_moments_sharded(spec, elements, n_total, mesh,
                                       gaussian_edge=info.gaussian_edge, **geom)
    ph.info["sharded_moments_s"] = time.perf_counter() - t0
    mom_1 = xs.xla_source_moments(spec, elements, n_total,
                                  gaussian_edge=info.gaussian_edge, **geom)
    dists = (-2.0, 0.0, 2.0)
    st = [pm.sums_to_stats(pm.moments_to_distance_sums(
        m["moments"], dists, m["centre_distance"]), m["opl_ref"], dists)
        for m in (mom_4, mom_1)]
    ph.below("scan_moments_sharded: surviving weight, relative",
             _relative(st[0]["sum_w"][0], st[1]["sum_w"][0]), 1e-4,
             "same global spiral; per-shard vs per-chunk float32 offsets")
    ph.below("scan_moments_sharded: spot SD, max relative",
             float(np.max(np.abs(st[0]["spot_sd"] - st[1]["spot_sd"]) / st[1]["spot_sd"])),
             2e-3, "float32 moment sums over 4e7 rays, two partitions")

    stats_4 = pmesh.source_stats_sharded(spec, elements, n_total, mesh,
                                         distances=dists, **geom)
    stats_1 = xs.xla_source_detector_stats(spec, elements, n_total,
                                           distances=dists, **geom)
    ph.below("source_stats_sharded: spot SD, max relative",
             float(np.max(np.abs(stats_4["spot_sd"] - stats_1["spot_sd"]) / stats_1["spot_sd"])),
             2e-3, "float32 moment sums over 4e7 rays, two partitions")
    ph.below("source_stats_sharded: duration SD, max difference [fs]",
             float(max(_duration_gap(a, b) for a, b in
                       zip(stats_4["duration_sd"], stats_1["duration_sd"]))),
             0.3, "same rays; float32 delay moments, two partitions")

    ref = fused_source_images(info, elements, det, n_total=n_total, bins=bins)
    opl_ref, _ = pm.chief_ray_refs(spec, elements, det.centre, det.normal)
    t0 = time.perf_counter()
    w4, _wd4 = pmesh.source_images_sharded(
        spec, elements, n_total, mesh, det.centre, det.normal,
        det._plane_rotation(), ref["extent"], bins=bins,
        gaussian_edge=info.gaussian_edge, opl_ref=opl_ref,
        wavelength=info.wavelength)
    ph.info["sharded_image_s"] = time.perf_counter() - t0
    ph.below("source_images_sharded: surviving weight, relative",
             _relative(w4.sum(), ref["sum_w"]), 1e-5,
             "same rays inside the same extent")
    ph.below("source_images_sharded: L1 / sum_w",
             float(np.abs(w4 - ref["image"]).sum() / ref["sum_w"]), 0.1,
             "shard vs chunk spiral offsets round the golden angle "
             "differently (~2e-5 rad): rays on pixel edges hop one bin")

    n_trace = n_total // 4
    src = source_bundle(spec, n_trace, wavelength=info.wavelength)
    out_4 = pmesh.trace_sharded(src, elements, mesh)
    # the same jitted trace, unsharded on one device
    out_1 = pmesh._trace_jit(src, elements, True, False)
    a4, a1 = np.asarray(out_4.alive)[:n_trace], np.asarray(out_1.alive)
    ph.equal("trace_sharded: alive masks equal", bool((a4 == a1).all()), True)
    dp = float(np.abs(np.asarray(out_4.p)[:n_trace][a1] - np.asarray(out_1.p)[a1]).max())
    ph.below("trace_sharded: max |d position| [mm]", dp, 1e-6,
             "the same streamed program on every shard")
    return ph


ONE_CARD = (
    ("1 driver scan", phase_driver_scan),
    ("2 single chain, bundle output", phase_single_chain),
    ("3 grid-defect chain", phase_deformed),
    ("4 giga-ray image", phase_giga_image),
    ("5 alignment gradient", phase_gradient),
)


def run_phase(name, fn, card: str, clock: CompileClock) -> bool:
    import jax

    print(f"phase {name}", flush=True)
    ph = Phase(name)
    compile0 = clock.seconds
    t0 = time.perf_counter()
    try:
        fn(ph)
    except Exception:  # report the phase as failed, then carry on
        traceback.print_exc()
        ph.ok = False
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not measured")
    extra = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in ph.info.items())
    print(f"phase {name}: {'ok' if ph.ok else 'FAILED'} card=\"{card}\" "
          f"wall_s={wall:.6g} compile_s={clock.seconds - compile0:.6g} "
          f"peak_bytes_in_use={peak} {extra}", flush=True)
    return ph.ok


def floors(card: str, kind: str, infos: dict, bw: float):
    """Engine time at 1e7 rays as a share of its floor."""
    print(f"copy bandwidth (1 GiB read + write): {bw / 1e9:.6g} GB/s "
          f"card=\"{card}\"")
    bundle_ms = infos.get("bundle_ms")
    if bundle_ms:
        floor = 10_000_000 * BUNDLE_BYTES_PER_RAY / bw
        print(f"bundle trace (CONFIG_singleparabola, 1e7 rays): "
              f"{bundle_ms:.6g} ms; write floor {floor * 1e3:.6g} ms "
              f"({BUNDLE_BYTES_PER_RAY} B/ray) -> share {floor * 1e3 / bundle_ms:.4g}")
    moments_ms = infos.get("moments_ms")
    if moments_ms:
        flops = infos.get("moments_flops", 0.0)
        peak = PEAK_F32_FLOPS.get(kind)
        share = (f"{flops / peak * 1e3 / moments_ms:.4g}" if peak and flops
                 else "not measured (device kind not in the peak table)")
        print(f"moments pass (CONFIG_2toroidals_f-x-f middle chain, 1e7 rays): "
              f"{moments_ms:.6g} ms; {flops:.6g} FLOP (XLA cost analysis) over "
              f"67 TFLOP/s float32 -> share {share}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded engines on four cards")
    args = parser.parse_args(argv)

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (default device: "
              f"{device.platform}); refusing to run on the CPU.",
              file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from attosecondraytracing_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    card = card_line()
    print(f"card: {card}", flush=True)
    clock = CompileClock()

    if args.four_cards:
        ok = run_phase("four cards, sharded engines", phase_four_cards, card, clock)
    else:
        infos = {}
        ok = True
        for name, fn in ONE_CARD:
            def keep(ph, fn=fn):
                fn(ph)
                infos.update(ph.info)
            ok &= run_phase(name, keep, card, clock)
        floors(card, device.device_kind, infos, copy_bandwidth())
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
