"""Standard visualizations (ART/ModuleAnalysisAndPlots.py).

Same plot set and signatures as the reference: interactive spot diagram
(left/right arrows move the detector), 3D delay graph, mirror projection, and
a 3D render of the optical chain. The reference renders with PyVista/Qt;
this environment has no GUI stack, so the 3D render falls back to matplotlib
3D (PyVista is used automatically when importable).
"""

from __future__ import annotations

import numpy as np

import matplotlib

if not (matplotlib.get_backend() or "").lower().startswith(("qt", "tk", "gtk", "macosx")):
    try:  # headless default
        matplotlib.use("Agg", force=False)
    except Exception:
        pass
import matplotlib.pyplot as plt

from ..ops import host_geometry as hg
from ..ops import supports as sup
from ..ops.bundle import RayBundle, to_host
from . import stats


def _alive(bundle):
    return np.asarray(bundle.alive)


def _detector_points_um(bundle: RayBundle, detector):
    """(x_um, y_um, focal_spot_minmax, spot_sd) of surviving impact points
    (_getDetectorPoints, ART/ModuleAnalysisAndPlots.py:28-58)."""
    xy = np.asarray(detector.get_PointList2DCentre(bundle))
    alive = _alive(bundle)
    xy = xy[alive]
    spot_sd = float(np.sqrt(np.var(xy, axis=0).sum())) if len(xy) else 0.0
    extent = float(max(np.ptp(xy[:, 0]), np.ptp(xy[:, 1]))) if len(xy) else 0.0
    return xy[:, 0] * 1e3, xy[:, 1] * 1e3, extent, spot_sd


def getETransmission(source: RayBundle, out: RayBundle) -> float:
    """Energy transmission in percent (ART/ModuleAnalysisAndPlots.py:62-77)."""
    return float(stats.energy_transmission(source, out))


def GetResultSummary(detector, bundle: RayBundle, verbose=False):
    from ..main import get_result_summary

    return get_result_summary(detector, bundle, verbose)


def _color_data(bundle: RayBundle, detector, color_coded):
    alive = _alive(bundle)
    if color_coded == "Intensity":
        return np.asarray(bundle.intensity)[alive], "Intensity (arb.u.)"
    if color_coded == "Incidence":
        return np.rad2deg(np.asarray(bundle.incidence))[alive], "Incidence angle (deg)"
    if color_coded == "Delay":
        return np.asarray(detector.get_Delays(bundle))[alive], "Delay (fs)"
    return None, None


def SpotDiagram(bundle: RayBundle, detector, DrawAiryAndFourier=False, ColorCoded=None):
    """Interactive spot diagram; arrows shift the detector
    (ART/ModuleAnalysisAndPlots.py:133-280)."""
    na = float(stats.numerical_aperture(bundle))
    wavelength = float(np.asarray(bundle.wavelength))
    airy_um = float(stats.airy_radius(wavelength, na)) * 1e3 if DrawAiryAndFourier else 0.0

    x_um, y_um, extent, spot_sd = _detector_points_um(bundle, detector)
    z, zlabel = _color_data(bundle, detector, ColorCoded)

    fig, ax = plt.subplots()
    if DrawAiryAndFourier and airy_um > 0:
        th = np.linspace(0, 2 * np.pi, 100)
        ax.plot(airy_um * np.cos(th), airy_um * np.sin(th), c="black")

    dist = detector.get_distance()
    label = f"{dist:.3f} mm\n{spot_sd * 1e3:.1f} μm SD"
    if ColorCoded == "Delay":
        label += f"\n{np.std(z):.2f} fs SD"
    sc = ax.scatter(x_um, y_um, c=z if z is not None else "red", s=15, label=label)
    if zlabel:
        fig.colorbar(sc).set_label(zlabel)
    lim = 1.1 * max(airy_um, 0.5 * extent * 1e3, 1e-12)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.legend(loc="upper right")
    ax.set_xlabel("X (µm)")
    ax.set_ylabel("Y (µm)")
    title = (ColorCoded + " + " if ColorCoded else "") + "Spot Diagram\n press left/right to move detector position"
    ax.set_title(title)

    state = {"detector": detector.copy_detector(), "dist": dist}
    na_safe = max(min(na, 1.0), 1e-9)
    step0 = min(50, max(0.0005, round(extent / 8 / np.arcsin(na_safe) * 10000) / 10000))
    state["step"] = step0

    def on_key(event):
        if event.key == "right":
            state["detector"].shiftByDistance(state["step"])
            state["dist"] += state["step"]
        elif event.key == "left":
            if state["dist"] > 1.5 * state["step"]:
                state["detector"].shiftByDistance(-state["step"])
                state["dist"] -= state["step"]
            else:
                state["detector"].shiftToDistance(0.5 * state["step"])
                state["dist"] = 0.5 * state["step"]
        else:
            return
        nx, ny, nextent, nsd = _detector_points_um(bundle, state["detector"])
        sc.set_offsets(np.column_stack([nx, ny]))
        label = f"{state['dist']:.3f} mm\n{nsd * 1e3:.1f} μm SD"
        if ColorCoded == "Delay":
            nz = np.asarray(state["detector"].get_Delays(bundle))[_alive(bundle)]
            sc.set_array(nz)
            sc.set_clim(nz.min(), nz.max())
            label += f"\n{np.std(nz):.2f} fs SD"
        sc.set_label(label)
        ax.legend(loc="upper right")
        lim = 1.1 * max(airy_um, 0.5 * nextent * 1e3, 1e-12)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        state["step"] = min(50, max(0.0005, round(nextent / 8 / np.arcsin(na_safe) * 10000) / 10000))
        fig.canvas.draw_idle()

    fig.canvas.mpl_connect("key_press_event", on_key)
    _maybe_show()
    return fig


def _image_data(bundle: RayBundle, detector, ColorCoded, bins):
    """(image, (lo, hi), colorbar label) for the device-binned plots; the
    image is NaN outside the beam for mean-value maps."""
    from .histogram import value_map

    if ColorCoded in (None, "Intensity"):
        img, (lo, hi) = detector.get_Image(bundle, bins=(bins, bins))
        img = np.asarray(img)
        label = "Intensity (arb.u.)" if ColorCoded else None
        return np.where(img > 0, img, np.nan), (np.asarray(lo), np.asarray(hi)), label
    if ColorCoded == "Delay":
        mean, _w, (lo, hi) = detector.get_DelayMap(bundle, bins=(bins, bins))
        return np.asarray(mean), (np.asarray(lo), np.asarray(hi)), "Delay (fs)"
    if ColorCoded == "Incidence":
        mean, _w, (lo, hi) = value_map(
            bundle, np.rad2deg(np.asarray(bundle.incidence)),
            detector.centre, detector.normal, detector._plane_rotation(),
            bins=(bins, bins),
        )
        return np.asarray(mean), (np.asarray(lo), np.asarray(hi)), "Incidence angle (deg)"
    raise ValueError(f"unknown ColorCoded {ColorCoded!r}")


def SpotDiagramImage(bundle: RayBundle, detector, DrawAiryAndFourier=False,
                     ColorCoded=None, bins=256):
    """Device-binned spot diagram: the gather-free equivalent of
    :func:`SpotDiagram` for production-size bundles (only O(bins^2) bytes
    leave the device; the scatter version fetches every ray). Default is the
    intensity histogram; ``ColorCoded`` "Delay"/"Incidence" show per-pixel
    weighted means instead."""
    img, (lo, hi), zlabel = _image_data(bundle, detector, ColorCoded, bins)
    spot_sd, duration_sd = detector.get_SpotAndDuration(bundle)
    # recentre the extent like the scatter plot's get_PointList2DCentre
    mid = 0.5 * (lo + hi)
    lo_um, hi_um = (lo - mid) * 1e3, (hi - mid) * 1e3

    fig, ax = plt.subplots()
    im = ax.imshow(
        img.T,  # histogram layout: x along axis 0 -> transpose for imshow
        origin="lower",
        extent=(lo_um[0], hi_um[0], lo_um[1], hi_um[1]),
        aspect="equal",
        cmap="inferno" if ColorCoded in (None, "Intensity") else "viridis",
    )
    if zlabel:
        fig.colorbar(im).set_label(zlabel)
    if DrawAiryAndFourier:
        na = float(stats.numerical_aperture(bundle))
        wavelength = float(np.asarray(bundle.wavelength))
        airy_um = float(stats.airy_radius(wavelength, na)) * 1e3
        if airy_um > 0:
            th = np.linspace(0, 2 * np.pi, 100)
            ax.plot(airy_um * np.cos(th), airy_um * np.sin(th), c="white", lw=0.8)
    label = f"{detector.get_distance():.3f} mm\n{float(spot_sd) * 1e3:.1f} μm SD"
    if ColorCoded == "Delay":
        label += f"\n{float(duration_sd):.2f} fs SD"
    ax.set_xlabel("X (µm)")
    ax.set_ylabel("Y (µm)")
    title = (ColorCoded + " + " if ColorCoded else "") + "Spot Diagram (device-binned)"
    ax.set_title(title)
    ax.text(0.02, 0.98, label, transform=ax.transAxes, va="top", ha="left",
            color="white", fontsize=8)
    _maybe_show()
    return fig


def DelayMapImage(bundle: RayBundle, detector, DeltaFT=None,
                  DrawAiryAndFourier=False, ColorCoded=None, bins=256):
    """Device-binned spatio-temporal distortion map: per-pixel mean delay
    [fs] over the detector plane — the production-size replacement for the 3D
    :func:`DelayGraph` scatter (``ColorCoded`` "Intensity"/"Incidence" swap
    the mapped quantity, as in the reference's color-coded delay graphs)."""
    which = "Delay" if ColorCoded in (None, "Delay") else ColorCoded
    return SpotDiagramImage(bundle, detector, DrawAiryAndFourier, which, bins)


def GigaRayImages(res: dict, title: str = ""):
    """Intensity image + mean-delay map from a
    :func:`attosecondraytracing_tpu.analysis.gigascan.fused_source_images`
    result: the detector images at ray counts far beyond any traced bundle
    (the source is synthesized chunk-wise inside the fused engine and binned
    on device)."""
    lo, hi = res["extent"]
    mid = 0.5 * (np.asarray(lo) + np.asarray(hi))
    lo_um, hi_um = (np.asarray(lo) - mid) * 1e3, (np.asarray(hi) - mid) * 1e3
    extent = (lo_um[0], hi_um[0], lo_um[1], hi_um[1])

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.6))
    im1 = ax1.imshow(res["image"].T, origin="lower", extent=extent,
                     aspect="equal", cmap="inferno")
    ax1.set_title(f"Intensity ({res['n_total']:.2e} rays)")
    fig.colorbar(im1, ax=ax1).set_label("weight / pixel")
    im2 = ax2.imshow(res["mean_delay"].T, origin="lower", extent=extent,
                     aspect="equal", cmap="coolwarm")
    ax2.set_title("Mean delay (fs)")
    fig.colorbar(im2, ax=ax2).set_label("fs")
    for ax in (ax1, ax2):
        ax.set_xlabel("X (µm)")
        ax.set_ylabel("Y (µm)")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    _maybe_show()
    return fig


def DelayGraph(bundle: RayBundle, detector, DeltaFT, DrawAiryAndFourier=False, ColorCoded=None):
    """3D spot diagram with ray delay on the z-axis
    (ART/ModuleAnalysisAndPlots.py:284-440)."""
    na = float(stats.numerical_aperture(bundle))
    wavelength = float(np.asarray(bundle.wavelength))
    airy_um = float(stats.airy_radius(wavelength, na)) * 1e3

    x_um, y_um, extent, spot_sd = _detector_points_um(bundle, detector)
    delays = np.asarray(detector.get_Delays(bundle))[_alive(bundle)]
    z, zlabel = _color_data(bundle, detector, ColorCoded)

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.set_xlabel("X (µm)")
    ax.set_ylabel("Y (µm)")
    ax.set_zlabel("Delay (fs)")
    label = f"{detector.get_distance():.3f} mm\n{spot_sd * 1e3:.1f} μm SD\n{np.std(delays):.2f} fs SD"
    sc = ax.scatter(x_um, y_um, delays, s=4, c=z if z is not None else delays, label=label)
    if zlabel:
        fig.colorbar(sc, pad=0.12).set_label(zlabel)
    ax.legend(loc="upper right")
    if DrawAiryAndFourier and airy_um > 0:
        xs = np.linspace(-airy_um, airy_um, 40)
        zs = np.linspace(np.mean(delays) - DeltaFT * 0.5, np.mean(delays) + DeltaFT * 0.5, 40)
        X, Z = np.meshgrid(xs, zs)
        Y = np.sqrt(np.maximum(airy_um**2 - X**2, 0.0))
        ax.plot_wireframe(X, Y, Z, color="grey", alpha=0.1)
        ax.plot_wireframe(X, -Y, Z, color="grey", alpha=0.1)
    lim = 1.1 * max(airy_um, 0.5 * extent * 1e3, 1e-12)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    _maybe_show()
    return fig


def MirrorProjection(chain, ReflectionNumber: int, Detector=None, ColorCoded=None):
    """Ray impact points projected on the optic's support plane
    (ART/ModuleAnalysisAndPlots.py:444-525)."""
    element = chain.optical_elements[ReflectionNumber]
    bundle = to_host(chain.get_output_rays()[ReflectionNumber])
    alive = _alive(bundle)
    # into the mirror-support frame (mirror frame without the centre shift)
    R = element.frame_rotation()
    local = (np.asarray(bundle.p) - element.position) @ R.T
    x, y = local[alive, 0], local[alive, 1]

    z, zlabel = _color_data(bundle, Detector, ColorCoded)
    if ColorCoded == "Delay" and Detector is None:
        raise ValueError("If you want to project ray delays, you must specify a detector.")

    fig, ax = plt.subplots(subplot_kw={"aspect": "equal"})
    for contour in sup.contour_points(element.type.support, 200):
        closed = np.vstack([contour, contour[:1]])
        ax.fill(closed[:, 0], closed[:, 1], alpha=0.08, color="C0")
    p = ax.scatter(x, y, c=z if z is not None else "red", s=15)
    if zlabel:
        fig.colorbar(p).set_label(zlabel)
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    title = f"Ray {ColorCoded.lower()} projected on mirror" if ColorCoded else "Ray impact points projected on mirror"
    ax.set_title(title, loc="right")
    _maybe_show()
    return fig


def generate_distinct_colors(num_colors):
    """Distinct ray-bundle colors (reference uses colorcet glasbey; fall back
    to matplotlib's tab20)."""
    try:
        import colorcet as cc

        palette = cc.glasbey
        return palette[: min(num_colors, len(palette))]
    except ImportError:
        cmap = plt.get_cmap("tab20")
        return [cmap(i % 20) for i in range(num_colors)]


def RayRenderGraph(
    chain,
    EndDistance=None,
    maxRays=300,
    OEpoints=3000,
    scale_spheres=5.0,
    draw_mesh=False,
    cycle_ray_colors=False,
):
    """3D rendering of optics + traced rays
    (ART/ModuleAnalysisAndPlots.py:616-673). Uses PyVista when available
    (same look as the reference), otherwise matplotlib 3D."""
    history = [to_host(chain.source_rays)] + [to_host(b) for b in chain.get_output_rays()]
    if EndDistance is None:
        EndDistance = float(
            np.linalg.norm(np.asarray(history[0].p)[0] - chain.optical_elements[0].position)
        )

    segment_sets = _ray_segments(history, EndDistance, maxRays)

    try:
        import pyvista as pv
    except ImportError:
        pv = None
    if pv is not None:
        return _render_pyvista(chain, segment_sets, OEpoints, scale_spheres, cycle_ray_colors, draw_mesh)
    colors = generate_distinct_colors(len(segment_sets)) if cycle_ray_colors else [(0.7, 0, 0)] * len(segment_sets)

    fig = plt.figure(figsize=(12, 5))
    ax = fig.add_subplot(projection="3d")
    for segs, color in zip(segment_sets, colors):
        for a, b in segs:
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], color=color, linewidth=0.5, alpha=0.6)
    for element in chain.optical_elements:
        if draw_mesh:
            pts, tris = _element_mesh_lab(element, OEpoints)
            if len(tris):
                ax.plot_trisurf(
                    pts[:, 0], pts[:, 1], pts[:, 2], triangles=tris, alpha=0.4, linewidth=0.1
                )
                continue
        pts = _element_points_lab(element, OEpoints)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=scale_spheres * 0.2, alpha=0.5)
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_zlabel("z (mm)")
    try:
        ax.set_aspect("equal")
    except NotImplementedError:
        pass
    _maybe_show()
    return fig


def _render_pyvista(chain, segment_sets, OEpoints, scale_spheres, cycle_ray_colors, draw_mesh=False):
    """PyVista scene (reference RayRenderGraph look,
    ART/ModuleAnalysisAndPlots.py:616-673). Only reached when pyvista is
    installed.

    With a display and pyvistaqt available, the scene opens in a *live,
    non-blocking* ``BackgroundPlotter`` window (the reference's interactive
    3D scene, ART/ModuleAnalysisAndPlots.py:648-668) so script execution
    continues while the user orbits the model; otherwise a plain (blocking
    or off-screen) ``pv.Plotter`` is used."""
    import pyvista as pv

    plotter = None
    background = False
    if _has_display():
        try:
            from pyvistaqt import BackgroundPlotter

            plotter = BackgroundPlotter(window_size=(1500, 500))
            background = True
        except Exception:
            plotter = None  # no Qt stack: fall through to the blocking plotter
    if plotter is None:
        plotter = pv.Plotter(window_size=(1500, 500), off_screen=not _has_display())
    plotter.set_background("white")
    colors = (
        generate_distinct_colors(len(segment_sets)) if cycle_ray_colors else [(0.7, 0, 0)] * len(segment_sets)
    )
    for segs, color in zip(segment_sets, colors):
        if not segs:
            continue
        pts = np.concatenate([np.stack([a, b]) for a, b in segs], axis=0)
        plotter.add_mesh(pv.line_segments_from_points(pts), color=color[:3])
    for element in chain.optical_elements:
        if draw_mesh:
            # triangulated surface (reference delaunay_2d mesh,
            # ART/ModuleAnalysisAndPlots.py:544-561), built in the optic's
            # local support plane so holes are respected
            pts, tris = _element_mesh_lab(element, OEpoints)
            if len(tris):
                faces = np.column_stack([np.full(len(tris), 3), tris]).ravel()
                plotter.add_mesh(pv.PolyData(pts, faces=faces), opacity=0.7)
                continue
        pts = _element_points_lab(element, OEpoints)
        plotter.add_mesh(
            pv.PolyData(pts), point_size=scale_spheres, render_points_as_spheres=True
        )
    if not background:
        plotter.show(auto_close=False)  # BackgroundPlotter shows itself
    return plotter


def _has_display():
    import os

    return bool(os.environ.get("DISPLAY"))


def _ray_segments(history, end_distance, max_rays):
    """Per-hop line segments between successive bundles; ray identity is the
    array index (the reference matches Ray.number across shrinking lists,
    ART/ModuleAnalysisAndPlots.py:563-602)."""
    rng = np.random.default_rng(0)
    sets = []
    for k in range(len(history)):
        if k < len(history) - 1:
            nxt = history[k + 1]
            alive = np.asarray(nxt.alive)
            idx = np.nonzero(alive)[0]
            if len(idx) > max_rays:
                idx = rng.choice(idx, max_rays, replace=False)
            a = np.asarray(history[k].p)[idx]
            b = np.asarray(nxt.p)[idx]
        else:
            last = history[k]
            alive = np.asarray(last.alive)
            idx = np.nonzero(alive)[0]
            if len(idx) > max_rays:
                idx = rng.choice(idx, max_rays, replace=False)
            a = np.asarray(last.p)[idx]
            b = a + np.asarray(last.d)[idx] * end_distance
        sets.append(list(zip(a, b)))
    return sets


def _element_points_lab(element, n_points):
    """Sample an element's surface and transform to the lab frame (reference
    _RenderOpticalElement, ART/ModuleAnalysisAndPlots.py:529-561)."""
    pts_local = np.asarray(element.type.get_grid3D(n_points))
    R = element.frame_rotation()
    centre = element.type.get_centre()
    return (pts_local - centre) @ R + element.position


def _element_mesh_lab(element, n_points):
    """(lab points, triangle indices) for a surface mesh of the element.

    The reference triangulates with pyvista's ``delaunay_2d`` seeded by
    support-contour edges (ART/ModuleAnalysisAndPlots.py:544-561). Here the
    Delaunay triangulation runs in the optic's local x-y support plane (the
    surface is a height map over the support, so this is well-defined for
    every mirror type), and triangles whose centroid falls off the support
    are dropped — which handles holed supports without an edge source."""
    import matplotlib.tri as mtri

    pts_local = np.asarray(element.type.get_grid3D(n_points))
    x, y = pts_local[:, 0], pts_local[:, 1]
    try:
        tri = mtri.Triangulation(x, y)
    except (ValueError, RuntimeError):  # degenerate grids (<3 pts, collinear)
        return _element_points_lab(element, n_points), np.zeros((0, 3), int)
    tris = tri.triangles
    # support coordinates are relative to the support centre (grid3D points
    # are in the optic frame, offset by get_centre() for off-axis optics)
    centre = element.type.get_centre()
    cx = x[tris].mean(axis=1) - centre[0]
    cy = y[tris].mean(axis=1) - centre[1]
    keep = np.asarray(sup.include(element.type.support, cx, cy))
    tris = tris[keep]
    R = element.frame_rotation()
    centre = element.type.get_centre()
    pts_lab = (pts_local - centre) @ R + element.position
    return pts_lab, tris


def _maybe_show():
    if matplotlib.get_backend().lower() != "agg":
        plt.show(block=False)


def show():
    plt.show(block=False)
