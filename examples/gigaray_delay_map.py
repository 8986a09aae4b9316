"""Giga-ray spot diagram + femtosecond delay map, rendered on device.

Showcase of what the reference cannot reach: the reference's
SpotDiagram/DelayGraph (ART/ModuleAnalysisAndPlots.py:133-440) fetch every
traced ray to the host and scatter-plot them — practical to ~1e4 rays. Here
the source is synthesized *inside* the fused XLA engine chunk by chunk and
binned on device (analysis/gigascan.py), so the ray count is limited by
patience, not memory: nothing per-ray ever reaches the host.

    python examples/gigaray_delay_map.py              # 1e8 rays (GPU)
    python examples/gigaray_delay_map.py 1e9          # a billion rays
    JAX_PLATFORMS=cpu python examples/gigaray_delay_map.py 2e5   # smoke

Writes gigaray_delay_map.png next to the repo root: intensity image (left),
mean-delay map in fs (right), through the flagship 2-toroidal grazing-
incidence chain with a slight roll misalignment so the delay map shows the
characteristic spatio-temporal tilt.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from attosecondraytracing_tpu.analysis.gigascan import fused_source_images
from attosecondraytracing_tpu.models import masks as mmask
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.placement import OEPlacement


def build_chain():
    """The flagship 2-toroidal grazing-incidence chain with a sub-mrad roll
    misalignment of the refocusing mirror (so the delay map shows the
    characteristic spatio-temporal tilt), its detector at the refocus, and
    float32 device elements. Returns (chain, detector, elements)."""
    focal, incidence = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, incidence)
    toroidal = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    chain = OEPlacement(
        {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
         "DeltaFT": 0.5, "NumberRays": 200_000},
        [mask, toroidal, toroidal],
        [400.0, 100.0, 2 * focal],
        [0.0, incidence, -incidence],
        Description="flagship: mask + 2 toroidals f-d-f",
    )
    chain.rotate_OE(2, "roll", 0.05)

    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(), focal)

    elements = [e.to_device(dtype=np.float32) for e in chain.optical_elements]
    return chain, det, elements


def main(n_total: int) -> None:
    chain, det, elements = build_chain()
    res = fused_source_images(chain.source_spec, elements, det,
                              n_total=n_total, bins=(512, 512))

    import matplotlib

    matplotlib.use("Agg")
    from attosecondraytracing_tpu.analysis.plots import GigaRayImages

    fig = GigaRayImages(res, title=chain.description)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "gigaray_delay_map.png")
    fig.savefig(out, dpi=130)
    w = res["sum_w"]
    d = res["mean_delay"]
    print(f"rays traced: {res['n_total']:.3e}, surviving weight {w:.3e}")
    print(f"delay-map spread (fs): {np.nanmin(d):.2f} .. {np.nanmax(d):.2f}")
    print(f"wrote {os.path.normpath(out)}")


if __name__ == "__main__":
    main(int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000)
