"""Square plane-wave beam onto an off-axis parabola — the 'square' fused
source kind end to end (the reference's PlaneWaveSquare intent,
ART/ModuleSource.py:173-207; broken there, working + synthesized in-jit here).

Run: python examples/square_beam.py [n_rays]   (JAX_PLATFORMS=cpu for CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.chain import OpticalChain
from attosecondraytracing_tpu.models.detector import Detector
from attosecondraytracing_tpu.models.elements import OpticalElement
from attosecondraytracing_tpu.models.sources import PlaneWaveSquareFused
from attosecondraytracing_tpu.analysis import stats


def main(n_rays=1_000_000):
    # 20 mm square beam, Gaussian profile to 1/e^2 at the corners
    bundle, spec = PlaneWaveSquareFused(
        np.zeros(3), np.array([1.0, 0.0, 0.0]), SideLength=20.0,
        NbRays=n_rays, Wavelength=800e-6, gaussian_edge=float(1 / np.e**2))

    support = msupp.SupportRectangle(35, 35)
    mirror = mmirror.MirrorParabolic(FocalEffective=100, OffAxisAngle=0,
                                     Support=support)
    el = OpticalElement(mirror, np.array([80.0, 0.0, 0.0]),
                        np.array([-1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]))
    chain = OpticalChain(bundle, [el], "square beam -> parabola",
                         source_spec=spec)

    out = chain.trace_final()
    print(f"engine: {chain.last_trace_engine}; "
          f"{spec.n_rays} rays ({int(np.sqrt(spec.n_rays))}^2 grid), "
          f"transmission {float(stats.energy_transmission(chain.source_rays, out)):.1f}%")

    det = Detector(el.position)
    det.autoplace(out, 100.0)
    xy = det.get_PointList2D(out)
    w = np.asarray(out.alive, float) * np.asarray(chain.source_rays.intensity)
    spot = float(stats.std_points(xy, w))
    print(f"focal spot SD at f=100 mm: {spot*1e3:.2f} um")


if __name__ == "__main__":
    main(int(float(sys.argv[1])) if len(sys.argv) > 1 else 1_000_000)
