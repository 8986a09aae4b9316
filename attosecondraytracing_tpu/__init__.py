"""attosecondraytracing_tpu — an attosecond ray-tracing framework in JAX.

A from-scratch re-design of the capabilities of mightymightys/
AttosecondRaytracing ("ART") for accelerators: structure-of-arrays ray
bundles traced by batched, differentiable JAX/XLA programs (with a fused
in-jit-source engine for production sizes), sharded over device meshes for
scale-out, with the reference's user-facing
semantics (CONFIG scripts, OEPlacement auto-alignment, detector analysis,
spot/delay diagrams, Monte-Carlo tolerancing) kept intact.

Quick start::

    from attosecondraytracing_tpu import mirrors, supports, processing as mp
    from attosecondraytracing_tpu.main import main

See examples/ for ports of all reference CONFIG scripts.
"""

__version__ = "0.1.0"

from .models import defects, masks, mirrors, sources, supports  # noqa: F401
from .models.chain import OpticalChain  # noqa: F401
from .models.detector import Detector  # noqa: F401
from .models.elements import OpticalElement  # noqa: F401
from .models.placement import OEPlacement  # noqa: F401
from .ops.bundle import RayBundle, make_bundle  # noqa: F401
