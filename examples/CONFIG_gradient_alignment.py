"""Gradient-descent re-alignment of a misaligned grazing-incidence chain —
the gradient-based replacement for scan-list alignment hunting (BASELINE.md's
'masked grazing-incidence chain with alignment-gradient descent' scenario).

Run:  python -m attosecondraytracing_tpu.main examples/CONFIG_gradient_alignment.py
(the driver traces + reports; the gradient descent happens below at import
time and prints its loss history)."""
import numpy as np
from attosecondraytracing_tpu import mirrors as mmirror
from attosecondraytracing_tpu import masks as mmask
from attosecondraytracing_tpu import supports as msupp
from attosecondraytracing_tpu import processing as mp
from attosecondraytracing_tpu.analysis import alignment as al
from attosecondraytracing_tpu.models.detector import Detector

SourceProperties = {
    'Divergence': 10e-3/2,  # small NA: misalignment dominates over aberrations
    'SourceSize': 0,
    'Wavelength': 80e-6,
    'DeltaFT': 0.5,
    'NumberRays': 2000,
}

Description = "mask + toroidal refocuser, randomly misaligned, then gradient-realigned"
Focal, AngleIncidence = 500, 80
R, r = mmirror.ReturnOptimalToroidalRadii(Focal, AngleIncidence)
Toroidal = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(300, 50))
Mask = mmask.Mask(msupp.SupportRoundHole(Radius=25, RadiusHole=6, CenterHoleX=0, CenterHoleY=0))

OpticalChain = mp.OEPlacement(SourceProperties, [Mask, Toroidal], [400, 2*Focal-400],
                              [0, AngleIncidence], Description=Description)

# fix a detector at the nominal focus, then knock the mirror out of alignment
detector = Detector(OpticalChain.optical_elements[-1].position)
detector.autoplace(OpticalChain.get_output_rays()[-1], 2*Focal)
OpticalChain.rotate_OE(1, "roll", 0.05)
OpticalChain.rotate_OE(1, "pitch", 0.02)

# gradient descent on the real optical figure of merit (spot variance),
# reverse mode through the batched trace
params, history = al.gradient_align(OpticalChain, detector, iters=150, lr=2e-5,
                                    verbose=True)
print(f"alignment loss: {history[0]:.3e} -> {history[-1]:.3e}")

DetectorOptions = {
    'ReflectionNumber': -1,
    'ManualDetector': False,
    'DistanceDetector': 2*Focal,
    'AutoDetectorDistance': False,
    'OptFor': "intensity",
}

AnalysisOptions = {'verbose': True, 'save_results': False}

if __name__ == "__main__":
    from attosecondraytracing_tpu.main import main
    main(OpticalChain, SourceProperties, DetectorOptions, AnalysisOptions)
