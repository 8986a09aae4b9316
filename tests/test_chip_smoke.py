"""chip_smoke.py: refuses anything but a GPU, and its phases rehearse at a
tiny size on the CPU (engine selection as on a GPU host; the XLA engines run
on the CPU backend)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

TINY_GRADIENT_CONFIG = '''
import numpy as np
from attosecondraytracing_tpu import mirrors as mmirror
from attosecondraytracing_tpu import supports as msupp
from attosecondraytracing_tpu import processing as mp
from attosecondraytracing_tpu.models.detector import Detector

SourceProperties = {"Divergence": 0, "SourceSize": 20, "Wavelength": 50e-6,
                    "DeltaFT": 1, "NumberRays": 512}
OpticalChain = mp.OEPlacement(
    SourceProperties, [mmirror.MirrorParabolic(100, 90, msupp.SupportRound(12))],
    [200], [0.0])
detector = Detector(OpticalChain.optical_elements[-1].position)
detector.autoplace(OpticalChain.get_output_rays()[-1], 100.0)
OpticalChain.rotate_OE(0, "roll", 0.05)
'''


def test_refuses_cpu_device(capsys):
    assert chip_smoke.main([]) == 2
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_fails_without_the_repository(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _tiny_deformed(tmp_path):
    text = (ROOT / "examples" / "CONFIG_deformed.py").read_text()
    assert "smallest=0.01" in text
    path = tmp_path / "CONFIG_deformed_tiny.py"
    path.write_text(text.replace("smallest=0.01", "smallest=0.5"))
    return path


def _tiny_gradient(tmp_path):
    path = tmp_path / "CONFIG_gradient_tiny.py"
    path.write_text(TINY_GRADIENT_CONFIG)
    return path


TINY = {
    "driver_scan": lambda ph, tmp: chip_smoke.phase_driver_scan(ph, n_rays=4096),
    "single_chain": lambda ph, tmp: chip_smoke.phase_single_chain(ph, n_rays=8192),
    "deformed": lambda ph, tmp: chip_smoke.phase_deformed(
        ph, n_rays=8192, config=_tiny_deformed(tmp)),
    "giga_image": lambda ph, tmp: chip_smoke.phase_giga_image(
        ph, n_total=50_000, n_check=20_000, bins=(64, 64)),
    "gradient": lambda ph, tmp: chip_smoke.phase_gradient(
        ph, n_rays=2048, iters=2, config=_tiny_gradient(tmp)),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_rehearsal(phase, tmp_path, monkeypatch):
    """Each phase at a tiny size, run explicitly on the CPU (the device
    check lives in chip_smoke.main only): every check must pass."""
    from attosecondraytracing_tpu.models import chain as mchain

    monkeypatch.setattr(mchain, "FUSED_MIN_RAYS", 1024)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    ph = chip_smoke.Phase(phase)
    TINY[phase](ph, tmp_path)
    assert ph.ok, ph.name


@pytest.mark.gpu
def test_chip_smoke_phases_on_card(tmp_path):
    """On a card: every one-card phase at 1e6 rays passes its checks."""
    phases = [
        lambda ph: chip_smoke.phase_driver_scan(ph, n_rays=1_000_000),
        lambda ph: chip_smoke.phase_single_chain(ph, n_rays=1_000_000),
        lambda ph: chip_smoke.phase_deformed(ph, n_rays=1_000_000),
        lambda ph: chip_smoke.phase_giga_image(ph, n_total=10_000_000,
                                               n_check=1_000_000),
        lambda ph: chip_smoke.phase_gradient(ph, n_rays=100_000, iters=2),
    ]
    for k, fn in enumerate(phases):
        ph = chip_smoke.Phase(str(k + 1))
        fn(ph)
        assert ph.ok, ph.name
