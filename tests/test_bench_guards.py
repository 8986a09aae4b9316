"""Benchmark-integrity guards.

A recorded slope-timing artifact: a streamed 1e7-ray trace at 0.118 ms
(85e9 rays/s), which implies ~5 TB/s of memory traffic on a device whose
measured copy bandwidth was 0.5 TB/s, and which beats the strictly-less-work
fused-source path (1.038 ms in the same run) by 9x. A same-device rerun read
2.029 ms. These tests replay those numbers (device-independent test vectors,
not measurements of any card) through bench.py's guards and assert each of
the three independent checks rejects them, while the honest reruns pass.
"""

import bench


STREAMED_ARTIFACT = 0.118e-3  # artifact: streamed trace, slope timing
FUSED_SAME_RUN = 1.038e-3     # same run, fused-source path
STREAMED_RERUN = 2.029e-3     # same-device rerun of the streamed path
FUSED_RERUN = 1.562e-3
N_RAYS = 10_000_000
MEASURED_BW = 500e9           # the copy probe of that run


NOISE_S = 0.25 * 28e-3 / 8  # bench._measure_path's floor at 28 ms overhead


def test_reconcile_rejects_r4_artifact():
    # slope said 0.118 ms; a direct (single-dispatch, overhead-subtracted)
    # timing of the same kernel reads ~2 ms — 17x disagreement, well above
    # the direct sample's own noise floor
    canonical, ok = bench.reconcile(STREAMED_ARTIFACT, STREAMED_RERUN,
                                    noise_s=NOISE_S)
    assert not ok
    assert canonical == STREAMED_RERUN  # conservative: the larger wins


def test_reconcile_accepts_honest_spread():
    # honest slope vs direct land within the dispatch noise (<2x)
    canonical, ok = bench.reconcile(1.56e-3, 1.9e-3)
    assert ok
    assert canonical == 1.56e-3  # slope is canonical when consistent


def test_reconcile_rejects_nonpositive():
    _, ok = bench.reconcile(0.0, 1.0e-3)
    assert not ok


def test_reconcile_noise_floor_covers_sub_dispatch_passes():
    # a 0.05 ms moment pass is below the dispatch noise: direct
    # reads ~0 and the ratio test would false-flag it — the absolute noise
    # allowance must accept it (observed on the 1e6-ray smoke run)
    canonical, ok = bench.reconcile(0.046e-3, 0.0, noise_s=NOISE_S)
    assert ok
    assert canonical == 0.046e-3


def test_roofline_rejects_r4_artifact():
    # 61 B/ray * 1e7 rays = 610 MB; at 500 GB/s the floor is 1.22 ms —
    # 0.118 ms implies 5.2 TB/s and must be rejected
    assert not bench.roofline_ok(STREAMED_ARTIFACT, N_RAYS,
                                 bench.MIN_BYTES_PER_RAY["streamed"], MEASURED_BW)


def test_roofline_accepts_honest_timings():
    assert bench.roofline_ok(STREAMED_RERUN, N_RAYS,
                             bench.MIN_BYTES_PER_RAY["streamed"], MEASURED_BW)
    assert bench.roofline_ok(FUSED_RERUN, N_RAYS,
                             bench.MIN_BYTES_PER_RAY["fused_bundle"], MEASURED_BW)
    # a future optimized fused-source pass near its write-bound floor
    # (~0.8 ms at 37 B/ray) must still pass — the margin covers it
    assert bench.roofline_ok(0.75e-3, N_RAYS,
                             bench.MIN_BYTES_PER_RAY["fused_bundle"], MEASURED_BW)


def test_ordering_flags_r4_artifact():
    # the streamed path reads 24 B/ray MORE than the fused-source path; it
    # cannot legitimately run 9x faster
    flagged = bench.ordering_flags(
        {"streamed": STREAMED_ARTIFACT, "fused_bundle": FUSED_SAME_RUN})
    assert flagged == ["streamed"]


def test_ordering_accepts_honest_order():
    assert bench.ordering_flags(
        {"streamed": STREAMED_RERUN, "fused_bundle": FUSED_RERUN}) == []
    # src slightly slower than streamed is also fine (within tolerance)
    assert bench.ordering_flags(
        {"streamed": 1.5e-3, "fused_bundle": 1.45e-3}) == []


def test_bytes_per_ray_cover_all_measured_paths():
    # every label bench.main measures must have a declared traffic floor
    # (0.0 = moments-only paths with no per-ray memory floor)
    for label in ("streamed", "fused_bundle", "scan20", "scan_rt", "defect"):
        assert label in bench.MIN_BYTES_PER_RAY
