"""Sharding tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4):
identical code runs on the cards of one host."""

import jax
import numpy as np
import pytest

from attosecondraytracing_tpu.analysis import stats
from attosecondraytracing_tpu.models import mirrors as mmirror
from attosecondraytracing_tpu.models import supports as msupp
from attosecondraytracing_tpu.models.placement import OEPlacement
from attosecondraytracing_tpu.parallel import mesh as pmesh


def _chain(n_rays=256, distance=1000.0):
    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    mirror = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(300, 50))
    props = {"Divergence": 15e-3, "SourceSize": 0, "Wavelength": 50e-6, "DeltaFT": 1, "NumberRays": n_rays}
    return OEPlacement(props, [mirror], [distance], [inc])


def test_eight_virtual_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_trace_matches_unsharded():
    chain = _chain(n_rays=250)  # not divisible by 8 -> exercises padding
    ref = chain.trace_final()
    mesh = pmesh.make_mesh()
    out = pmesh.trace_sharded(chain.source_rays, chain.device_elements(), mesh)
    assert out.n_rays == 256  # padded
    n = ref.n_rays
    np.testing.assert_allclose(np.asarray(out.p)[:n], np.asarray(ref.p), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.alive)[:n], np.asarray(ref.alive))
    assert not np.asarray(out.alive)[n:].any()  # padding stays dead
    # reductions over the sharded bundle produce replicated scalars
    et = stats.energy_transmission(out, out)
    np.testing.assert_allclose(float(et), 100.0)


def test_scan_batching_matches_serial():
    chains = _chain(128).get_OE_loop_list(0, "roll", np.linspace(-0.2, 0.2, 4))
    stacked_elements, stacked_sources = pmesh.stack_chains(chains)
    batched = pmesh.trace_scan(stacked_sources, stacked_elements)
    for i, c in enumerate(chains):
        ref = c.trace_final()
        got = jax.tree.map(lambda x: x[i], batched)
        np.testing.assert_allclose(np.asarray(got.p), np.asarray(ref.p), atol=1e-12)
        np.testing.assert_array_equal(np.asarray(got.alive), np.asarray(ref.alive))


def test_scan_sharded_2x4_mesh():
    chains = _chain(128).get_OE_loop_list(0, "roll", np.linspace(-0.2, 0.2, 2))
    mesh = pmesh.make_mesh(rays=4, scan=2)
    out = pmesh.trace_scan_sharded(chains, mesh)
    assert out.p.shape == (2, 128, 3)
    ref0 = chains[0].trace_final()
    np.testing.assert_allclose(np.asarray(out.p)[0], np.asarray(ref0.p), atol=1e-12)


def test_mesh_validation():
    with pytest.raises(ValueError):
        pmesh.make_mesh(rays=3, scan=2)


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def test_sharded_trace_is_compute_local():
    """Rays never interact: the compiled sharded trace must contain no
    collectives at all (ray state stays on its device); a detector-statistics
    reduction over the same sharded bundle is what introduces the (scalar)
    cross-device reduction. Guards the >=90% scaling target of BASELINE.md:
    any accidental resharding inside the trace would show up here first."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from attosecondraytracing_tpu.ops.trace import trace

    chain = _chain(n_rays=256)
    mesh = pmesh.make_mesh()  # 1 x 8
    src = pmesh.shard_bundle(chain.source_rays, mesh)
    els = jax.device_put(chain.device_elements(), NamedSharding(mesh, P()))

    pure = jax.jit(lambda s, e: trace(s, e, keep_history=False)).lower(src, els).compile()
    found = [c for c in _COLLECTIVES if c in pure.as_text()]
    assert not found, f"sharded trace emits collectives: {found}"

    def with_stats(s, e):
        out = trace(s, e, keep_history=False)
        return stats.energy_transmission(s, out)

    reduced = jax.jit(with_stats).lower(src, els).compile()
    found = [c for c in _COLLECTIVES if c in reduced.as_text()]
    assert found, "expected a cross-device reduction in the statistics step"


def test_distributed_init_reports_failure(monkeypatch, capsys):
    """A failed jax.distributed.initialize must not be swallowed silently:
    the fallback to single-host is announced on stderr and signalled by the
    return value (VERDICT r2 #6)."""
    import jax

    from attosecondraytracing_tpu.parallel import mesh as pmesh

    def boom(**kwargs):
        raise RuntimeError("no coordinator address configured")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    ok = pmesh.distributed_init()
    captured = capsys.readouterr()
    assert ok is False
    assert "continuing single-host" in captured.err
    assert "no coordinator address configured" in captured.err
