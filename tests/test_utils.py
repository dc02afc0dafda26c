"""Logging + profiling utilities."""

import io
import json

import jax
import pytest

from cudadepthmapintegration_tpu.utils import FusionMetrics, Log


def test_log_verbose_gating():
    buf = io.StringIO()
    log = Log(verbose=False, stream=buf)
    log.info("hidden")
    log.always("shown")
    assert "hidden" not in buf.getvalue()
    assert "shown" in buf.getvalue()
    vbuf = io.StringIO()
    vlog = Log(verbose=True, stream=vbuf)
    vlog.info("now visible")
    assert "now visible" in vbuf.getvalue()


def test_log_phase_timing():
    log = Log(verbose=False)
    with log.phase("fuse"):
        pass
    with log.phase("fuse"):
        pass
    assert log.timings["fuse"] >= 0
    assert len(log.timings) == 1  # accumulated, not duplicated
    buf = io.StringIO()
    vlog = Log(verbose=True, stream=buf)
    with vlog.phase("mesh"):
        pass
    assert "** mesh..." in buf.getvalue()
    assert "** mesh: " in buf.getvalue()  # the phase's seconds


def test_fusion_metrics_report():
    m = FusionMetrics(device_kind="NVIDIA H100 80GB HBM3")
    m.seconds = 2.0
    m.add_fusion(num_cells=1000, num_views=50, passes=2)
    rep = m.report()
    assert rep["voxel_updates_per_sec"] == 1000 * 50 / 2.0
    assert rep["views_per_sec"] == 25.0
    assert 0 < rep["hbm_roofline_fraction"] < 1
    json.loads(m.json())  # serializable


def test_fusion_metrics_start_stop():
    m = FusionMetrics()
    m.start()
    m.stop()
    assert m.seconds >= 0
    assert m.voxel_updates_per_sec == 0.0  # no voxels recorded


def test_profiler_trace_writes_output(tmp_path):
    import jax.numpy as jnp

    from cudadepthmapintegration_tpu.utils import trace

    d = str(tmp_path / "trace")
    with trace(d):
        jnp.ones((8, 8)).sum().block_until_ready()
    import os

    # jax.profiler writes a plugins/profile tree under the log dir.
    found = []
    for root, dirs, files in os.walk(d):
        found.extend(files)
    assert found  # something was captured


def test_hbm_peak_known_device():
    from cudadepthmapintegration_tpu.utils.profiling import hbm_peak

    assert hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "unknown accelerator", "NVIDIA A100-SXM4-80GB"])
def test_hbm_peak_unknown_device_raises(kind):
    from cudadepthmapintegration_tpu.utils.profiling import hbm_peak

    with pytest.raises(ValueError, match="no peak bandwidth"):
        hbm_peak(kind)
    m = FusionMetrics(seconds=1.0, device_kind=kind)
    m.add_fusion(num_cells=10, num_views=1)
    with pytest.raises(ValueError):
        m.report()


def test_fusion_metrics_without_device_has_no_roofline():
    m = FusionMetrics(seconds=1.0)
    m.add_fusion(num_cells=10, num_views=2)
    rep = m.report()
    assert rep["device_kind"] is None
    assert rep["hbm_roofline_fraction"] is None
    assert rep["voxel_updates_per_sec"] == 20.0


@pytest.mark.parametrize("env", [None, "set"])
def test_compile_cache_placement(env, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise one fixed directory at the
    root of the checkout."""
    import os

    from cudadepthmapintegration_tpu.cli import _cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = os.path.join(root, ".jax_cache")
    else:
        expected = str(tmp_path / "cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expected)
    assert _cache.compile_cache_dir() == expected
    monkeypatch.delenv("CDMI_NO_COMPILE_CACHE", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        _cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == expected
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_opt_out(monkeypatch):
    from cudadepthmapintegration_tpu.cli import _cache

    monkeypatch.setenv("CDMI_NO_COMPILE_CACHE", "1")
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", "/nonexistent/unchanged")
    try:
        _cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == "/nonexistent/unchanged"
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
