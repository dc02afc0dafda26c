"""chip_smoke.py on the CPU: it refuses to measure here, and its phases,
gates, dataset writer and last line work at a small size."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")
SMALL = dict(dims=97, views=16, image=(192, 144), slab_cells=4,
             rgbd_frames=6, rgbd_image=(160, 120), rgbd_voxel=0.05)


@pytest.fixture
def smoke(monkeypatch):
    """A fresh chip_smoke module measuring the CPU at a small size."""
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SIZE.update(SMALL)
    monkeypatch.setattr(mod, "PLATFORM", "cpu")
    # The CPU backend keeps no memory statistics.
    monkeypatch.setattr(
        mod, "phase_memory",
        lambda run: run.gate("peak_device_memory", True, "not on the CPU"),
    )
    return mod


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_refuses_cpu_platform():
    p = subprocess.run([sys.executable, SCRIPT], cwd=ROOT, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert _last_json(p.stdout) == {"ok": False}


def test_refuses_without_the_package(tmp_path):
    """Alone in a directory, the script fails even past the device check."""
    shutil.copy(SCRIPT, tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('s', 'chip_smoke.py')\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "m.PLATFORM = 'cpu'\n"
        "sys.exit(m.main([]))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "package not importable" in p.stdout
    assert _last_json(p.stdout) == {"ok": False}


def test_dataset_writer_roundtrips(smoke, tmp_path):
    from cudadepthmapintegration_tpu.io import DepthMapDataset

    views = smoke.orbit_views(3, 64, 48, seed=0)
    assert any((v.best_cost == 0.9).any() for v in views)  # bad matches
    vti, krtd = smoke.write_dataset(str(tmp_path / "data"), views)
    back = list(DepthMapDataset(vti, krtd))
    assert len(back) == 3
    for v, b in zip(views, back):
        np.testing.assert_array_equal(b.depth, v.depth)
        np.testing.assert_array_equal(b.color, v.color)
        np.testing.assert_array_equal(b.best_cost, v.best_cost)
        np.testing.assert_allclose(b.camera.k, v.camera.k, rtol=1e-12)
        np.testing.assert_allclose(b.camera.rt, v.camera.rt, atol=1e-12)


def test_small_run_passes_and_prints_the_last_line(smoke, capsys):
    rc = smoke.main([])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.strip().splitlines()
    assert _last_json(out) == {
        "ok": True,
        "device": {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": jax.device_count()},
    }
    assert any(line.startswith("phase seconds ") for line in lines)
    gates = [line for line in lines if line.startswith("GATE ")]
    assert len(gates) == 14 and all(": PASS (" in g for g in gates)


def test_failed_gate_fails_the_run(smoke, monkeypatch, capsys):
    monkeypatch.setattr(smoke, "RADIUS_TOL", -1.0)
    monkeypatch.setattr(smoke, "phase_oracle", lambda run: None)
    monkeypatch.setattr(smoke, "phase_rgbd", lambda run, work: None)
    rc = smoke.main([])
    out = capsys.readouterr().out
    assert rc == 1
    assert "GATE mesh_radius: FAIL" in out
    assert _last_json(out) == {"ok": False}


def test_failed_phase_fails_the_run(smoke, monkeypatch, capsys):
    def broken(run):
        with run.phase("oracle"):
            raise RuntimeError("injected")

    monkeypatch.setattr(smoke, "phase_oracle", broken)
    monkeypatch.setattr(smoke, "phase_reconstruct",
                        lambda run, work, state: None)
    monkeypatch.setattr(smoke, "phase_rgbd", lambda run, work: None)
    rc = smoke.main([])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[oracle] FAILED" in out
    assert _last_json(out) == {"ok": False}


def test_four_cards_needs_four_devices(smoke, capsys):
    run = smoke.run_four_cards(jax.devices()[:2])
    assert not run.ok
    assert run.gates == {"four_cards": False}
