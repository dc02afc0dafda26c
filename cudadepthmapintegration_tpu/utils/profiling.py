"""Profiling & metrics: device traces, throughput counters, roofline report.

The reference's only instrumentation is CPU ``clock()`` wall time
(``vtkCudaReconstructionFilter.cxx:101-148``) plus NSight debugging docs
(``README:43-50``). Equivalents here:

* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace directory (the XProf/NSight counterpart);
* :class:`FusionMetrics` — structured counters for the quantities
  BASELINE.json tracks (voxel updates/s, views/s, bytes moved, roofline
  fraction vs. the device's peak memory bandwidth).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import jax

__all__ = ["trace", "FusionMetrics", "device_memory_stats", "hbm_peak"]

# Published peak device-memory bandwidth (bytes/s), keyed by
# ``jax.Device.device_kind``. Source: NVIDIA H100 data sheet (SXM5: 80 GB
# HBM3 at 3.35 TB/s), at the card's full 700 W power limit.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak(device_kind: str) -> float:
    """Peak memory bandwidth of `device_kind`; an unknown device raises."""
    try:
        return HBM_PEAK[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth recorded for device kind {device_kind!r}"
        ) from None


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/trace'):`` captures a jax.profiler device trace."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> dict:
    """Live/peak device memory, when the backend exposes it."""
    device = device or jax.devices()[0]
    stats = getattr(device, "memory_stats", lambda: None)()
    if not stats:
        return {}
    return {
        "bytes_in_use": stats.get("bytes_in_use"),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }


@dataclasses.dataclass
class FusionMetrics:
    """Throughput accounting for a fusion run."""

    voxels: int = 0
    views: int = 0
    seconds: float = 0.0
    bytes_volume_traffic: int = 0
    # jax device_kind the run was timed on; None when it ran on no
    # accelerator, which has no roofline.
    device_kind: str | None = None
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None
        return self

    def add_fusion(self, num_cells: int, num_views: int, passes: int = 1):
        """Record one fused batch: `passes` = volume read+write sweeps."""
        self.voxels = num_cells
        self.views += num_views
        self.bytes_volume_traffic += passes * 2 * 4 * num_cells
        return self

    @property
    def voxel_updates_per_sec(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.voxels * self.views / self.seconds

    @property
    def views_per_sec(self) -> float:
        return self.views / self.seconds if self.seconds > 0 else 0.0

    @property
    def hbm_roofline_fraction(self) -> float | None:
        """Volume-traffic share of peak memory bandwidth (the fusion's
        min-traffic bound); None without a device kind."""
        if self.device_kind is None:
            return None
        if self.seconds <= 0:
            return 0.0
        peak = hbm_peak(self.device_kind)
        return (self.bytes_volume_traffic / self.seconds) / peak

    def report(self) -> dict:
        return {
            "device_kind": self.device_kind,
            "voxels": self.voxels,
            "views": self.views,
            "seconds": round(self.seconds, 6),
            "voxel_updates_per_sec": self.voxel_updates_per_sec,
            "views_per_sec": self.views_per_sec,
            "hbm_roofline_fraction": self.hbm_roofline_fraction,
        }

    def json(self) -> str:
        return json.dumps(self.report())
