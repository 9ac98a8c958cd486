"""Profiling and throughput instrumentation for the card.

The counterpart of ``ldpc_tpu/utils/profiling.py``:

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace of the host and (on the card) the device to
  ``logdir/trace.json``;
* ``ThroughputTimer``: wall-clock spans that end in
  ``torch.cuda.synchronize`` on a CUDA device, accumulating decoded bit/s
  (PyTorch returns before the card finishes, so an unsynchronised span
  times the enqueue);
* ``timed_once`` and ``time_ms``: one call, or the median of several,
  timed with CUDA events on the card (the host clock on the CPU);
* ``device_roofline``: the card's published peaks for speed-of-light
  comparisons, plus the measured per-primitive costs of
  ``data/kernel_roofline.json`` when it exists (written by
  ``python -m ldpc_tpu_torch.scripts.kernel_microbench --out``).

The peaks below are the one source of the bounds that ``chip_smoke.py``
reports.  No TPU number is kept here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import time

import numpy as np
import torch

from .device import resolve_device

__all__ = ["trace", "ThroughputTimer", "timed_once", "time_ms",
           "device_roofline", "smi_query",
           "smem_bytes_per_s", "HBM_BYTES_PER_S", "F32_OPS_PER_S",
           "HBM_BYTES", "SMEM_BYTES_PER_CLOCK", "ARTIFACT"]

# NVIDIA H100 SXM, NVIDIA's data sheet, at the full 700 W power limit:
# HBM3 bytes/s, float32 operations/s outside the tensor cores, HBM bytes,
# SMs, and the shared-memory bytes an SM serves a clock (Hopper white
# paper: 32 banks of 4 bytes)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
HBM_BYTES = 80e9
SMS = 132
SMEM_BYTES_PER_CLOCK = 128
_PEAKS = {"H100": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                   "f32_ops_per_s": F32_OPS_PER_S, "hbm_bytes": HBM_BYTES,
                   "sms": SMS,
                   "smem_bytes_per_clock_per_sm": SMEM_BYTES_PER_CLOCK}}

ARTIFACT = pathlib.Path(__file__).resolve().parent.parent / "data" / \
    "kernel_roofline.json"


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block: ``with trace('prof'): step()`` writes
    ``prof/trace.json``; on a CUDA device (the default: the card) the
    device's kernels too."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclasses.dataclass
class ThroughputTimer:
    """Accumulating throughput meter.

    >>> t = ThroughputTimer(device)
    >>> with t.span(bits=batch * n):
    ...     out = step(...)
    >>> t.bits_per_second
    """

    device: torch.device | str | None = None
    total_seconds: float = 0.0
    total_bits: float = 0.0
    spans: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, bits: float):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.total_seconds += time.perf_counter() - t0
        self.total_bits += bits
        self.spans += 1

    @property
    def bits_per_second(self) -> float:
        return self.total_bits / self.total_seconds if self.total_seconds \
            else 0.0

    def summary(self) -> dict:
        return {"bits_per_second": self.bits_per_second,
                "total_seconds": self.total_seconds,
                "total_bits": self.total_bits, "spans": self.spans,
                "device": str(self.device)}


def timed_once(fn, device):
    """``(fn(), milliseconds)`` of one call: CUDA events on the card, the
    host clock on the CPU; the device is idle when the call starts."""
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(stop)


def time_ms(fn, device, reps: int = 1) -> float:
    """Median milliseconds of ``reps`` calls, each timed alone with CUDA
    events on the card.  An untimed call queued ahead of each keeps the
    card busy while the host launches the timed one, so the host's cost of
    a launch is not counted."""
    dev = torch.device(device)
    if dev.type != "cuda":
        fn()
        return float(np.median([timed_once(fn, dev)[1] for _ in range(reps)]))
    times = []
    for _ in range(reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def smi_query(*fields: str) -> list[str]:
    """One ``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` value
    per field, for the first card; raises where ``nvidia-smi`` fails."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return [v.strip() for v in out.split(",")]


def smem_bytes_per_s(sm_clock_hz: float, sms: int = SMS) -> float:
    """The card's shared-memory bandwidth: SMs x 128 bytes a clock x the SM
    clock (pass ``clocks.max.sm`` in Hz)."""
    return sms * SMEM_BYTES_PER_CLOCK * sm_clock_hz


def device_roofline(device=None) -> dict:
    """The published peaks of the device's kind (an H100; none for another
    kind or the CPU) and, when ``data/kernel_roofline.json`` exists, the
    card's measured primitive costs under ``"measured"`` (each stamped with
    the card's name and power limit it was measured on); an artifact that
    cannot be read or parsed raises, with its path."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out: dict = {"device_kind": kind}
    for name, peaks in _PEAKS.items():
        if name in kind:
            out.update(peaks)
            break
    if ARTIFACT.exists():
        try:
            out["measured"] = json.loads(ARTIFACT.read_text())
        except (OSError, ValueError) as e:
            raise RuntimeError(f"cannot read the measured roofline "
                               f"{ARTIFACT}: {e}") from e
    return out
