"""``ldpc_tpu_torch/utils/profiling.py`` on the CPU: the card's peaks (the
one source of ``chip_smoke.py``'s bounds), the measured roofline artifact,
the throughput timer, the timing helpers and the profiler trace."""

import json

import pytest
import torch

import chip_smoke
from ldpc_tpu_torch.utils import profiling
from ldpc_tpu_torch.utils.profiling import (ThroughputTimer, device_roofline,
                                            smem_bytes_per_s, time_ms,
                                            timed_once, trace)

torch.set_num_threads(1)


def test_h100_peaks_are_the_bounds_of_chip_smoke():
    assert profiling.HBM_BYTES_PER_S == 3.35e12
    assert profiling.F32_OPS_PER_S == 67e12
    assert profiling.HBM_BYTES == 80e9
    assert chip_smoke.HBM_BYTES_PER_S is profiling.HBM_BYTES_PER_S
    assert chip_smoke.F32_OPS_PER_S is profiling.F32_OPS_PER_S


def test_smem_bandwidth():
    assert smem_bytes_per_s(1.98e9) == pytest.approx(132 * 128 * 1.98e9)
    assert smem_bytes_per_s(1e9, sms=2) == pytest.approx(256e9)


def test_device_roofline_on_cpu():
    """No published peaks for the CPU; the measured artifact, when it
    exists, names the card and the power limit it was measured at."""
    r = device_roofline("cpu")
    assert r["device_kind"] == "cpu"
    assert "hbm_bytes_per_s" not in r and "f32_ops_per_s" not in r
    if profiling.ARTIFACT.exists():
        m = r["measured"]
        assert m == json.loads(profiling.ARTIFACT.read_text())
        assert "H100" in m["device"] and m["power_limit"].endswith("W")
        assert m["smi"] == f"{m['device']}, {m['power_limit']}"
        for name in ("abs_add_baseline", "recon_no_rot"):
            assert m[name] > 0 and m["fill"][name]["tiles"] > 1
        for store in ("bfloat16", "float32"):
            assert m[f"decoder_us_per_iter_{store}"] > 0
            assert m[f"decoder_us_per_iter_{store}_32768"] > 0
    else:
        assert "measured" not in r


def test_device_roofline_takes_the_h100_peaks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(profiling, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    r = device_roofline()
    assert r["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert r["hbm_bytes_per_s"] == 3.35e12 and r["sms"] == 132


def test_throughput_timer_on_cpu():
    t = ThroughputTimer("cpu")
    assert t.bits_per_second == 0.0
    for _ in range(3):
        with t.span(bits=1000):
            torch.ones(64).sum()
    s = t.summary()
    assert s["spans"] == 3 and s["total_bits"] == 3000
    assert s["total_seconds"] > 0 and s["device"] == "cpu"
    assert t.bits_per_second == pytest.approx(3000 / s["total_seconds"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof"), device="cpu"):
        torch.ones(256).cumsum(0)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert events["traceEvents"]


def test_device_roofline_raises_on_an_unreadable_artifact(monkeypatch,
                                                          tmp_path):
    """A corrupt artifact is an error naming its path; only a missing one
    means 'not measured'."""
    bad = tmp_path / "kernel_roofline.json"
    bad.write_text("{not json")
    monkeypatch.setattr(profiling, "ARTIFACT", bad)
    with pytest.raises(RuntimeError, match="kernel_roofline.json"):
        device_roofline("cpu")
    monkeypatch.setattr(profiling, "ARTIFACT", tmp_path / "missing.json")
    assert "measured" not in device_roofline("cpu")


def test_timed_once_and_time_ms_on_cpu():
    """The one event-timing helper of chip_smoke.py, kernel_ab.py and the
    probe script: the host clock on the CPU, the call's result kept."""
    calls = []

    def fn():
        calls.append(1)
        return torch.arange(4).sum()

    out, ms = timed_once(fn, "cpu")
    assert int(out) == 6 and ms >= 0 and len(calls) == 1
    assert time_ms(fn, "cpu", reps=3) >= 0
    assert len(calls) == 1 + 1 + 3        # one untimed call, three timed
