#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds; any failure exits non-zero with
no result line:

1. card    the card's name and power limit (nvidia-smi) and torch's view.
2. build   nvcc builds ldpc_tpu_torch/csrc/minsum_flooding.cu (ptxas report).
3. kernel  the CUDA kernel against its plain PyTorch version on the same
           LLRs: 2,048 words at 3.0 and 3.4 dB (50 iterations) and the main
           path's own shapes (32,768 words at 12 and at 50 iterations).
           Converged words must agree exactly; times with CUDA events.  The
           staged cascade must equal a straight 50-iteration decode.
4. main    near-earth (8176, 7154), B = 32,768, 3.0/3.2/3.4/3.6 dB, the
           12 -> 50 staged cascade, one warm and three timed batches a point:
           decoded bit/s, BER, FER, iterations, cascade branch, launches.
5. band    FER at 3.0 and 3.4 dB: the 95% Wilson interval must overlap the
           JAX package's measured one.
6. profile one more batch at 3.0 and 3.4 dB under torch.profiler: device
           time by kernel, device busy share.
7. the kernels line, the card line again, and the result line.

Imports torch, numpy and ldpc_tpu_torch only; the machine with the card has
no JAX.  Writes nothing but the kernel build (ldpc_tpu_torch/_build/).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from ldpc_tpu_torch.codes import near_earth_code
from ldpc_tpu_torch.ops import cuda_static
from ldpc_tpu_torch.ops.cuda_static import (make_static_sweep_decoder,
                                            minsum_flooding_reference)
from ldpc_tpu_torch.sim.evaluate import (make_staged_decoder_device,
                                         make_staged_sweep_device, transmit)
from ldpc_tpu_torch.sim.stats import BerStatistics, wilson_interval
from ldpc_tpu_torch.utils.device import device_info

T0 = time.perf_counter()

# The main path: the JAX package's bench protocol (bench.py).
BATCH = 32768
SNR_POINTS = (3.0, 3.2, 3.4, 3.6)
MAX_ITERS = 50
PHASE1_ITERS = 12
TIMED_BATCHES = 3
CHECK_WORDS = 2048
CHECK_SNRS = (3.0, 3.4)
PROFILE_SNRS = (3.0, 3.4)
SEED = 20261017
BUDGET_S = 600          # half the 1200 s limit of a chip run

# FER and 95% Wilson interval of the JAX package's Pallas bf16 kernel,
# docs/ber_parity.json (16,384 words per point), points "3.0000", "3.4000".
JAX_FER = {3.0: (0.86767578125, 0.8624009517018465, 0.8727782313822761),
           3.4: (0.02288818359375, 0.02070762656167772, 0.025292427527202416)}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor op/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per Tanner edge: phase A 8 (old c2v: select, sign;
# v = t - c2v; |v|; two-min compare, m2 min, m1 min; sign test), phase B 3
# (select, sign, add).
OPS_A, OPS_B = 8, 3

TPU_KERNEL = "ldpc_tpu/ops/pallas_static.py::_build_kernel"
TPU_CALL = "ldpc_tpu/ops/pallas_static.py:170"


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {phase}: {msg}", flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev: torch.device, reps: int = 1, warm: bool = True) -> float:
    """Milliseconds per call (after one warm-up call unless the caller has
    just made one): CUDA events on the card."""
    if warm:
        fn()
    sync(dev)
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def llr_batch(b: int, snr: float, gen: torch.Generator, dev) -> torch.Tensor:
    snr_db = torch.full((b,), snr, dtype=torch.float32, device=dev)
    return transmit(near_earth_code().n, snr_db, generator=gen)[0]


def bound_ms(b: int, n: int, edges: int, iters, success,
             max_iters: int) -> tuple[float, str]:
    """Least time for this work on an H100: bytes (LLRs in, 12 B a word out)
    over HBM rate vs the f32 operations these words needed over peak."""
    it = iters.long().cpu()
    phase_a = torch.where(success.cpu(), it + 1, torch.full_like(it, max_iters + 1))
    ops = edges * (OPS_A * phase_a.sum().item() + OPS_B * (phase_a - 1).sum().item())
    t_bytes = (b * n * 4 + b * 12) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(kern, plain) -> dict:
    """Kernel vs plain outputs: mismatched converged words (either side
    converged), mismatched words overall, max |difference|."""
    (ek, ik, sk), (ep, ip, sp) = kern, plain
    diff = (ek != ep) | (ik != ip) | (sk != sp)
    conv = sk | sp
    err = max(int((ek.long() - ep.long()).abs().max()),
              int((ik.long() - ip.long()).abs().max()),
              int((sk.long() - sp.long()).abs().max()))
    return {"mismatched_converged": int((diff & conv).sum()),
            "mismatched": int(diff.sum()), "max_abs_err": err}


def phase_card(dev) -> str:
    smi = smi_line()
    print(smi, flush=True)
    info = device_info()
    log("card", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; {info['name']} {info['capability']}, "
        f"{info['count']} visible")
    return smi


def phase_build() -> dict:
    from ldpc_tpu_torch.csrc import build, build_report
    build("minsum_flooding")
    rep = build_report("minsum_flooding")
    log("build", f"minsum_flooding.cu built in {rep['seconds']:.1f} s "
        f"(cached: {rep['cached']})")
    for line in rep["ptxas"].splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "bytes stack")):
            log("build", "ptxas " + line.strip())
    return rep


def phase_kernel(dev, code, gen) -> dict:
    plan = make_static_sweep_decoder(code, MAX_ITERS, device=dev).plan
    edges = code.num_edges
    worst = {"mismatched_converged": 0, "mismatched": 0, "max_abs_err": 0}
    cases = [(f"{CHECK_WORDS} words {snr} dB {MAX_ITERS} it", CHECK_WORDS,
              snr, MAX_ITERS) for snr in CHECK_SNRS]
    cases += [(f"{BATCH} words 3.4 dB {PHASE1_ITERS} it (stage 1)", BATCH,
               3.4, PHASE1_ITERS),
              (f"{BATCH} words 3.0 dB {MAX_ITERS} it (stage 2, many)", BATCH,
               3.0, MAX_ITERS)]
    timing = {}
    for label, b, snr, max_iters in cases:
        llr = llr_batch(b, snr, gen, dev)
        dec = make_static_sweep_decoder(code, max_iters, device=dev)
        kern = dec(llr)
        plain = minsum_flooding_reference(llr, plan, max_iters)
        sync(dev)
        c = compare(kern, plain)
        for k in worst:
            worst[k] = max(worst[k], c[k])
        log("kernel", f"{label}: {c['mismatched_converged']} mismatched "
            f"converged words, {c['mismatched']} mismatched in all, "
            f"converged {int(kern[2].sum())}/{b}")
        if c["mismatched_converged"]:
            raise AssertionError(f"{label}: kernel and plain version differ "
                                 f"on {c['mismatched_converged']} converged "
                                 "words")
        if b == BATCH:
            ms = time_ms(lambda: dec(llr), dev, reps=3)
            plain_ms = time_ms(
                lambda: minsum_flooding_reference(llr, plan, max_iters), dev,
                warm=False)
            bnd, by = bound_ms(b, code.n, edges, kern[1], kern[2], max_iters)
            timing[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                             "bound_by": by}
            log("kernel", f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.1f}"
                f" ms, bound {bnd:.3f} ms ({by})")
    # the cascade equals a straight max_iters decode, word for word
    staged = make_staged_decoder_device(code, MAX_ITERS,
                                        phase1_iters=PHASE1_ITERS,
                                        redo_capacity=CHECK_WORDS * 3 // 16,
                                        device=dev)
    single = make_static_sweep_decoder(code, MAX_ITERS, device=dev)
    for snr in CHECK_SNRS:
        llr = llr_batch(CHECK_WORDS, snr, gen, dev)
        got, want = staged(llr), single(llr)
        if any(not torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"staged cascade != single pass at {snr} dB")
        log("kernel", f"staged == single pass at {snr} dB "
            f"(branch {staged.last_branches})")
    stage1 = timing[cases[2][0]]
    return {"worst": worst, "timing": timing, "stage1": stage1}


def phase_main(dev, code, gen) -> dict:
    step = make_staged_sweep_device(code, MAX_ITERS, phase1_iters=PHASE1_ITERS,
                                    device=dev, generator=gen)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stats = BerStatistics(code.n)
    points = {}
    cuda_static.launches = 0
    for snr in SNR_POINTS:
        before = cuda_static.launches
        snr_db = torch.full((BATCH,), snr, dtype=torch.float32, device=dev)
        outs, secs, branches = [], [], []
        for t in range(1 + TIMED_BATCHES):
            t0 = time.perf_counter()
            out = step(snr_db)
            sync(dev)
            if t:
                secs.append(time.perf_counter() - t0)
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
            branches.append(step.decoder.last_branches[0])
        for o in outs:
            check_outputs(o, code.n)
            stats.add_batch(np.full(BATCH, snr), o["sigma"], o["sigma_actual"],
                            o["errors_uncoded"], o["errors_decoded"],
                            o["iterations"], MAX_ITERS, o["success"])
        med = float(np.median(secs))
        words = BATCH * len(outs)
        fe = sum(int(((o["errors_decoded"] > 0) | ~o["success"]).sum())
                 for o in outs)
        errs = sum(int(o["errors_decoded"].sum()) for o in outs)
        iters = sum(int(o["iterations"].sum()) for o in outs)
        points[snr] = {"bit_per_s": BATCH * code.n / med, "median_s": med,
                       "ber": errs / (words * code.n), "fer": fe / words,
                       "frame_errors": fe, "words": words,
                       "avg_iterations": iters / words,
                       "branches": branches,
                       "launches": cuda_static.launches - before}
        p = points[snr]
        log("main", f"{snr} dB: {p['bit_per_s']:.6g} bit/s (median "
            f"{med * 1e3:.2f} ms of {TIMED_BATCHES}), BER {p['ber']:.4e}, "
            f"FER {p['fer']:.5f}, avg iters {p['avg_iterations']:.3f}, "
            f"branch {branches}, launches {p['launches']}")
    launches = cuda_static.launches
    if launches == 0 or any(p["launches"] == 0 for p in points.values()):
        raise AssertionError(f"main path launched the kernel {launches} "
                             "times; a point ran without it")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log("main", f"kernel launches {launches}; "
        f"max_memory_allocated {peak} bytes")
    return {"points": points, "launches": launches, "stats": stats,
            "max_memory_allocated": peak, "step": step}


def phase_profile(dev, step) -> None:
    """One more batch at 3.0 and 3.4 dB under torch.profiler: device time
    by kernel and the device's busy share of the batch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for snr in PROFILE_SNRS:
        snr_db = torch.full((BATCH,), snr, dtype=torch.float32, device=dev)
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(snr_db)
            sync(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                row = by_name.setdefault(e.name, [0, 0.0])
                row[0] += 1
                row[1] += e.time_range.elapsed_us()
        if not by_name:
            log("profile", f"{snr} dB: the profiler saw no device events; "
                "device time not measured")
            continue
        busy = sum(t for _, t in by_name.values())
        log("profile", f"{snr} dB: batch {wall_us / 1e3:.2f} ms wall under "
            f"the profiler, device busy {busy / 1e3:.2f} ms "
            f"({100 * busy / wall_us:.1f}%)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (count, t) in top:
            log("profile", f"{snr} dB:   {t / 1e3:9.3f} ms  {count:3d}x  "
                f"{name[:90]}")


def check_outputs(o: dict, n: int) -> None:
    for k, v in o.items():
        if v.shape != (BATCH,):
            raise AssertionError(f"{k}: shape {v.shape}")
    if not (np.isfinite(o["sigma"]).all() and np.isfinite(o["sigma_actual"]).all()):
        raise AssertionError("non-finite sigma")
    if not ((0 <= o["iterations"]).all() and (o["iterations"] <= MAX_ITERS).all()):
        raise AssertionError("iterations out of range")
    if not ((0 <= o["errors_decoded"]).all() and (o["errors_decoded"] <= n).all()):
        raise AssertionError("errors out of range")


def phase_band(points: dict) -> None:
    for snr, (fer, lo, hi) in JAX_FER.items():
        p = points[snr]
        q, qlo, qhi = wilson_interval(p["frame_errors"], p["words"])
        overlap = qlo <= hi and lo <= qhi
        log("band", f"{snr} dB: port FER {q:.5f} [{qlo:.5f}, {qhi:.5f}] "
            f"({p['words']} words) vs JAX {fer:.5f} [{lo:.5f}, {hi:.5f}]: "
            f"{'overlap' if overlap else 'NO OVERLAP'}")
        if not overlap:
            raise AssertionError(f"FER at {snr} dB outside the JAX band")


def run(dev: torch.device) -> dict:
    code = near_earth_code()
    smi = phase_card(dev) if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        phase_build()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kern = phase_kernel(dev, code, gen)
    main = phase_main(dev, code, gen)
    phase_band(main["points"])
    phase_profile(dev, main["step"])
    st = kern["stage1"]
    kernels = {"kernels": [{
        "name": "minsum_flooding", "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/minsum_flooding.cu",
        "replaces": TPU_CALL, "tpu_kernel": TPU_KERNEL,
        "launches": main["launches"],
        "max_abs_err": kern["worst"]["max_abs_err"],
        "mismatched_words": kern["worst"]["mismatched_converged"],
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None,
        "shape": f"{BATCH} words x {code.n}, {PHASE1_ITERS} iterations, "
                 "3.4 dB",
    }]}
    print(json.dumps(kernels), flush=True)
    return {"smi": smi, "kernels": kernels, "main": main}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and does not run on the CPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        run(dev)
        elapsed = time.perf_counter() - T0
        log("done", f"{elapsed:.1f} s in all (budget {BUDGET_S} s)")
        if elapsed > BUDGET_S:
            raise AssertionError(f"took {elapsed:.0f} s, over {BUDGET_S} s")
        print(smi_line(), flush=True)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
