#!/usr/bin/env python3
"""Time the decode kernel of several checkouts of the port on one card, in
turn, on the same LLRs.

    python3 kernel_ab.py ROOT [ROOT ...]

Each ROOT is a directory that holds an ``ldpc_tpu_torch`` package (``.``
for this checkout) that has ``utils/profiling.time_ms``.  Each root runs in
a process of its own, in the order given (give A B B A to see drift over
the call).  It builds the kernel, then times each case with that root's
``time_ms``: the median of REPS calls, each timed alone with CUDA events
behind an untimed call.  The cases are the near-earth stage-1 shapes that
chip_smoke.py drives: 32,768 words at 3.4 dB; min-sum bf16 flooding at 12
iterations, with the stored sign and with popcount_sign; layered bf16 at 6
sweeps, with both signs; int8 flooding at 12 iterations; and the
phase-split pair (``ops/cuda_split.py``) at 12 iterations in bf16 and f32.
Then the 802.11n rate-5/6 cases of the evaluate path's first stage (32,768
words, 12 iterations): sum-product with f32 and bf16 state at 2.5 dB on
true LLRs (2y/sigma^2), and layered int8 at 3.0 dB (the CLI's
``evaluate --code wifi --schedule layered --store-dtype int8``).
Then the layered bf16 kernel's cost a sweep apart from convergence: the
slope (t(40) - t(10)) / 30 of its decode of 0 dB words, where nothing
converges, at 128 and 32,768 words.  Then each split kernel alone, one
launch of split_r (iteration 0) and of split_c on the stage-1 words' state
before iteration 0, bf16 and f32; and the giant path, the split decode of
4,096 words of ``synthetic_qc_code(2048, 8, 24)`` at 4.0 dB, 8 iterations,
bf16.  It prints one JSON line per root.  The line holds the build's
seconds, the registers ptxas gave each kernel instance, each case's ms, a
hash of each case's outputs (the same across roots when their decodes
agree), the slopes in microseconds a sweep, the split kernels' ms alone
and the giant path's ms, bit/s and hash.  It needs one card; it exits
non-zero without one.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys

BATCH = 32768
SNR_DB = 3.4
SEED = 20261017
REPS = 15
# (name, options of the decoder, iterations); "split" names the phase-split
# decoder, the rest the fused kernel's make_static_sweep_decoder
CASES = (("flooding[min-sum,bfloat16]", {}, 12),
         ("flooding[min-sum,bfloat16,popcount]", {"popcount_sign": True}, 12),
         ("layered[min-sum,bfloat16]", {"schedule": "layered"}, 6),
         ("layered[min-sum,bfloat16,popcount]",
          {"schedule": "layered", "popcount_sign": True}, 6),
         ("flooding[min-sum,int8]", {"store_dtype": "int8"}, 12),
         ("split[min-sum,bfloat16]", {"store_dtype": "bfloat16"}, 12),
         ("split[min-sum,float32]", {"store_dtype": "float32"}, 12))
# (name, options, iterations, SNR dB, true LLRs) on 802.11n rate 5/6
WIFI_CASES = (("flooding[sum-product,float32]",
               {"kind": "sum-product", "store_dtype": "float32"}, 12, 2.5,
               True),
              ("flooding[sum-product,bfloat16]",
               {"kind": "sum-product", "store_dtype": "bfloat16"}, 12, 2.5,
               True),
              ("layered[min-sum,int8]",
               {"schedule": "layered", "store_dtype": "int8"}, 12, 3.0,
               False))
SLOPE_SWEEPS = (10, 40)
SLOPE_WORDS = (128, 32768)
SPLIT_ITERS = 12
GIANT = dict(z=2048, block_rows=8, block_cols=24, words=4096, snr=4.0,
             iters=8)


def _short(demangled: str) -> str:
    """``decode_kernel<...>`` of ``void (ns)::decode_kernel<...>(Args)``."""
    m = re.search(r"(\w+<.*>)\(", demangled)
    return m.group(1) if m else demangled.strip()


def registers(ptxas: str) -> dict[str, int]:
    """Registers a thread of each kernel instance in a ``-Xptxas -v`` log,
    by demangled name (template arguments kept, parameters dropped)."""
    regs, entry = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and regs:
        names = subprocess.run([filt], input="\n".join(regs), text=True,
                               capture_output=True, check=True).stdout
        regs = {_short(d): r for d, r in zip(names.splitlines(),
                                            regs.values())}
    return regs


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from ldpc_tpu_torch.codes import (near_earth_code, synthetic_qc_code,
                                      wifi_code)
    from ldpc_tpu_torch.csrc import build, build_report
    from ldpc_tpu_torch.ops import cuda_split
    from ldpc_tpu_torch.ops.cuda_split import make_split_sweep_decoder
    from ldpc_tpu_torch.ops.cuda_static import make_static_sweep_decoder
    from ldpc_tpu_torch.ops.plan import DecodePlan
    from ldpc_tpu_torch.sim.evaluate import transmit
    from ldpc_tpu_torch.utils.profiling import time_ms

    dev = torch.device("cuda", 0)
    build("decode", "split")
    rep = build_report("decode")
    code = near_earth_code()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    snr = torch.full((BATCH,), SNR_DB, dtype=torch.float32, device=dev)
    llr = transmit(code.n, snr, generator=gen)[0]
    out = {"root": root, "build_s": rep["seconds"],
           "registers": {**registers(rep["ptxas"]),
                         **registers(build_report("split")["ptxas"])},
           "cases": {}}
    for name, opts, iters in CASES:
        make = (make_split_sweep_decoder if name.startswith("split")
                else make_static_sweep_decoder)
        dec = make(code, iters, device=dev, **opts)
        out["cases"][name] = {"ms": time_ms(lambda: dec(llr), dev, REPS),
                              "iterations": iters,
                              "outputs": _digest(dec(llr))}
    wifi = wifi_code(1944, 5 / 6)
    for name, opts, iters, snr_db, scale in WIFI_CASES:
        snr_w = torch.full((BATCH,), snr_db, dtype=torch.float32, device=dev)
        llr_w = transmit(wifi.n, snr_w, generator=gen, scale_llr=scale)[0]
        dec = make_static_sweep_decoder(wifi, iters, device=dev, **opts)
        out["cases"][f"wifi5/6 {name}"] = {
            "ms": time_ms(lambda: dec(llr_w), dev, REPS),
            "iterations": iters, "snr_db": snr_db,
            "outputs": _digest(dec(llr_w))}
    del llr_w
    out["layered_us_per_sweep"] = {}
    lo, hi = SLOPE_SWEEPS
    for words in SLOPE_WORDS:
        zero = torch.zeros(words, dtype=torch.float32, device=dev)
        llr0 = transmit(code.n, zero, generator=gen)[0]
        ms = {}
        for sweeps in SLOPE_SWEEPS:
            dec = make_static_sweep_decoder(code, sweeps, schedule="layered",
                                            device=dev)
            ms[sweeps] = time_ms(lambda: dec(llr0), dev, REPS)
        out["layered_us_per_sweep"][words] = ((ms[hi] - ms[lo]) /
                                              (hi - lo) * 1e3)
    # each split kernel alone, on the state before iteration 0
    plan = DecodePlan.from_code(code)
    out["split_alone_ms"] = {}
    for store in ("bfloat16", "float32"):
        if hasattr(cuda_split, "split_tables"):
            tab = cuda_split.split_tables(plan, store)
        else:   # a revision before split_tables: the fused kernel's tables
            from ldpc_tpu_torch.ops.cuda_static import kernel_tables
            tab = kernel_tables(plan)
        tables = torch.as_tensor(tab, device=dev)
        st = cuda_split.SplitState.start(llr, plan, SPLIT_ITERS, store)
        n_ok = torch.zeros(SPLIT_ITERS + 1, dtype=torch.int32, device=dev)
        out["split_alone_ms"][store] = {
            "split_r": time_ms(lambda: cuda_split.launch(
                "r", st, plan, tables, n_ok, 0), dev, REPS),
            "split_c": time_ms(lambda: cuda_split.launch(
                "c", st, plan, tables, n_ok), dev, REPS)}
    del llr, st
    giant = synthetic_qc_code(GIANT["z"], GIANT["block_rows"],
                              GIANT["block_cols"])
    dec = make_split_sweep_decoder(giant, GIANT["iters"], device=dev)
    snr = torch.full((GIANT["words"],), GIANT["snr"], dtype=torch.float32,
                     device=dev)
    llr = transmit(giant.n, snr, generator=gen)[0]
    ms = time_ms(lambda: dec(llr), dev, REPS)
    out["giant"] = {"ms": ms, "bit_per_s": GIANT["words"] * giant.n / ms * 1e3,
                    "outputs": _digest(dec(llr))}
    return out


def _digest(res) -> str:
    """A hash of a decode's outputs."""
    return hashlib.sha256(b"".join(
        x.cpu().numpy().tobytes() for x in res)).hexdigest()[:16]


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print("kernel_ab: needs a CUDA card and at least one ROOT",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        rc = subprocess.run([sys.executable, __file__, "--child", root],
                            timeout=900).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
