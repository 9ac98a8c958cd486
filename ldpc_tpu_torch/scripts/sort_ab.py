"""Same-process A/B: ``sort_words`` (the batch in order of difficulty)
against unsorted, on the main path's sweep.

The port's counterpart of the JAX package's ``scripts/sort_ab.py``.  On the
TPU a 128-word tile runs until all its words converge, so sorting by
difficulty let easy tiles exit early.  The fused kernel runs one block a
word, so there is no tile for a straggler to hold up: sorting changes only
the order of work (and adds a sort and a gather of the batch), and every
output must be bit-identical.  The protocol is the JAX script's: the
main path's step (transmit + staged cascade 12 -> 50 on the cuda engine,
bfloat16 state, redo capacity 3B/16), one process, word-exactness asserted
on a shared input before any timing (a mismatch exits non-zero), distinct
inputs per trial, the variants interleaved so drift cancels, best of
``--trials`` per point.  ``adopt`` is whether the 3.4 dB speedup reaches
``--adopt-threshold``; it only records the measurement: adopting sorting
is a benchmark's decision.

Writes ``ldpc_tpu_torch/data/sort_ab.{json,md}`` (or ``--out``), stamped
with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.sort_ab [--batch 32768] [--trials 4]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.sort_ab \\
        --batch 64 --mi 8 --phases 4 --code wifi --trials 1 --out /tmp/sort_ab
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..codes import near_earth_code, wifi_code
from ..sim.evaluate import make_staged_sweep_device
from .studies import artifact_base, stamp, study_device, sync, write_artifact


def _run(step, snr: float, batch: int, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = step(torch.full((batch,), snr, dtype=torch.float32, device=dev),
               generator=gen)
    return {k: v.cpu() for k, v in out.items()}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--mi", type=int, default=50)
    ap.add_argument("--phases", default="12")
    ap.add_argument("--snrs", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6])
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--code", default="near-earth",
                    choices=["near-earth", "wifi"])
    ap.add_argument("--adopt-threshold", type=float, default=1.02,
                    help="adopt when the 3.4 dB speedup reaches this")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/sort_ab on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    code = wifi_code() if args.code == "wifi" else near_earth_code()
    phases = [int(p) for p in args.phases.split(",") if int(p) < args.mi]
    caps = [max(128, args.batch * 3 // 16)] * len(phases)
    steps = {}
    for name, sort in (("unsorted", False), ("sorted", True)):
        t0 = time.perf_counter()
        steps[name] = make_staged_sweep_device(
            code, args.mi, phase1_iters=phases, redo_capacity=caps,
            engine="cuda", sort_words=sort, device=dev)
        out = _run(steps[name], args.snrs[0], args.batch, 1, dev)
        print(f"{name}: built+warm in {time.perf_counter() - t0:.1f} s "
              f"(nfail={int((~out['success']).sum())})", flush=True)

    # exactness gate: a shared input, every output identical
    snr_mid = args.snrs[len(args.snrs) // 2]
    ref = _run(steps["unsorted"], snr_mid, args.batch, 5, dev)
    got = _run(steps["sorted"], snr_mid, args.batch, 5, dev)
    exact = all(torch.equal(ref[k], got[k]) for k in ref)
    print(f"shared-input exactness: "
          f"{'WORD-EXACT' if exact else 'MISMATCH'}", flush=True)
    if not exact:
        print("ABORTING: sort_words must be bit-identical", flush=True)
        raise SystemExit(1)

    results = {}
    for snr in args.snrs:
        times: dict[str, list[float]] = {n: [] for n in steps}
        for t in range(args.trials):
            for n, step in steps.items():
                seed = (7919 * t + (1 if n == "sorted" else 0)) * 1000 + \
                    round(snr * 100)
                sync(dev)
                t0 = time.perf_counter()
                _run(step, snr, args.batch, seed, dev)
                times[n].append(time.perf_counter() - t0)
        b_u, b_s = min(times["unsorted"]), min(times["sorted"])
        results[str(snr)] = {
            "unsorted_s": b_u, "sorted_s": b_s, "speedup": b_u / b_s,
            "unsorted_bit_per_s": args.batch * code.n / b_u,
            "sorted_bit_per_s": args.batch * code.n / b_s,
        }
        print(f"@{snr}: unsorted {b_u * 1e3:8.1f} ms  sorted "
              f"{b_s * 1e3:8.1f} ms  speedup {b_u / b_s:.4f}x", flush=True)

    head = results.get("3.4") or results[str(snr_mid)]
    adopt = bool(head["speedup"] >= args.adopt_threshold)
    print(f"\nrecommendation: sort_words={'ADOPT' if adopt else 'no'} "
          f"(headline speedup {head['speedup']:.4f}x, threshold "
          f"{args.adopt_threshold}x)", flush=True)
    art = {"context": {"batch": args.batch, "mi": args.mi,
                       "phases": phases, "code": args.code,
                       "trials": args.trials, "engine": "cuda",
                       "redo_capacity": caps},
           **stamp(dev), "word_exact": exact, "points": results,
           "speedup_sorted_vs_unsorted": head["speedup"],
           "adopt_threshold": args.adopt_threshold, "adopt": adopt}
    md = ["# sort_words A/B", "",
          f"{args.code}, {args.batch:,} words a batch, staged {phases} -> "
          f"{args.mi} on the cuda engine (bfloat16), best of {args.trials} "
          f"trials, word-exact: {exact} "
          f"(`ldpc_tpu_torch/scripts/sort_ab.py`; {art['device']}; kernel "
          f"hash `{art['kernel_hash'][:12]}`).", "",
          "| SNR (dB) | unsorted ms | sorted ms | speedup |", "|---|---|---|---|"]
    md += [f"| {s} | {r['unsorted_s'] * 1e3:.2f} | {r['sorted_s'] * 1e3:.2f} "
           f"| {r['speedup']:.4f} |" for s, r in results.items()]
    md += ["", f"adopt (3.4 dB speedup >= {args.adopt_threshold}): {adopt}."]
    write_artifact(artifact_base("sort_ab", args.out, dev), art, md)
    return art


if __name__ == "__main__":
    main(sys.argv[1:])
