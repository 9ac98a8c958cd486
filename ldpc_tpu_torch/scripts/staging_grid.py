"""One-process grid over staged-decode cascades (2-stage against 3-stage).

The port's counterpart of the JAX package's ``scripts/staging_grid.py``.
The classic two-phase decode (stage 1 of 12 iterations, redo capacity
3B/16) against three-stage cascades: most words converge by 7-10
iterations at the operating point, so a short first stage and a
mid-budget second one let the easy majority exit early while only the
hard tail pays 50.  Each cascade is a ``StagedDecoder`` on the fused kernel
(``engine="cuda"``), B = 32,768 near-earth words at 3.4 dB, bf16 state,
50 iterations; no tuning artifact is adopted, so the kernel runs flooding
with no lever, as the JAX script's resolvers give.  Each configuration
gets one untimed call, then ``--trials`` timed calls on distinct LLRs
(best of them).  Every call's outputs (errors, iterations, success) are
compared with one straight 50-iteration decode of the same LLRs: latching
makes them equal, and the artifact records whether they are.

Writes ``ldpc_tpu_torch/data/staging_grid.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.staging_grid [--batch 32768] [--snr 3.4]

CPU smoke (the kernel's plain version)::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.staging_grid \\
        --code wifi --batch 64 --snr 2.0 --trials 1 --out /tmp/staging_grid
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.cuda_static import make_static_sweep_decoder
from ..sim.evaluate import StagedDecoder, transmit
from .studies import (artifact_base, resolve_code, stamp, study_device, sync,
                      write_artifact)


def configs(b: int) -> list[tuple[tuple, tuple]]:
    """(stage budgets, redo capacities in words) of each cascade: the JAX
    script's grid (``scripts/staging_grid.py:73-78``)."""
    return [
        ((12,), (b * 3 // 16,)),              # the tuned two-stage baseline
        ((6, 16), (b * 3 // 8, b // 8)),      # short head, mid tail
        ((8, 16), (b * 5 // 16, b // 8)),
        ((6, 12), (b * 3 // 8, b * 3 // 16)),
    ]


def _llr(code, b: int, snr: float, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return transmit(code.n, torch.full((b,), snr, dtype=torch.float32,
                                       device=dev), generator=gen)[0]


def _mismatched(got, want) -> int:
    """Words whose (errors, iterations, success) differ."""
    diff = torch.zeros_like(got[0], dtype=torch.bool)
    for g, w in zip(got, want):
        diff |= g != w
    return int(diff.sum())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--snr", type=float, default=3.4)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--store", default="bfloat16")
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--code", default="near-earth",
                    help="near-earth (the grid) or wifi (CPU smoke)")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/staging_grid on the card)")
    args = ap.parse_args(argv)
    b = args.batch

    dev = study_device()
    code = resolve_code(args.code)[0]
    straight = make_static_sweep_decoder(code, args.max_iters,
                                         store_dtype=args.store, device=dev)
    built = []
    for i, (phases, caps) in enumerate(configs(b)):
        dec = StagedDecoder(code, args.max_iters, phase1_iters=list(phases),
                            redo_capacity=list(caps), engine="cuda",
                            store_dtype=args.store, device=dev)
        llr = _llr(code, b, args.snr, hash(phases) % 2**31, dev)
        sync(dev)
        t0 = time.perf_counter()
        out = dec(llr)
        sync(dev)
        first_s = time.perf_counter() - t0
        bad = _mismatched(out, straight(llr))
        print(f"{phases}/{caps}: first call {first_s:.3f} s, branches "
              f"{dec.last_branches}, failures {int((~out[2]).sum())}, "
              f"mismatched {bad}", flush=True)
        built.append({"phases": list(phases), "caps": list(caps),
                      "capacities": dec.capacities(b),
                      "first_call_s": first_s,
                      "failures": int((~out[2]).sum()),
                      "mismatched_words": bad, "times_ms": [],
                      "branches": [dec.last_branches], "dec": dec})

    for t in range(args.trials):
        for i, cfg in enumerate(built):
            seed = int(np.random.SeedSequence([101 + t, i])
                       .generate_state(1, np.uint32)[0])
            llr = _llr(code, b, args.snr, seed, dev)
            sync(dev)
            t0 = time.perf_counter()
            out = cfg["dec"](llr)
            sync(dev)
            dt = time.perf_counter() - t0
            cfg["times_ms"].append(dt * 1e3)
            cfg["branches"].append(cfg["dec"].last_branches)
            cfg["mismatched_words"] += _mismatched(out, straight(llr))
            print(f"trial {t} cfg {tuple(cfg['phases'])}: {dt * 1e3:8.1f} "
                  "ms", flush=True)

    rows = []
    for cfg in built:
        cfg.pop("dec")
        best = min(cfg["times_ms"]) if cfg["times_ms"] else float("nan")
        words = b * (args.trials + 1)
        rows.append({**cfg, "best_ms": best,
                     "mbit_s": b * code.n / best / 1e3,
                     "words_checked": words,
                     "exact": cfg["mismatched_words"] == 0})
    res = {"batch": b, "snr_db": args.snr, "store": args.store,
           "max_iters": args.max_iters, "code": args.code,
           "trials": args.trials, **stamp(dev), "configs": rows,
           "all_exact": all(r["exact"] for r in rows)}
    md = [f"# Staged-decode cascades (B = {b:,}, {args.snr} dB, "
          f"{args.store}, {args.max_iters} iterations)", "",
          f"{args.code}; the fused kernel, flooding min-sum; one untimed "
          f"call, then the best of {args.trials} calls on distinct LLRs; "
          "every call's outputs compared with one straight decode of the "
          "same LLRs (`ldpc_tpu_torch/scripts/staging_grid.py`; "
          f"{res['device']}; kernel hash `{res['kernel_hash'][:12]}`).", "",
          "| stages | redo capacities | best ms | Mbit/s | first call s | "
          "words equal to a straight decode |", "|---|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['phases']} -> {args.max_iters} | {r['capacities']} "
                  f"| {r['best_ms']:.3f} | {r['mbit_s']:.1f} | "
                  f"{r['first_call_s']:.3f} | "
                  f"{r['words_checked'] - r['mismatched_words']:,} of "
                  f"{r['words_checked']:,} |")
    write_artifact(artifact_base("staging_grid", args.out, dev), res, md)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
