"""Same-process A/B of the fused kernel's scheduling variants: ``dep_stride``
and ``popcount_sign``.

The port's counterpart of the JAX package's ``scripts/sched_ab.py``: the
near-earth kernel's whole-batch decode time (16,384 words, 10 iterations,
3.4 dB, bfloat16 state) for each (stride, popcount) pair, the variants
interleaved across trials so drift cancels, distinct inputs a trial.

* ``dep_stride`` gates the Pallas kernel's unrolled rotation window behind
  a compiler barrier.  The CUDA kernel unrolls no rotations, so it has
  nothing to gate: a nonzero stride runs the barrier probe
  (``csrc/barrier_probe.cu``) and decodes as 0.  The preflight here runs
  the probe through its wrapper every run (the JAX script's
  ``_barrier_lowers`` preflight) and reports whether it keeps values
  exact.
* ``popcount_sign`` folds a check's sign product from the packed sign bits
  instead of the stored one (the kernel's popcount-sign instances).
* The JAX script's ``--tile-bs`` (the Pallas tile of codewords, a
  VMEM-scheduling lever) has no counterpart: the kernel runs one word a
  block.  It is dropped from the variant key, ``s<stride>_p<popcount>_
  <store>``.

Every variant must decode a shared input word-exact to the first; a
mismatch exits non-zero before any timing.  ``adopt`` is the JAX script's
rule: recommend the fastest word-exact bfloat16 variant if it is at least
2% faster than ``s0_p0`` and is not ``s0_p0`` itself.  Each run writes
its own entries (the JAX script merged runs of one kernel hash).

Writes ``ldpc_tpu_torch/data/sched_ab.{json,md}`` (or ``--out``), stamped
with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.sched_ab [--strides 0,4,8] \\
        [--popcounts 0,1] [--batch 16384] [--mi 10]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.sched_ab \\
        --code wifi --batch 16 --mi 4 --trials 1 --out /tmp/sched_ab
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..codes import near_earth_code, wifi_code
from ..ops.cuda_static import barrier_probe, make_static_sweep_decoder
from ..sim.channel import transmit_zero_codeword
from ..sim.stats import wilson_interval
from .studies import artifact_base, stamp, study_device, sync, write_artifact

DEFAULT_KEY = "s0_p0_bfloat16"


def entry_key(stride: int, popcount: bool, store: str) -> str:
    return f"s{stride}_p{int(popcount)}_{store}"


def adopt_verdict(entries: dict) -> dict:
    """The JAX script's verdict on ``entries`` ({key: {"dep_stride",
    "popcount_sign", "store", "best_ms", "exact"}}): ``adopt`` and, where
    the default ran, ``recommended``."""
    default = entries.get(DEFAULT_KEY)
    cands = [e for e in entries.values()
             if e["store"] == "bfloat16" and e["exact"]]
    out = {"adopt": False}
    if default and cands:
        best = min(cands, key=lambda e: e["best_ms"])
        speedup = default["best_ms"] / best["best_ms"]
        out["recommended"] = {"dep_stride": best["dep_stride"],
                              "popcount_sign": best["popcount_sign"],
                              "speedup_vs_default": round(speedup, 4)}
        out["adopt"] = bool(speedup >= 1.02 and (
            best["dep_stride"], best["popcount_sign"]) != (0, False))
    return out


def preflight(dev: torch.device) -> bool:
    """The barrier probe on an [8, 128] float32 array of linspace(-1, 1):
    whether its ``x + |x|`` is exact (the kernel on the card)."""
    x = torch.from_numpy(np.linspace(-1.0, 1.0, 8 * 128, dtype=np.float32)
                         .reshape(8, 128)).to(dev)
    return bool(torch.equal(barrier_probe(x).cpu(), (x + x.abs()).cpu()))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strides", default="0,4,8")
    ap.add_argument("--popcounts", default="0,1",
                    help="comma list of 0/1: fold the check's sign product "
                         "from the packed sign bits (bit-identical)")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--mi", type=int, default=10)
    ap.add_argument("--snr", type=float, default=3.4)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--store", default="bfloat16")
    ap.add_argument("--code", default="near-earth",
                    choices=["near-earth", "wifi"])
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/sched_ab on the card)")
    args = ap.parse_args(argv)
    strides = [int(s) for s in args.strides.split(",")]
    pops = [bool(int(p)) for p in args.popcounts.split(",")]
    variants = [(s, p) for p in pops for s in strides]

    dev = study_device()
    exact_probe = preflight(dev)
    print(f"preflight: barrier probe exact = {exact_probe}", flush=True)
    if not exact_probe:
        print("ABORTING: the barrier probe altered values", flush=True)
        raise SystemExit(1)
    code = wifi_code() if args.code == "wifi" else near_earth_code()

    def noisy(seed: int) -> torch.Tensor:
        return transmit_zero_codeword(
            args.batch, code.n, args.snr, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed))[0]

    decs = {}
    for s, p in variants:
        t0 = time.perf_counter()
        dec = make_static_sweep_decoder(code, args.mi, store_dtype=args.store,
                                        dep_stride=s, popcount_sign=p,
                                        device=dev)
        out = dec(noisy(1000 + s + 997 * p))
        print(f"stride {s} pop {p:d}: built+warm in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"nfail={int((~out[2]).sum())}", flush=True)
        decs[(s, p)] = dec

    # shared-input exactness: dep_stride is a scheduling barrier only, and
    # popcount-sign folds the same sign product from the same bits
    shared = noisy(5)
    ref = [x.cpu() for x in decs[variants[0]](shared)]
    exact = {variants[0]: True}
    for v in variants[1:]:
        out = [x.cpu() for x in decs[v](shared)]
        exact[v] = all(torch.equal(a, b) for a, b in zip(ref, out))
        print(f"stride {v[0]} pop {v[1]:d} vs {variants[0]}: "
              f"{'WORD-EXACT' if exact[v] else 'MISMATCH'}", flush=True)
    if not all(exact.values()):
        print("ABORTING: every variant must decode word-exact", flush=True)
        raise SystemExit(1)

    times = {v: [] for v in variants}
    fails = {v: [] for v in variants}
    for t in range(args.trials):
        for v in variants:
            s, p = v
            x = noisy(7919 * t + s + 997 * p + 1)
            sync(dev)
            t0 = time.perf_counter()
            out = decs[v](x)
            nfail = int((~out[2]).sum())
            times[v].append(time.perf_counter() - t0)
            fails[v].append(nfail)
            print(f"trial {t} stride {s} pop {p:d}: "
                  f"{times[v][-1] * 1e3:8.2f} ms  nfail={nfail}", flush=True)

    entries = {}
    for v in variants:
        s, p = v
        best = min(times[v])
        frames, words = sum(fails[v]), args.batch * args.trials
        _, lo, hi = wilson_interval(frames, words)
        entries[entry_key(s, p, args.store)] = {
            "dep_stride": s, "popcount_sign": p, "store": args.store,
            "best_ms": best * 1e3,
            "us_per_128w_iter": best / args.mi / max(1, args.batch // 128)
            * 1e6,
            "exact": exact[v], "trials": args.trials, "nfail": fails[v],
            "fer": frames / words, "fer_ci95": [lo, hi],
        }
    art = {"context": {"batch": args.batch, "mi": args.mi, "snr": args.snr,
                       "code": args.code},
           **stamp(dev), "barrier_probe_exact": exact_probe,
           "entries": entries, **adopt_verdict(entries)}
    base_ms = entries[entry_key(*variants[0], args.store)]["best_ms"]
    md = ["# Kernel scheduling variants: dep_stride x popcount_sign", "",
          f"{args.code}, {args.batch:,} words, {args.mi} iterations, "
          f"{args.snr} dB, {args.store} state, best of {args.trials} trials, "
          f"every variant word-exact (`ldpc_tpu_torch/scripts/sched_ab.py`; "
          f"{art['device']}; kernel hash `{art['kernel_hash'][:12]}`).", "",
          "| variant | best ms | us per 128 words an iteration | vs first "
          "| FER |", "|---|---|---|---|---|"]
    for k, e in entries.items():
        md.append(f"| {k} | {e['best_ms']:.3f} | "
                  f"{e['us_per_128w_iter']:.3f} | "
                  f"{e['best_ms'] / base_ms:.4f} | {e['fer']:.4f} |")
    md += ["", f"adopt: {art['adopt']}" + (
        f" (recommended {art['recommended']})" if art.get("recommended")
        else "") + "."]
    write_artifact(artifact_base("sched_ab", args.out, dev), art, md)
    return art


if __name__ == "__main__":
    main(sys.argv[1:])
