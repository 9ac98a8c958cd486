"""int8 message-memory study: the BER cost and the throughput of int8 Q4.3
message state against bfloat16 and float32.

The port's counterpart of the JAX package's ``scripts/quantized_ber.py``.
Hardware LDPC decoders store messages in 6-8 bit fixed point; the fused
kernel's ``store_dtype="int8"`` reproduces that (Q4.3: step 1/8, saturating
at +-15.875).  Each store decodes the near-earth waterfall through the
staged cascade on the cuda engine (min-sum, 12 -> 50, capacity 3B/16), the
same LLRs at each point for every store, and records BER, FER, mean
iterations, Mbit/s and the decode's seconds: the best of ``TRIALS``
decodes of the point's LLRs, after an untimed first call at that point (as
``layered_ab`` warms each point), with the LLRs on the card before the
clock starts.  The JAX script timed one call a point.  The first call's
seconds, its cascade branches and the allocator segments it created are
recorded beside the trials' (``first_call``): that call is the one the
JAX script's protocol would have timed.

``adopt`` is the JAX script's ``adjudicate``: int8 may replace bfloat16
only if at every point its FER lies within the bf16 run's 95% Wilson
interval and its BER is at most 1.1x bf16's (zero where bf16's is zero),
and it is faster at 3.4 dB; ``ber_within_band`` and
``faster_at_operating_point`` are the two halves.  The float32 store is
recorded beside them and takes no part in the verdict.

Writes ``ldpc_tpu_torch/data/quantized_ber.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.quantized_ber [--words 32768]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.quantized_ber \\
        --code wifi --words 16 --max-iters 16 --snr 3.0 3.4 \\
        --out /tmp/quantized_ber
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..codes import near_earth_code, wifi_code
from ..sim.evaluate import make_staged_decoder_device, transmit
from ..sim.stats import wilson_interval
from .studies import artifact_base, stamp, study_device, sync, write_artifact

SEED = 411
PHASE1_ITERS = 12       # the cascade's first stage
TRIALS = 3              # timed decodes a point; the fastest is kept


def adjudicate(results: dict, snr_points, words: int) -> dict:
    """The JAX script's verdict, in place on ``results`` ({"stores":
    {store: [point, ...]}}): ``adopt``, and with both bf16 and int8 run,
    ``ber_within_band``, ``faster_at_operating_point`` and
    ``recommended``."""
    results["adopt"] = False
    if {"bfloat16", "int8"} <= set(results["stores"]):
        bf = results["stores"]["bfloat16"]
        i8 = results["stores"]["int8"]
        ok = True
        for pb, pi in zip(bf, i8):
            _, lo, hi = wilson_interval(round(pb["fer"] * words), words)
            ok &= lo <= pi["fer"] <= hi
            if pb["ber"] > 0:
                ok &= pi["ber"] <= 1.1 * pb["ber"]
            else:
                ok &= pi["ber"] == 0
        op = min(range(len(snr_points)),
                 key=lambda i: abs(snr_points[i] - 3.4))
        faster = i8[op]["mbit_s"] > bf[op]["mbit_s"]
        results["adopt"] = bool(ok and faster)
        results["ber_within_band"] = bool(ok)
        results["faster_at_operating_point"] = bool(faster)
        if results["adopt"]:
            results["recommended"] = {"store_dtype": "int8"}
    return results


def _segments(dev: torch.device) -> int:
    """The caching allocator's device allocations so far (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def _timed(dec, llr: torch.Tensor, dev: torch.device):
    """(seconds, (errors, iterations, success) on the CPU) of one decode,
    the copy back included."""
    sync(dev)
    t0 = time.perf_counter()
    out = tuple(x.cpu() for x in dec(llr))
    return time.perf_counter() - t0, out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=32768)
    ap.add_argument("--snr", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6])
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--stores", nargs="+",
                    default=["bfloat16", "float32", "int8"])
    ap.add_argument("--code", default="near-earth",
                    choices=["near-earth", "wifi"])
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/quantized_ber on the card)")
    args = ap.parse_args(argv)
    b = args.words

    dev = study_device()
    code = wifi_code() if args.code == "wifi" else near_earth_code()

    def llr_of(snr: float) -> torch.Tensor:
        """The point's LLRs: the same at each point for every store."""
        gen = torch.Generator(device=dev).manual_seed(
            SEED * 1000 + int(round(snr * 10)))
        return transmit(code.n, torch.full((b,), snr, dtype=torch.float32,
                                           device=dev), generator=gen)[0]

    results: dict = {"words": b, "max_iters": args.max_iters,
                     "code": args.code, "engine": "cuda",
                     "trials": TRIALS, **stamp(dev),
                     "stores": {}}
    for store in args.stores:
        dec = make_staged_decoder_device(
            code, args.max_iters,
            phase1_iters=[p for p in (PHASE1_ITERS,) if p < args.max_iters],
            redo_capacity=max(128, b * 3 // 16), engine="cuda",
            store_dtype=store, device=dev)
        dec(llr_of(args.snr[0]))                 # build
        pts = []
        for snr in args.snr:
            llr = llr_of(snr)
            segments = _segments(dev)
            first = _timed(dec, llr, dev)[0]
            first_call = {"s": first, "branches": list(dec.last_branches),
                          "new_segments": _segments(dev) - segments}
            trial_s = []
            for _ in range(TRIALS):
                dt, (errs, iters, ok) = _timed(dec, llr, dev)
                trial_s.append(dt)
            dt = min(trial_s)
            frames = int(((errs > 0) | ~ok).sum())
            _, lo, hi = wilson_interval(frames, b)
            pts.append({
                "snr_db": snr,
                "ber": float(errs.sum()) / (b * code.n),
                "fer": frames / b, "fer_ci95": [lo, hi],
                "avg_iters": float(iters.float().mean()),
                "mbit_s": b * code.n / dt / 1e6,
                "decode_s": dt, "trial_s": trial_s,
                "first_call": first_call,
            })
            print(f"[{store}] snr {snr}: BER {pts[-1]['ber']:.3e} "
                  f"FER {pts[-1]['fer']:.4f} {pts[-1]['mbit_s']:.0f} "
                  f"Mbit/s", flush=True)
        results["stores"][store] = pts

    adjudicate(results, args.snr, b)
    print(f"adopt={results['adopt']}", flush=True)
    md = ["# int8 fixed-point message memory vs floating storage", "",
          f"{args.code} (n={code.n}), min-sum, max {args.max_iters} "
          f"iterations, {b:,} words a point, the staged cascade "
          f"{PHASE1_ITERS} -> {args.max_iters} on the cuda engine, the same "
          f"LLRs at each point for every store, Mbit/s from the best of "
          f"{TRIALS} decodes after an untimed first call "
          f"(`ldpc_tpu_torch/scripts/quantized_ber.py`; "
          f"{results['device']}; kernel hash "
          f"`{results['kernel_hash'][:12]}`).  int8 = Q4.3 (step 1/8, "
          "saturating at +-15.875).", "",
          "| store | " + " | ".join(
              f"BER@{s} | FER@{s} | Mbit/s@{s}" for s in args.snr) + " |",
          "|---|" + "---|" * (3 * len(args.snr))]
    for store, pts in results["stores"].items():
        md.append(f"| {store} | " + " | ".join(
            f"{p['ber']:.2e} | {p['fer']:.4f} | {p['mbit_s']:.0f}"
            for p in pts) + " |")
    md += ["", "Each point's untimed first call against its best trial: "
           "ms, the cascade's redo branch, and the allocator segments the "
           "first call created.", "",
           "| store | " + " | ".join(
               f"first / best ms @{s} | branch, segments @{s}"
               for s in args.snr) + " |",
           "|---|" + "---|" * (2 * len(args.snr))]
    for store, pts in results["stores"].items():
        md.append(f"| {store} | " + " | ".join(
            f"{p['first_call']['s'] * 1e3:.1f} / {p['decode_s'] * 1e3:.1f}"
            f" | {','.join(p['first_call']['branches'])}, "
            f"{p['first_call']['new_segments']}" for p in pts) + " |")
    md += ["", f"adopt int8: {results['adopt']} (BER within bf16's band: "
           f"{results.get('ber_within_band')}, faster at 3.4 dB: "
           f"{results.get('faster_at_operating_point')})."]
    write_artifact(artifact_base("quantized_ber", args.out, dev), results,
                   md)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
