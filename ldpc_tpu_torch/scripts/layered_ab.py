"""Layered-vs-flooding schedule A/B under the full bench protocol.

The port's counterpart of the JAX package's ``scripts/layered_ab.py``.  The
fused kernel's layered schedule updates the variable totals right after
each block row, so later rows see fresh messages within the same sweep —
the standard production-decoder schedule, converging in roughly half the
sweeps of flooding at equal or better BER (opt-in, because the reference's
decoders are all flooding, ldpc.py:288-324).

This measures what that is worth end to end at the bench protocol
(near-earth, min-sum, bfloat16 state, max 50 iterations, transmit + staged
cascade on the cuda engine, 32,768 words, Eb/N0 3.0-3.6 dB): the flooding
baseline at its 12 -> 50 staging (capacity 3B/16) against layered cascades
with proportionally shorter stage-1 budgets.  Trials interleave the
variants so drift cancels; each trial draws distinct inputs, the same for
every variant (a paired comparison: statistics from trial 0), and each
point has an untimed warm pass first.  Times are best of ``--trials``,
transmit and the read of the outputs included.

``adopt`` is the JAX script's rule: a layered variant is recommended iff it
is faster at 3.4 dB and its FER is at or below the flooding run's 95%
upper band at every point.  The artifact only records the verdict: no
bench of the port reads it.

Writes ``ldpc_tpu_torch/data/layered_ab.{json,md}`` (or ``--out``), stamped
with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.layered_ab [--batch 32768] [--trials 3]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.layered_ab \\
        --code wifi --batch 16 --trials 1 --max-iters 12 --out /tmp/layered_ab
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..codes import near_earth_code, wifi_code
from ..sim.evaluate import make_staged_sweep_device
from ..sim.stats import wilson_interval
from .studies import artifact_base, stamp, study_device, sync, write_artifact

SEED = 7134066
# (schedule, stage-1 budgets at max_iters = 50, capacities in 16ths of the
# batch): the JAX script's variants
VARIANTS = [("flooding", (12,), (3,)),      # the tuned baseline
            ("layered", (6,), (3,)),        # ~2x faster convergence
            ("layered", (4, 12), (6, 2))]   # short head + mid tail


def scale(fracs, max_iters: int) -> tuple:
    """Stage budgets as fractions of max_iters = 50, so a smoke run with
    fewer iterations exercises the same flow."""
    return tuple(max(1, min(max_iters - 1, round(f * max_iters / 50)))
                 for f in fracs)


def adopt_verdict(results: dict, snrs, baseline: str) -> dict:
    """The JAX script's verdict on ``results`` ({variant: {str(snr):
    {"bit_per_s", "fer", "fer_ci95"}}}): each candidate's speed at 3.4 dB
    (else the last point) and FER parity with the baseline; the fastest
    candidate with both is recommended."""
    base = results[baseline]
    target = str(3.4) if 3.4 in snrs else str(snrs[-1])
    out, best = {}, None
    for name, r in results.items():
        if name == baseline:
            continue
        faster = r[target]["bit_per_s"] > base[target]["bit_per_s"]
        # paired channel draws: at every point the candidate's FER at or
        # below the baseline's 95% upper band
        parity = all(r[str(s)]["fer"] <= base[str(s)]["fer_ci95"][1] + 1e-12
                     for s in snrs)
        out[name] = {"faster": bool(faster), "ber_parity": bool(parity)}
        if faster and parity and (best is None or r[target]["bit_per_s"] >
                                  results[best][target]["bit_per_s"]):
            best = name
    return {"adopt": best is not None, "recommended": best,
            "candidates": out, "target_snr": target}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--snr", default="3.0,3.2,3.4,3.6")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--store", default="bfloat16")
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--code", default="near-earth",
                    choices=["near-earth", "wifi"])
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/layered_ab on the card)")
    args = ap.parse_args(argv)
    b, mi = args.batch, args.max_iters
    snrs = [float(s) for s in args.snr.split(",")]

    dev = study_device()
    code = wifi_code() if args.code == "wifi" else near_earth_code()

    def run(step, snr: float, seed: int) -> dict:
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = step(torch.full((b,), snr, dtype=torch.float32, device=dev),
                   generator=gen)
        return {k: v.cpu() for k, v in out.items()}

    built = {}
    for sched, fracs, caps16 in VARIANTS:
        phases = scale(fracs, mi)
        name = f"{sched}-p{'-'.join(map(str, phases))}"
        t0 = time.perf_counter()
        step = make_staged_sweep_device(
            code, mi, phase1_iters=list(phases),
            redo_capacity=[b * c // 16 for c in caps16], engine="cuda",
            schedule=sched, store_dtype=args.store, device=dev)
        out = run(step, snrs[-1], 17)
        print(f"{name}: built+warm {time.perf_counter() - t0:.1f} s "
              f"nfail_final={int((~out['success']).sum())}", flush=True)
        built[name] = (sched, phases, caps16, step)

    results: dict = {name: {} for name in built}
    for si, snr in enumerate(snrs):
        for _, _, _, step in built.values():    # untimed warm pass
            run(step, snr, SEED + 1000 * si + 999)
        acc = {name: {"best": float("inf")} for name in built}
        for t in range(args.trials):
            for name, (_, _, _, step) in built.items():
                sync(dev)
                t0 = time.perf_counter()
                out = run(step, snr, SEED + 1000 * si + t)
                dt = time.perf_counter() - t0
                a = acc[name]
                a["best"] = min(a["best"], dt)
                if t == 0:
                    a["errs"] = int(out["errors_decoded"].sum())
                    a["frames"] = int((~out["success"]).sum())
                    a["iters"] = float(out["iterations"].float().mean())
                print(f"snr {snr} trial {t} {name:>16}: {dt * 1e3:8.1f} ms",
                      flush=True)
        for name, a in acc.items():
            _, lo, hi = wilson_interval(a["frames"], b)
            results[name][str(snr)] = {
                "bit_per_s": b * code.n / a["best"],
                "ber": a["errs"] / (b * code.n),
                "fer": a["frames"] / b, "frames": a["frames"],
                "fer_ci95": [lo, hi], "avg_iterations": a["iters"],
            }

    baseline = next(iter(built))
    verdict = adopt_verdict(results, snrs, baseline)
    target = verdict["target_snr"]
    for name, c in verdict["candidates"].items():
        print(f"{name}: faster@{target}={c['faster']} "
              f"ber_parity={c['ber_parity']} "
              f"{results[name][target]['bit_per_s'] / 1e6:.1f} Mbit/s "
              f"(baseline {results[baseline][target]['bit_per_s'] / 1e6:.1f})",
              flush=True)
    art = {"code": args.code, "batch": b, "store": args.store,
           "max_iters": mi, "snr_points": snrs, "trials": args.trials,
           "engine": "cuda", **stamp(dev), "baseline": baseline,
           "variants": {n: {"schedule": s, "phases": list(p),
                            "caps_16ths": list(c)}
                        for n, (s, p, c, _) in built.items()},
           "results": results, **verdict}
    if verdict["recommended"]:
        art["recommended"] = {"name": verdict["recommended"],
                              **art["variants"][verdict["recommended"]]}
    md = ["# Layered vs flooding schedule A/B", "",
          f"{args.code}, {b:,} words a batch, min-sum, {args.store} state, "
          f"max {mi} iterations, transmit + staged cascade on the cuda "
          f"engine, best of {args.trials} trials "
          f"(`ldpc_tpu_torch/scripts/layered_ab.py`; {art['device']}; "
          f"kernel hash `{art['kernel_hash'][:12]}`).", "",
          "| variant | " + " | ".join(
              f"Mbit/s @{s} | FER @{s} | iters @{s}" for s in snrs) + " |",
          "|---|" + "---|" * (3 * len(snrs))]
    for name, r in results.items():
        md.append(f"| {name} | " + " | ".join(
            f"{r[str(s)]['bit_per_s'] / 1e6:.1f} | {r[str(s)]['fer']:.5f} | "
            f"{r[str(s)]['avg_iterations']:.2f}" for s in snrs) + " |")
    md += ["", f"adopt: {art['adopt']}"
           + (f" ({verdict['recommended']})" if verdict["recommended"]
              else "") + "; per candidate (faster at " + target + " dB, "
           "FER within the baseline's band): " + ", ".join(
               f"{n} {c['faster']}/{c['ber_parity']}"
               for n, c in verdict["candidates"].items()) + "."]
    write_artifact(artifact_base("layered_ab", args.out, dev), art, md)
    print(f"adopt={art['adopt']}", flush=True)
    return art


if __name__ == "__main__":
    main(sys.argv[1:])
