"""Perturbed-circulant FER robustness study.

The port's counterpart of the JAX package's ``scripts/perturbation_fer.py``.
The reference generates 32 near-earth variants with one circulant zeroed
(``testMatricesGeneratorScript.py:23-34``) for FER-degradation studies but
ships no measured artifact.  This decodes every variant and the intact
code at 8,192 words a point, 3.2-3.8 dB (min-sum, flooding, 50
iterations, one straight decode a point) and writes the degradation table.

Each code decodes through the route of the code-search env
(``envs.code_search.route_counts_fn``): on the card the fused kernel with
the code's edge tables uploaded as data (float32 state; a new code costs
its plan, its tables and an upload, no build), on the CPU
``ops/dynamic.py``, the structure-generic decoder at the intact code's
degree caps.

Writes ``ldpc_tpu_torch/data/perturbation_fer.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.perturbation_fer [--words 8192]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.perturbation_fer \\
        --words 4 --max-iters 5 --snr 3.6 \\
        --out /tmp/perturbation_fer
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..codes import near_earth_code
from ..codes.perturb import zeroed_circulant_suite
from ..envs.code_search import route_counts_fn
from ..ops.plan import DecodePlan
from ..sim.evaluate import transmit
from .studies import artifact_base, stamp, study_device, write_artifact

SEED = 31415


def point_seed(variant: int, snr: float) -> int:
    """The JAX script's fold_in data of a point, under the script's seed."""
    return SEED * 1000000 + variant * 1000 + int(snr * 10)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=8192,
                    help="transmissions per (variant, SNR) point")
    ap.add_argument("--snr", type=float, nargs="+",
                    default=[3.2, 3.4, 3.6, 3.8])
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/perturbation_fer on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    code = near_earth_code()
    base = DecodePlan.from_code(code)
    variants = [("intact", code)] + [
        (f"zero_{mb}_{nb}", v) for mb, nb, v in zeroed_circulant_suite(code)]

    results: dict = {"words": args.words, "snr_points": args.snr,
                     "max_iters": args.max_iters, **stamp(dev),
                     "route": ("fused kernel, tables as data, float32 state"
                               if dev.type == "cuda" else "ops/dynamic.py"),
                     "variants": {}}
    t_start = time.perf_counter()
    for vi, (name, variant) in enumerate(variants):
        dec = route_counts_fn(variant, args.max_iters, kind="min-sum",
                              device=dev, dmax_cn=base.dmax_cn,
                              dmax_vn=base.dmax_vn)
        row: dict = {}
        for snr in args.snr:
            gen = torch.Generator(device=dev).manual_seed(point_seed(vi, snr))
            llr = transmit(code.n, torch.full((args.words,), float(snr),
                                              dtype=torch.float32,
                                              device=dev), generator=gen)[0]
            errs, _, ok = (x.cpu().numpy() for x in dec(llr))
            row[f"{snr:.1f}"] = {
                "fer": float((errs > 0).mean()),
                "frames": int((errs > 0).sum()),
                "ber": float(errs.sum()) / (args.words * code.n),
                "success_rate": float(ok.mean()),
                "undetected": int(((errs > 0) & ok).sum()),
            }
        results["variants"][name] = row
        line = "  ".join(f"{snr:.1f}dB FER {row[f'{snr:.1f}']['fer']:.4f}"
                         for snr in args.snr)
        print(f"[perturb] {name:12s} {line}", file=sys.stderr, flush=True)
    results["elapsed_s"] = time.perf_counter() - t_start

    snr_cols = " | ".join(f"FER @{s:.1f} dB" for s in args.snr)
    md = ["# Perturbed-circulant FER robustness (near-earth)", "",
          f"One circulant of the CCSDS near-earth code zeroed a variant "
          f"(reference suite: testMatricesGeneratorScript.py:23-34); "
          f"{args.words:,} transmissions a point, min-sum, max "
          f"{args.max_iters} iterations, flooding; {results['route']} "
          f"(`ldpc_tpu_torch/scripts/perturbation_fer.py`; "
          f"{results['device']}; kernel hash "
          f"`{results['kernel_hash'][:12]}`; "
          f"{results['elapsed_s']:.1f} s).", "",
          f"| variant (zeroed mb,nb) | {snr_cols} |",
          "|---|" + "---|" * len(args.snr)]
    for name, row in results["variants"].items():
        md.append(f"| {name} | " + " | ".join(
            f"{row[f'{s:.1f}']['fer']:.4f}" for s in args.snr) + " |")
    zeroed = [n for n in results["variants"] if n != "intact"]
    if zeroed:
        lo, hi = f"{args.snr[0]:.1f}", f"{args.snr[-1]:.1f}"
        intact = results["variants"]["intact"]
        mean_lo = float(np.mean([results["variants"][n][lo]["fer"]
                                 for n in zeroed]))
        worst = max(zeroed, key=lambda n: results["variants"][n][hi]["fer"])
        und = sum(p["undetected"] for r in results["variants"].values()
                  for p in r.values())
        md += ["", f"At {lo} dB the zeroed variants' mean FER is "
               f"{mean_lo:.4f} against the intact code's "
               f"{intact[lo]['fer']:.4f}; at {hi} dB the intact code's is "
               f"{intact[hi]['fer']:.4f} and the worst variant's "
               f"(`{worst}`) {results['variants'][worst][hi]['fer']:.4f}; "
               f"undetected frames (success with bit errors): {und}."]
    write_artifact(artifact_base("perturbation_fer", args.out, dev), results,
                   md)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
