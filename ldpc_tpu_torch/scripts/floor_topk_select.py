"""Top-K re-evaluated selection for a floor-aware search.

The port's counterpart of the JAX package's ``scripts/floor_topk_select.py``.
The max train reward of a floor-aware search is a noisy draw: with 2,048
floor words a step, a code of FER 6e-4 draws no frame error about 30% of
the time, so the argmax picks lucky draws (a winner's curse).  This
re-scores the top-K distinct candidates of a search log (``--steps-tsv``,
required) at higher fidelity under ``reward - penalty * FER@floor`` through
``analysis.postprocess.topk_select`` and ranks them on the re-evaluated
objective.  Both the re-evaluation and the floor decode through the fused
kernel (``engine="cuda"``, bf16 state; its plain version on the CPU).

Writes ``ldpc_tpu_torch/data/floor_topk_select.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.
The selected code is recorded by its content-addressed instance name; its
``observation_hex`` is in the candidates.

On the card::

    python -m ldpc_tpu_torch.scripts.floor_topk_select \\
        --steps-tsv RUN/steps.tsv [--topk 12]

On the CPU (a near-earth-shaped search log)::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.floor_topk_select \\
        --steps-tsv steps.tsv --topk 2 --reeval-tx 2 --reeval-seeds 21 \\
        --floor-words 8 --out /tmp/floor_topk
"""

from __future__ import annotations

import argparse
import sys
import time

from ..analysis.postprocess import topk_select
from .discovered_code_waterfall import instance_name
from .studies import (artifact_base, stamp, study_device, sweep_kw,
                      write_artifact)

FLOOR_SEED = 616161
ITERS = 50
SHAPE = (2, 16, 511)    # near-earth's block rows, block columns and z


def candidate_rows(rows: list) -> list:
    """``topk_select``'s rows under the JAX script's keys (one floor term:
    ``fer_floor`` and ``fer_wilson95``), best re-evaluated penalized
    objective first."""
    out = [{"rank": r["rank_train"], "train_reward": r["train_reward"],
            "epoch": r["epoch"], "observation_hex": r["observation_hex"],
            "reward_mean": r["reward_mean"], "reward_std": r["reward_std"],
            "fer_floor": r["floors"][0]["fer"],
            "fer_wilson95": r["floors"][0]["fer_wilson95"],
            "penalized": r["penalized"]} for r in rows]
    return sorted(out, key=lambda r: -r["penalized"])


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-tsv", required=True,
                    help="the search's steps.tsv")
    ap.add_argument("--topk", type=int, default=12)
    ap.add_argument("--penalty", type=float, default=30.0)
    ap.add_argument("--floor-snr", type=float, default=3.8)
    ap.add_argument("--floor-words", type=int, default=65536)
    ap.add_argument("--reeval-tx", type=int, default=256)
    ap.add_argument("--reeval-seeds", type=int, nargs="+",
                    default=[21, 22, 23])
    ap.add_argument("--snr", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6, 3.8])
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/floor_topk_select on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    t0 = time.perf_counter()
    best_code, rows = topk_select(
        args.steps_tsv, *SHAPE, topk=args.topk, snr_points=tuple(args.snr),
        reeval_transmissions=args.reeval_tx, reeval_seeds=args.reeval_seeds,
        max_iters=ITERS, floor_penalties=[args.penalty],
        floor_snrs=[args.floor_snr], floor_words=args.floor_words,
        floor_seed=FLOOR_SEED,
        floor_eval_kw=sweep_kw(dev, args.floor_words, ITERS),
        reeval_kw=sweep_kw(dev))
    cands = candidate_rows(rows)
    best = cands[0]
    out = {"topk": args.topk, "penalty": args.penalty,
           "floor_words": args.floor_words, "steps_tsv": args.steps_tsv,
           **stamp(dev), "seconds": time.perf_counter() - t0,
           "candidates": cands,
           "best_instance": instance_name(best_code)}
    md = ["# Top-K re-evaluated selection (the winner's-curse fix)", "",
          f"Re-scoring the top {len(cands)} distinct candidates of "
          f"`{args.steps_tsv}` at higher fidelity ({args.reeval_tx} tx x "
          f"{len(args.reeval_seeds)} seeds for the reward, "
          f"{args.floor_words:,} words for FER@{args.floor_snr}) and "
          "selecting on the re-evaluated penalized objective "
          f"(`ldpc_tpu_torch/scripts/floor_topk_select.py`; {out['device']}; "
          f"kernel hash `{out['kernel_hash'][:12]}`):", "",
          "| rank (by true penalized) | train (noisy) | true reward | "
          f"FER@{args.floor_snr} | true penalized |", "|---|---|---|---|---|"]
    for i, r in enumerate(cands[:6]):
        md.append(f"| {i} | {r['train_reward']:.4f} | "
                  f"{r['reward_mean']:.5f} ± {r['reward_std']:.5f} | "
                  f"{r['fer_floor']:.2e} | {r['penalized']:.5f} |")
    md += ["", f"Selected instance: `{out['best_instance']}` (true "
           f"penalized {best['penalized']:.5f})."]
    print(f"best penalized {best['penalized']:.5f}", flush=True)
    write_artifact(artifact_base("floor_topk_select", args.out, dev), out, md)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
