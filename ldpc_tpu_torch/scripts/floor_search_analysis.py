"""Adjudicate a floor-aware search: the plain reward and the floor FER.

The port's counterpart of the JAX package's
``scripts/floor_search_analysis.py``.  A floor-aware search optimizes
``fitted-line reward - 30 * FER@3.8 dB``; this scores the discovery chain
under both objectives at high fidelity (``chain_scoreboard``'s protocol:
512 transmissions x 5 SNR points x 5 seeds for the reward, 262,144 words
at 3.8 dB for the floor, ``penalized = reward - 30 * FER``): near-earth,
the carried ``s47`` and ``boot_s52`` (``data/chain/``) and the best train
reward of the search log (``--steps-tsv``, required), with the log's
learning windows and action heat maps (arrays; figures only where
matplotlib is installed).  The decodes go through the fused kernel
(``engine="cuda"``, bf16 state; its plain version on the CPU).

Writes ``ldpc_tpu_torch/data/floor_search_analysis.{json,md}`` (or
``--out``), stamped with the port's kernel hash and the card's name and
power limit.  The log's best code is recorded by its content-addressed
instance name.

On the card::

    python -m ldpc_tpu_torch.scripts.floor_search_analysis \\
        --steps-tsv RUN/steps.tsv

CPU smoke (a near-earth-shaped log; small sizes)::

    LDPC_TPU_PLATFORM=cpu python -m \\
        ldpc_tpu_torch.scripts.floor_search_analysis --steps-tsv steps.tsv \\
        --reeval-tx 2 --reeval-seeds 11 --floor-words 4 \\
        --out /tmp/floor_search_analysis
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..analysis.postprocess import (_read_steps, action_heatmaps,
                                    learning_windows)
from ..codes import near_earth_code, uncompress
from .chain_scoreboard import score_codes, score_row
from .discovered_code_waterfall import instance_name
from .studies import (artifact_base, can_draw, resolve_code, stamp,
                      study_device, write_artifact)

CHAIN_MEMBERS = ("s47", "boot_s52")
ITERS = 50


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-tsv", required=True,
                    help="the floor-aware search's steps.tsv")
    ap.add_argument("--penalty", type=float, default=30.0)
    ap.add_argument("--floor-snr", type=float, default=3.8)
    ap.add_argument("--floor-words", type=int, default=262144)
    ap.add_argument("--reeval-tx", type=int, default=512)
    ap.add_argument("--reeval-seeds", type=int, nargs="+",
                    default=[11, 12, 13, 14, 15])
    ap.add_argument("--snr", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6, 3.8])
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: ldpc_tpu_torch/data/"
                         "floor_search_analysis on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    df = _read_steps(args.steps_tsv)
    n_ep = int(df["epoch"].max()) + 1
    windows = learning_windows(df)
    best = df.loc[df["reward"].idxmax()]
    obs = np.frombuffer(bytes.fromhex(best["observation_hex"]), np.uint8)
    floor_code = uncompress(obs, 2, 16, 511, name="rl_discovered_floor")
    figures = can_draw("seaborn")
    heat = action_heatmaps(args.steps_tsv, save_figures=figures)

    codes = {"near_earth": near_earth_code(),
             **{m: resolve_code(m)[0] for m in CHAIN_MEMBERS},
             "floor_best": floor_code}
    out = {"penalty": args.penalty, "floor_snr_db": args.floor_snr,
           "floor_words": args.floor_words, "epochs": n_ep,
           "steps_tsv": args.steps_tsv,
           "train_best_penalized_reward": float(best["reward"]),
           "windows": windows,
           "heatmaps": {k: list(v.shape) for k, v in heat.items()},
           "figures": figures, **stamp(dev)}
    out["codes"] = score_codes(
        codes, snr_points=args.snr, reeval_tx=args.reeval_tx,
        reeval_seeds=args.reeval_seeds, iters=ITERS,
        floor_snr=args.floor_snr, floor_words=args.floor_words,
        penalty=args.penalty, dev=dev)
    out["code_instance"] = instance_name(floor_code)

    rows = [f"# Floor-aware code search (reward − {args.penalty}·"
            f"FER@{args.floor_snr} dB)", "",
            f"{n_ep} epochs of `{args.steps_tsv}`; objective = fitted-line "
            f"reward − {args.penalty}·FER@{args.floor_snr} dB "
            f"(`ldpc_tpu_torch/scripts/floor_search_analysis.py`; "
            f"{out['device']}; kernel hash `{out['kernel_hash'][:12]}`).", "",
            "| window | mean step reward | max | fraction > 0 |",
            "|---|---|---|---|"]
    for win in windows:
        rows.append(f"| {win['window']} | {win['mean']:.3f} | "
                    f"{win['max']:.3f} | {win['frac_positive']:.2f} |")
    rows += ["", "## The chain under both objectives (high-fidelity "
             "re-eval)", "",
             f"| code | plain reward | FER@{args.floor_snr} (Wilson 95%) "
             "| penalized objective |", "|---|---|---|---|"]
    rows += [score_row(name, c) for name, c in out["codes"].items()]
    rows += ["", f"Best-found instance: `{out['code_instance']}`."]
    write_artifact(artifact_base("floor_search_analysis", args.out, dev), out,
                   rows)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
