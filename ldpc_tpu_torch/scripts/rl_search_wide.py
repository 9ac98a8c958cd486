"""PPO code search, turnkey: train, top-K re-evaluated selection, summary.

The port's counterpart of the JAX package's ``scripts/rl_search_wide.py``.
PPO on the code-search env over the reference's wide reward window (3.0-3.8
dB, published near-earth baseline 0.7958451612664468,
``postProcessing.py:18``) through ``rl.train.main``, then the log's
learning windows and action heat maps (arrays; figures only where
matplotlib and seaborn are installed), the top-K re-evaluated selection of
the discovered code (``analysis.postprocess.topk_select``) and the start
code under the same protocol.  On the card the env decodes each candidate
through the fused kernel (f32 state, the code's tables as data) and the
selection through it with bf16 state (``engine="cuda"``); on the CPU
(``LDPC_TPU_PLATFORM=cpu``) through their plain versions.

Floor-aware searches: ``--floor-penalty L1 [L2..] --floor-snr-index I1
[I2..]`` subtracts FER terms from the training reward; a single value of
either broadcasts against the other, and every index must name one of the
``--snr`` points (negative ones count from the end), as the env requires.
``--floor-penalty-final`` anneals the penalty scale over the epochs, and
the same floor terms score the top-K selection.

The run's logs, checkpoints and ``summary.json`` go to
``<data-dir>/<exp-name>/`` (default data dir: ``experiments`` in the
system's temporary directory); ``--resume`` continues the search from its
last checkpoint, ``--select-only`` skips training and selects from the
existing ``steps.tsv``.  The summary is also written to
``ldpc_tpu_torch/data/rl_search_wide.{json,md}`` (``rl_<exp-name>`` for
another experiment name; or ``--out``), stamped with the port's kernel hash
and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.rl_search_wide [--epochs 150] \\
        [--steps 32]

CPU smoke (the 802.11n env, 2 epochs x 2 steps)::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.rl_search_wide \\
        --smoke --data-dir /tmp/experiments --out /tmp/rl_search_wide
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..analysis.postprocess import (REWARD_FOR_NEAR_EARTH_3_0_TO_3_8,
                                    _read_steps, action_heatmaps,
                                    learning_windows, reeval_reward,
                                    topk_select)
from ..codes import save_code_instance
from ..sim.evaluate import evaluate_code
from .studies import (artifact_base, can_draw, fer_point, resolve_code,
                      stamp, study_device, sweep_kw, write_artifact)

WIDE_BASELINE = REWARD_FOR_NEAR_EARTH_3_0_TO_3_8   # postProcessing.py:18
FLOOR_SEED = 616161


def floor_terms(penalties, indices, snr_points) -> tuple[list, list]:
    """The floor terms of the training reward as the env builds them: a
    single penalty or index broadcasts against the other list, lists of
    two different lengths raise, every index must name one of
    ``snr_points`` (negative ones from the end).  Returns the terms with a
    nonzero penalty: (penalties, their SNR points)."""
    pens = np.atleast_1d(np.asarray(penalties, np.float64))
    idxs = np.atleast_1d(np.asarray(indices, np.int64))
    if pens.shape[0] != idxs.shape[0]:
        if pens.shape[0] == 1:
            pens = np.repeat(pens, idxs.shape[0])
        elif idxs.shape[0] == 1:
            idxs = np.repeat(idxs, pens.shape[0])
        else:
            raise ValueError(
                f"floor_penalty and floor_snr_index lengths differ: "
                f"{pens.shape[0]} vs {idxs.shape[0]}")
    k = len(snr_points)
    bad = idxs[(idxs < -k) | (idxs >= k)]
    if bad.size:
        raise ValueError(f"floor_snr_index {bad.tolist()} out of range "
                         f"for {k} SNR points")
    keep = [(float(p), float(snr_points[i])) for p, i in zip(pens, idxs)
            if p]
    return [p for p, _ in keep], [s for _, s in keep]


def _train_seconds(tsv: str) -> float | None:
    """The wall clock of the run that wrote ``tsv``: the last Time column of
    its progress.txt (None where there is none)."""
    try:
        with open(os.path.join(os.path.dirname(tsv), "progress.txt")) as f:
            header = f.readline().rstrip("\n").split("\t")
            last = f.readlines()[-1].rstrip("\n").split("\t")
        return float(last[header.index("Time")])
    except (OSError, ValueError, IndexError):
        return None


def _smoke_train(run_dir: str, args, dev) -> None:
    """The JAX script's smoke run: PPO on the 802.11n env, 2 epochs x 2
    steps, 4 transmissions, 8 iterations."""
    from ..codes import wifi_code
    from ..envs.code_search import LdpcCodeSearchEnv
    from ..rl.ppo import PPOConfig, ppo
    from ..utils.logging import EpochLogger

    logger = EpochLogger(output_dir=f"{run_dir}/{args.exp_name}_s{args.seed}",
                         exp_name=args.exp_name)
    ppo(lambda: LdpcCodeSearchEnv(
            code=wifi_code(), snr_points=(3.0, 3.5, 4.0),
            num_transmissions=4, num_iterations=8, seed=args.seed,
            dmax_cn_cap=24, dmax_vn_cap=8, device=dev),
        PPOConfig(steps_per_epoch=2, epochs=2, seed=args.seed,
                  entropy_bonus=True),
        logger=logger, device=dev)


def _train_argv(args) -> list[str]:
    return ([
        "--epochs", str(args.epochs), "--steps", str(args.steps),
        "--num_transmissions", *[str(t) for t in args.num_transmissions],
        "--floor_penalty", *[str(p) for p in args.floor_penalty],
        "--floor_snr_index", *[str(i) for i in args.floor_snr_index],
        *(["--floor_penalty_final", str(args.floor_penalty_final)]
          if args.floor_penalty_final is not None else []),
        *(["--phase1_iterations", str(args.phase1_iterations)]
          if args.phase1_iterations else []),
        "--entropy_bonus", "--seed", str(args.seed),
        "--num_envs", str(args.num_envs),
        *(["--resume"] if args.resume else []),
        "--exp_name", args.exp_name, "--data_dir", args.data_dir,
        "--snr", *[str(s) for s in args.snr]]
        + (["--start_instance", args.start_instance]
           if args.start_instance else [])
        + (["--start_code", args.start_code] if args.start_code else []))


def summary_md(out: dict, args, rows: list, base: dict, start: str) -> list:
    snrs, sel = out["snr_points"], out["selection"]
    floor_snrs, floor_pens = sel["floor_snrs"], sel["floor_penalties"]
    best = rows[0]
    md = [
        f"# PPO code search `{args.exp_name}` ({snrs[0]}-{snrs[-1]} dB "
        "window)", "",
        f"{out['epochs']} epochs x {args.steps} steps"
        + (f" x {args.num_envs} envs" if args.num_envs > 1 else "")
        + f" on the {start} code-search env, "
        f"{'/'.join(str(t) for t in args.num_transmissions)} transmissions "
        f"per (SNR, step) over SNR {list(snrs)} dB, standard entropy bonus, "
        f"seed {args.seed} ({out['train_seconds']:,.0f} s; "
        f"`ldpc_tpu_torch/scripts/rl_search_wide.py`; {out['device']}; "
        f"kernel hash `{out['kernel_hash'][:12]}`).  Reward = ∫(1 − "
        f"fitted BER line) over {snrs[0]}-{snrs[-1]} dB"
        + (f" − Σ λ·FER at {floor_snrs} dB (λ={floor_pens}"
           + (f", annealed to x"
              f"{args.floor_penalty_final / max(floor_pens):.1f}"
              if args.floor_penalty_final else "") + ")"
           if floor_snrs else "")
        + f".  Logs and instance in `{out['run_dir']}`.",
        "", "## Learning", "",
        "| window | mean step reward | max | fraction > 0 |",
        "|---|---|---|---|"]
    for win in out["windows"]:
        md.append(f"| {win['window']} | {win['mean']:.3f} | "
                  f"{win['max']:.3f} | {win['frac_positive']:.2f} |")
    md += [
        "", "## Top-K re-evaluated selection", "",
        f"Top {len(rows)} distinct candidates re-scored at "
        f"{sel['reeval']['transmissions']} tx x "
        f"{len(sel['reeval']['seeds'])} seeds"
        + (f" + {sel['floor_words']:,} words per floor point" if floor_snrs
           else "") + ", selected on the re-evaluated objective:", "",
        "| rank | train (noisy) | true reward | "
        + "".join(f"FER@{s} | " for s in floor_snrs) + "penalized |",
        "|---|---|---|" + "---|" * (len(floor_snrs) + 1)]
    for i, r in enumerate(rows[:6]):
        fcells = "".join(f"{f['fer']:.2e} | " for f in r["floors"])
        md.append(f"| {i} | {r['train_reward']:.4f} | "
                  f"{r['reward_mean']:.5f} ± {r['reward_std']:.5f} | "
                  f"{fcells}{r['penalized']:.5f} |")
    bcells = "".join(f"{f['fer']:.2e} | " for f in base["floors"])
    md += ["", f"Start code under the same protocol: reward "
           f"{base['mean']:.5f} ± {base['std']:.5f}"
           + (f", floors {bcells.strip(' |')}" if base["floors"] else "")
           + f", penalized {base['penalized']:.5f}.", "",
           f"Selected instance: `{sel['best_instance']}` (true penalized "
           f"{best['penalized']:.5f}; full candidate table in the JSON)."]
    return md


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--num-transmissions", type=int, nargs="+",
                    default=[64],
                    help="one value for all SNR points, or one per point")
    ap.add_argument("--floor-penalty", type=float, nargs="+", default=[0.0])
    ap.add_argument("--floor-snr-index", type=int, nargs="+", default=[-1])
    ap.add_argument("--floor-penalty-final", type=float, default=None)
    ap.add_argument("--floor-words", type=int, default=65536,
                    help="words per floor point in the top-K selection")
    ap.add_argument("--phase1-iterations", type=int, default=None)
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--snr", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6, 3.8])
    ap.add_argument("--exp-name", default="search_wide")
    ap.add_argument("--data-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "experiments"))
    ap.add_argument("--start-instance", default=None,
                    help="code to START the search from (a carried name, a "
                         "JSON code or a .npz); the re-eval baseline "
                         "becomes this code")
    ap.add_argument("--start-code", default=None,
                    choices=["near-earth", "wifi"],
                    help="named start state (wifi = 802.11n rate 5/6)")
    ap.add_argument("--num-envs", type=int, default=1,
                    help="parallel rollout envs (steps is PER ENV)")
    ap.add_argument("--topk", type=int, default=8,
                    help="top-K re-evaluated selection width (1 = the "
                         "argmax, winner's-curse-prone)")
    ap.add_argument("--reeval-transmissions", type=int, default=512)
    ap.add_argument("--reeval-seeds", type=int, nargs="+",
                    default=[11, 12, 13, 14, 15])
    ap.add_argument("--resume", action="store_true",
                    help="continue the search from its latest checkpoint")
    ap.add_argument("--select-only", action="store_true",
                    help="skip training: top-K selection and summary from "
                         "the EXISTING steps.tsv")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run: the 802.11n env, 2 epochs x 2 steps")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/rl_search_wide on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    run_dir = f"{args.data_dir}/{args.exp_name}"
    tsv = f"{run_dir}/{args.exp_name}_s{args.seed}/steps.tsv"
    if args.start_instance:
        base_code, start_src = resolve_code(args.start_instance)
    elif args.smoke or args.start_code == "wifi":
        base_code, start_src = resolve_code("wifi")
    else:
        base_code, start_src = resolve_code("near-earth")
    if args.smoke:
        snrs = (3.0, 3.5, 4.0)
        reeval_tx, reeval_seeds, reeval_iters = 8, [11, 12], 8
        floor_pens, floor_snrs, floor_words = [], [], 64
    else:
        snrs = tuple(args.snr)
        reeval_tx, reeval_seeds, reeval_iters = (
            args.reeval_transmissions, args.reeval_seeds, 50)
        floor_pens, floor_snrs = floor_terms(
            args.floor_penalty, args.floor_snr_index, snrs)
        floor_words = args.floor_words

    t0 = time.perf_counter()
    if args.select_only:
        train_s = _train_seconds(tsv) or time.perf_counter() - t0
    else:
        if args.smoke:
            _smoke_train(run_dir, args, dev)
        else:
            from ..rl import train
            train.main(_train_argv(args), device=dev)
        train_s = time.perf_counter() - t0

    df = _read_steps(tsv)
    n_ep = int(df["epoch"].max()) + 1
    windows = learning_windows(df)
    figures = can_draw("seaborn")
    heat = action_heatmaps(tsv, save_figures=figures)

    floor_kw = sweep_kw(dev, floor_words, reeval_iters)
    t1 = time.perf_counter()
    best_code, rows = topk_select(
        tsv, base_code.block_rows, base_code.block_cols, base_code.z,
        topk=args.topk, snr_points=snrs, reeval_transmissions=reeval_tx,
        reeval_seeds=reeval_seeds, max_iters=reeval_iters,
        floor_penalties=floor_pens, floor_snrs=floor_snrs,
        floor_words=floor_words, floor_seed=FLOOR_SEED,
        floor_eval_kw=floor_kw, reeval_kw=sweep_kw(dev))

    base_m, base_s, _ = reeval_reward(base_code, snrs, reeval_tx,
                                      reeval_iters, reeval_seeds,
                                      **sweep_kw(dev))
    base = {"mean": base_m, "std": base_s, "floors": [], "penalized": base_m}
    if floor_snrs:
        stats = evaluate_code(base_code, floor_snrs, floor_words,
                              reeval_iters, seed=FLOOR_SEED, **floor_kw)
        for lam, snr in zip(floor_pens, floor_snrs):
            p = fer_point(stats, snr)
            base["floors"].append({"snr_db": snr, "penalty": lam,
                                   "fer": p["fer"],
                                   "fer_wilson95": p["fer_wilson95"],
                                   "words": p["words"]})
            base["penalized"] -= lam * p["fer"]
    select_s = time.perf_counter() - t1

    best = rows[0]
    inst = save_code_instance(best_code, run_dir)
    out = {
        "exp_name": args.exp_name, "epochs": n_ep,
        "steps_per_epoch": args.steps, "snr_points": list(snrs),
        "train_seconds": train_s, "select_seconds": select_s,
        "windows": windows, "run_dir": run_dir,
        "heatmaps": {k: list(v.shape) for k, v in heat.items()},
        "figures": figures, **stamp(dev),
        "published_wide_baseline": WIDE_BASELINE,
        "selection": {
            "method": "topk_reevaluated", "topk": args.topk,
            "steps_tsv": tsv, "floor_penalties": floor_pens,
            "floor_snrs": floor_snrs, "floor_words": floor_words,
            "reeval": {"transmissions": reeval_tx,
                       "seeds": list(reeval_seeds)},
            "candidates": [{k: v for k, v in r.items() if k != "code"}
                           for r in rows],
            "best_instance": inst,
        },
        "start_code": {**base, "code": start_src},
        "best_found": {"mean": best["reward_mean"],
                       "std": best["reward_std"],
                       "train_reward": best["train_reward"],
                       "floors": best["floors"],
                       "penalized": best["penalized"]},
    }
    with open(f"{run_dir}/summary.json", "w") as f:
        json.dump(out, f, indent=1)
    start = (os.path.basename(str(start_src)).removesuffix(".npz")[:24]
             if args.start_instance else base_code.name or "near-earth")
    name = ("rl_search_wide" if args.exp_name == "search_wide"
            else f"rl_{args.exp_name}")
    write_artifact(artifact_base(name, args.out, dev), out,
                   summary_md(out, args, rows, base, start))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
