"""Post-hoc experiment analysis (reference ``postProcessing.py``; the port
of ``ldpc_tpu.analysis.postprocess``).

* ``post_mortem_best_codes`` — re-evaluate the best codes found during an
  experiment by uncompressing the logged observations and running a fresh
  Monte-Carlo sweep (postProcessing.py:27-49; the decode goes through
  ``sim.evaluate_code`` instead of ``ldpcCUDA.evaluateCodeCuda``, with its
  defaults: the torch engine on the card; ``engine="cuda"`` in the
  evaluation keywords reaches the fused kernel).
* ``reeval_reward`` / ``topk_select`` — the env's reward at high fidelity,
  and the selection of a search's winner on it.
* ``action_heatmaps`` — per-epoch histograms of the i/j/k action choices
  (postProcessing.py:54-160), as arrays + optional seaborn heatmap PNGs.
* ``reward_surface`` — the reward over the fitted line's (slope, bias).

Reads the ``steps.tsv`` written by ``ldpc_tpu_torch.rl.ppo`` (columns:
epoch, step, env, reward, value, logp, i, j, k, observation_hex).  pandas,
matplotlib and seaborn are imported by the functions that use them.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..codes import uncompress
from ..sim.evaluate import evaluate_code

__all__ = ["post_mortem_best_codes", "action_heatmaps", "reward_surface",
           "reeval_reward", "topk_select",
           "REWARD_FOR_NEAR_EARTH_3_0_TO_3_8",
           "REWARD_FOR_NEAR_EARTH_3_0_TO_3_4", "POST_MORTEM_SNR_POINTS"]

# Reference reward baselines (postProcessing.py:18-19)
REWARD_FOR_NEAR_EARTH_3_0_TO_3_8 = 0.7958451612664468
REWARD_FOR_NEAR_EARTH_3_0_TO_3_4 = 0.3965108116285836
POST_MORTEM_SEED = 42 + 61017406 + 1         # postProcessing.py:21
POST_MORTEM_SNR_POINTS = (3.0, 3.2, 3.4, 3.6)
POST_MORTEM_NUM_TRANSMISSIONS = 30
POST_MORTEM_NUM_ITERATIONS = 50


def _read_steps(file_path):
    import pandas as pd
    # observation_hex must stay a string (an all-digit hex blob would
    # otherwise be parsed as a huge integer)
    return pd.read_csv(file_path, sep="\t",
                       dtype={"observation_hex": str})


def learning_windows(df, num: int = 10):
    """First/mid/last learning-curve windows over a steps DataFrame
    (reward column): [{window, mean, max, frac_positive}] — the summary
    convention shared by every search artifact."""
    n_ep = int(df["epoch"].max()) + 1
    w = max(1, n_ep // num)
    out = []
    for lo, hi in [(0, w), ((n_ep - w) // 2, (n_ep + w) // 2),
                   (n_ep - w, n_ep)]:
        sub = df[(df["epoch"] >= lo) & (df["epoch"] < hi)]["reward"]
        out.append({"window": f"epochs {lo}-{hi}",
                    "mean": float(sub.mean()), "max": float(sub.max()),
                    "frac_positive": float((sub > 0).mean())})
    return out


def reeval_reward(code, snr_points, num_transmissions, max_iters, seeds,
                  **eval_kw):
    """The env's reward computation (code_search.py step semantics) at
    high fidelity: per-seed sweep -> scatter -> recursive fit -> ∫(1-fit).
    Returns (mean, std, per-seed rewards)."""
    from ..sim import calc_reward

    rewards = []
    for seed in seeds:
        stats = evaluate_code(code, list(snr_points), num_transmissions,
                              max_iters, seed=seed, **eval_kw)
        scatter_snr, scatter_ber, *_ = stats.get_stats_v2()
        rewards.append(calc_reward(scatter_snr, scatter_ber, snr_points))
    return float(np.mean(rewards)), float(np.std(rewards)), rewards


def topk_select(steps_tsv, block_rows: int = 2, block_cols: int = 16,
                z: int = 511, *, topk: int = 8,
                snr_points=(3.0, 3.2, 3.4, 3.6, 3.8),
                reeval_transmissions: int = 256,
                reeval_seeds=(21, 22, 23), max_iters: int = 50,
                floor_penalties=(), floor_snrs=(),
                floor_words: int = 65536, floor_seed: int = 616161,
                floor_eval_kw=None, reeval_kw=None, verbose: bool = True):
    """Top-K re-evaluated selection — THE selection step for every search.

    Argmax over noisy train rewards is a measured winner's curse (r4:
    train 0.841 re-evaluated to 0.799, rank 9/12 — docs/
    rl_search_floor.md).  This re-scores the top-K DISTINCT candidates of
    a search log at high fidelity — ``reeval_transmissions`` x seeds for
    the fitted-line reward, ``floor_words`` for each FER floor term — and
    selects on the RE-EVALUATED penalized objective
    ``reward − Σ λ_i · FER(snr_i)``.

    Returns ``(best_code, rows)``: rows sorted best-first, each carrying
    train/true rewards, per-floor-point FERs with Wilson CIs, and the
    penalized score; ``rows[0]["code"]`` is the winner.  Matches the
    re-eval protocol of the reference's postProcessing.py:27-49, with
    selection-integrity on top.
    """
    from ..sim.stats import wilson_interval

    floor_penalties = list(floor_penalties)
    floor_snrs = list(floor_snrs)
    if len(floor_penalties) != len(floor_snrs):
        raise ValueError("floor_penalties and floor_snrs lengths differ")
    df = _read_steps(steps_tsv)
    pos = df[df["reward"] > 0]
    df = (pos if len(pos) else df).sort_values("reward", ascending=False)
    cands = df.drop_duplicates("observation_hex").head(topk)
    rows = []
    for rank, (_, row) in enumerate(cands.iterrows()):
        obs = np.frombuffer(bytes.fromhex(row["observation_hex"]),
                            np.uint8)
        code = uncompress(obs, block_rows, block_cols, z,
                          name=f"topk_{rank}")
        try:
            rm, rs, _ = reeval_reward(code, tuple(snr_points),
                                      reeval_transmissions, max_iters,
                                      reeval_seeds, **(reeval_kw or {}))
            penalized = rm
            floors = []
            if floor_snrs:
                stats = evaluate_code(code, floor_snrs, floor_words,
                                      max_iters, seed=floor_seed,
                                      **(floor_eval_kw or {}))
                for lam, snr in zip(floor_penalties, floor_snrs):
                    sel = stats.column("snr") == snr
                    fe = int(stats.column("frame_errors")[sel].sum())
                    w = int(stats.column("weight")[sel].sum())
                    fer, flo, fhi = wilson_interval(fe, w)
                    floors.append({"snr_db": snr, "penalty": lam,
                                   "fer": fer,
                                   "fer_wilson95": [flo, fhi],
                                   "words": w})
                    penalized -= lam * fer
        except Exception as exc:  # noqa: BLE001
            # Kept from the JAX package, whose kernel compiles each
            # candidate's shifts as static rotations and could fail on one
            # candidate alone: skip it, visibly.  The fused kernel here
            # takes a candidate's tables as data, so a skip on the card is
            # a fault to report, not an expected outcome.
            if verbose:
                print(f"[topk {rank}] SKIPPED (eval failed: "
                      f"{type(exc).__name__}: {str(exc)[:200]})",
                      flush=True)
            continue
        rows.append({
            "rank_train": rank, "train_reward": float(row["reward"]),
            "epoch": int(row["epoch"]),
            "observation_hex": row["observation_hex"],
            "reward_mean": rm, "reward_std": rs, "floors": floors,
            "penalized": penalized, "code": code,
        })
        if verbose:
            fstr = " ".join(f"FER@{f['snr_db']}={f['fer']:.2e}"
                            for f in floors)
            print(f"[topk {rank}] train {row['reward']:.4f} -> reward "
                  f"{rm:.5f} ± {rs:.5f}  {fstr}  penalized "
                  f"{penalized:.5f}", flush=True)
    if not rows:
        raise RuntimeError("topk_select: every candidate evaluation "
                           "failed — nothing to select")
    rows.sort(key=lambda r: -r["penalized"])
    return rows[0]["code"], rows


def post_mortem_best_codes(file_path, block_rows: int = 2,
                           block_cols: int = 16, z: int = 511,
                           snr_points=POST_MORTEM_SNR_POINTS,
                           num_transmissions=POST_MORTEM_NUM_TRANSMISSIONS,
                           max_iters=POST_MORTEM_NUM_ITERATIONS,
                           max_codes: int = 20,
                           seed: int = POST_MORTEM_SEED, **eval_kw):
    """Re-evaluate every distinct best-reward code of an experiment;
    ``eval_kw`` go to ``evaluate_code`` (``device``, ``engine``...).

    Returns a list of (code, BerStatistics)."""
    df = _read_steps(file_path)
    best = df[df["reward"] >= df["reward"].max()]
    unique_obs = best["observation_hex"].unique()[:max_codes]
    results = []
    for hx in unique_obs:
        observation = np.frombuffer(bytes.fromhex(hx), np.uint8)
        code = uncompress(observation, block_rows, block_cols, z)
        stats = evaluate_code(code, list(snr_points), num_transmissions,
                              max_iters, seed=seed, **eval_kw)
        results.append((code, stats))
    return results


def action_heatmaps(file_path, out_dir=None, save_figures: bool = False):
    """Per-epoch action histograms for the i/j/k heads.

    Returns {"i": [n_values, n_epochs], "j": ..., "k": ...} count arrays
    normalized by epoch length; optionally writes heatMapI/J/K.png next to
    the TSV (postProcessing.py:84-160)."""
    df = _read_steps(file_path)
    epochs = np.sort(df["epoch"].unique())
    epoch_len = max(1, len(df) // max(1, len(epochs)))
    out = {}
    for col in ("i", "j", "k"):
        values = np.sort(df[col].unique())
        grid = np.zeros((len(values), len(epochs)))
        for e_idx, e in enumerate(epochs):
            sub = df[df["epoch"] == e][col]
            for v_idx, v in enumerate(values):
                grid[v_idx, e_idx] = (sub == v).sum()
        out[col] = grid / epoch_len
        if save_figures:
            import matplotlib
            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt
            import seaborn as sns
            fig, ax = plt.subplots(
                figsize=(max(4, len(epochs)), max(3, len(values))))
            sns.heatmap(out[col], linewidth=1, annot=True, ax=ax,
                        yticklabels=values, xticklabels=epochs)
            ax.set_title(f"HeatMap of choices of {col}")
            target = pathlib.Path(out_dir or
                                  pathlib.Path(file_path).parent)
            fig.savefig(target / f"heatMap{col.upper()}.png", dpi=110,
                        bbox_inches="tight")
            plt.close(fig)
    return out


def reward_surface(start_point: float = 2.8, end_point: float = 3.8,
                   lo: float = -3.0, hi: float = 3.0, step: float = 0.1,
                   save_path=None):
    """Reward landscape over fitted-line (slope, bias) space.

    The env reward is the integral of ``1 - (slope*x + bias)`` over the
    SNR region of interest (``calcReward``, ldpc_env.py:319-345); this
    evaluates it on a (slope, bias) grid — the reference's
    ``drawRewardSurface`` (postProcessing.py:266-290, whose tail is dead
    code: it computes three variants and has a syntax error in its
    return).  Returns (slope_grid, bias_grid, reward_grid); optionally
    saves a 3-D surface plot.
    """
    bias = np.arange(lo, hi, step)
    slope = np.arange(lo, hi, step)
    slope, bias = np.meshgrid(slope, bias)
    # ∫ (1 - (slope·x + bias)) dx over [start, end]
    width = end_point - start_point
    reward = (width
              - 0.5 * slope * (end_point ** 2 - start_point ** 2)
              - bias * width)
    if save_path is not None:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        from matplotlib import cm
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        surf = ax.plot_surface(slope, bias, reward, cmap=cm.coolwarm,
                               linewidth=0, antialiased=False)
        ax.set_xlabel("slope")
        ax.set_ylabel("bias")
        ax.set_zlabel("reward")
        fig.colorbar(surf, shrink=0.5, aspect=5)
        fig.savefig(save_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return slope, bias, reward
