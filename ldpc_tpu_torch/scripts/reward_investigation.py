"""Reward investigation: the reference's ``rewardInvestigation.ipynb`` as
computed numbers.

The port's counterpart of the JAX package's
``scripts/reward_investigation.py``.  The code-search reward is the area
between 1 and a line fitted to the (realized SNR, per-frame BER) scatter
of a sweep (``sim/reward.py``; ``ldpc_env.py:319-345``).  Five sections:

1. the fit: plain least squares against the recursive fit
   (``common.py:293-303``) on one measured 802.11n scatter (40 words a
   point over 2.0/2.4/2.8 dB, its waterfall);
2. the Monte-Carlo noise of the reward of one unchanged code: 24 seeds at
   10 and at 40 transmissions a point;
3. realized against nominal sigma (``ldpc.py:51-60``);
4. the near-earth baselines over 3.0-3.8 and 3.0-3.4 dB
   (``postProcessing.py:18-19``) from the port's own measured waterfall,
   ``ldpc_tpu_torch/data/ber_parity.json`` (the torch engine's f32 BER, the
   XLA engine's counterpart);
5. degenerate scatters: all-zero BER and a single point.

The sweeps decode through the fused kernel (``engine="cuda"``, bf16 state;
its plain version on the CPU).  Writes
``ldpc_tpu_torch/data/reward_investigation.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.reward_investigation

On the CPU, at the same sizes::

    LDPC_TPU_PLATFORM=cpu python -m \\
        ldpc_tpu_torch.scripts.reward_investigation --out /tmp/ri
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..codes import wifi_code
from ..sim.evaluate import evaluate_code
from ..sim.reward import (BAD_CANDIDATE_REWARD, calc_reward,
                          recursive_linear_fit)
from .studies import (DATA, artifact_base, stamp, study_device, sweep_kw,
                      write_artifact)

# the window on 802.11n's waterfall: at 3.0+ dB its scatters are degenerate
SNR_POINTS = [2.0, 2.4, 2.8]
FIT_SEED = 7134066
REFERENCE_3P0_3P8 = 0.7958451612664468    # postProcessing.py:18
REFERENCE_3P0_3P4 = 0.3965108116285836    # postProcessing.py:19
SEEDS = 24               # sweeps a transmission count (section 2)
TX = (10, 40)            # transmissions a point of section 2's sweeps
FIT_WORDS = 40           # words a point of section 1's scatter
MAX_ITERS = 50
BER_PARITY = DATA / "ber_parity.json"   # section 4's measured waterfall


def near_earth_baselines(parity: dict) -> dict:
    """The near-earth rewards of both windows from a ``ber_parity``
    artifact's measured points (realized SNR, the torch engine's BER)."""
    pts = sorted((p["realized_snr_db"], p["torch_f32"]["ber"])
                 for p in parity["points"].values())
    snrs = np.asarray([s for s, _ in pts])
    bers = np.asarray([b for _, b in pts])
    return {
        "measured_points": {f"{s:.4f}": float(b) for s, b in pts},
        "reward_3p0_3p8": calc_reward(snrs, bers, [3.0, 3.8]),
        "reward_3p0_3p4": calc_reward(snrs, bers, [3.0, 3.4]),
        "reference_3p0_3p8": REFERENCE_3P0_3P8,
        "reference_3p0_3p4": REFERENCE_3P0_3P4,
    }


def investigation_md(out: dict) -> str:
    f, sg, d = out["fit"], out["sigma"], out["degenerate"]
    noise = out["mc_noise"]
    rows = "\n".join(
        f"| {t} | {n['mean']:.4f} | {n['std']:.4f} | {n['min']:.4f} | "
        f"{n['max']:.4f} |" for t, n in noise.items())
    md = f"""# Reward investigation (rewardInvestigation.ipynb equivalent)

The code-search reward is the area between 1 and a line fitted to the
(realized SNR, per-frame BER) scatter over the sweep window
(`sim/reward.py`; ldpc_env.py:319-345).  Computed by
`ldpc_tpu_torch/scripts/reward_investigation.py` ({out['device']}; kernel
hash `{out['kernel_hash'][:12]}`; the fused kernel, bf16 state;
{out['seconds']:.1f} s).

## 1. What the recursive fit does to the scatter

On a measured 802.11n scatter ({f['points']} frames over {SNR_POINTS} dB),
`recursive_linear_fit` kept {f['kept']}/{f['points']} points after
{f['rounds']} rounds; slope/bias moved from
{f['plain_slope_bias'][0]:+.4f}/{f['plain_slope_bias'][1]:+.4f} (plain least
squares) to {f['recursive_slope_bias'][0]:+.4f}/\
{f['recursive_slope_bias'][1]:+.4f}; reward {f['reward']:.4f}.

## 2. The Monte-Carlo noise floor of the reward

The reward of one unchanged 802.11n code over {out['seeds']} seeds:

| transmissions/pt | reward mean | std | min | max |
|---|---|---|---|---|
{rows}

## 3. Realized against nominal noise

sigma nominal {sg['nominal_mean']:.4f} against realized
{sg['realized_mean']:.4f} (largest per-frame relative deviation
{sg['max_rel_dev']:.3f}).

## 4. Near-earth reward baselines from the port's measured waterfall
"""
    base = out["near_earth_baselines"]
    if base:
        md += f"""
From `ldpc_tpu_torch/data/ber_parity.json` (16,384 words a point, the torch
engine's f32 BER at the realized SNRs):

| window | measured | reference constant (postProcessing.py:18-19) |
|---|---|---|
| 3.0-3.8 dB | {base['reward_3p0_3p8']:.4f} | {REFERENCE_3P0_3P8:.4f} |
| 3.0-3.4 dB | {base['reward_3p0_3p4']:.4f} | {REFERENCE_3P0_3P4:.4f} |
"""
    else:
        md += "\nNo `ber_parity.json` artifact: not computed.\n"
    md += f"""
## 5. Degenerate scatters

* All-zero BER: reward {d['all_zero_ber']:.4f}, the window's width (the
  largest attainable value; the last valid fit is latched where the
  reference's empty polyfit crashes).
* A single measured point: {d['single_point']:.1f} (= the bad-candidate
  reward {d['bad_candidate']:.1f}, ldpc_env.py:120).
"""
    return md


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: ldpc_tpu_torch/data/"
                         "reward_investigation on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    code = wifi_code()
    t_start = time.perf_counter()
    out: dict = {"snr_points": SNR_POINTS, "seeds": SEEDS,
                 "max_iters": MAX_ITERS, **stamp(dev)}
    # 1 + 3: one evaluation, the fit comparison and the sigma check
    stats = evaluate_code(code, SNR_POINTS, FIT_WORDS, MAX_ITERS,
                          batch_size=FIT_WORDS, seed=FIT_SEED,
                          **sweep_kw(dev))
    s_snr, s_ber, *_ = stats.get_stats_v2()
    plain = np.polyfit(s_snr, s_ber, 1)
    xk, _, rec, _, rounds = recursive_linear_fit(s_snr, s_ber)
    out["fit"] = {
        "points": int(len(s_snr)), "kept": int(len(xk)),
        "rounds": int(rounds),
        "plain_slope_bias": [float(v) for v in plain],
        "recursive_slope_bias": [float(v) for v in rec],
        "reward": calc_reward(s_snr, s_ber, SNR_POINTS),
    }
    sig, siga = stats.column("sigma"), stats.column("sigma_actual")
    out["sigma"] = {"nominal_mean": float(sig.mean()),
                    "realized_mean": float(siga.mean()),
                    "max_rel_dev": float(np.max(np.abs(siga - sig) / sig))}

    # 2: the reward's noise floor against the transmissions
    out["mc_noise"] = {}
    for t in TX:
        rewards = []
        for seed in range(SEEDS):
            st = evaluate_code(code, SNR_POINTS, t, MAX_ITERS,
                               batch_size=t, seed=1000 + seed,
                               **sweep_kw(dev))
            ss, sb, *_ = st.get_stats_v2()
            rewards.append(calc_reward(ss, sb, SNR_POINTS))
        r = np.asarray(rewards)
        out["mc_noise"][str(t)] = {
            "mean": float(r.mean()), "std": float(r.std()),
            "min": float(r.min()), "max": float(r.max()),
            "rewards": [float(v) for v in r]}
        print(f"[reward] wifi, {t} tx: reward {r.mean():.4f} ± "
              f"{r.std():.4f}  [{r.min():.4f}, {r.max():.4f}]",
              file=sys.stderr, flush=True)

    # 4: the near-earth baselines from the port's measured waterfall
    try:
        with open(BER_PARITY) as f:
            out["near_earth_baselines"] = near_earth_baselines(json.load(f))
    except FileNotFoundError:
        out["near_earth_baselines"] = None

    # 5: degenerate scatters
    out["degenerate"] = {
        "all_zero_ber": float(calc_reward([3.0, 3.2, 3.4], [0.0, 0.0, 0.0],
                                          SNR_POINTS)),
        "single_point": float(calc_reward([3.0], [0.01], SNR_POINTS)),
        "bad_candidate": BAD_CANDIDATE_REWARD}
    out["seconds"] = time.perf_counter() - t_start
    write_artifact(artifact_base("reward_investigation", args.out, dev), out,
                   investigation_md(out).rstrip("\n").split("\n"))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
