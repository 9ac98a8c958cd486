"""Reward against floor across every deeply re-evaluated candidate.

The port's counterpart of the JAX package's
``scripts/reward_floor_frontier.py``.  Whether a high plain reward (a steep
waterfall over 3.0-3.8 dB) and a low FER floor at 3.8 dB are achievable
together: this pools the re-evaluated candidates of selection artifacts
(``floor_topk_select``'s, or a search summary's ``selection``, as
``rl_search_wide`` writes) with the chain members of a ``chain_scoreboard``
artifact, and reports the pooled points (plain re-evaluated reward, FER and
its Wilson interval) and the measured frontier: the points no other point
beats on both.  The figure (FER on a log axis, reward up; the chain
members starred) is drawn only where matplotlib is installed.  No decode.

Defaults: the port's own artifacts in ``ldpc_tpu_torch/data/``.  Writes
``ldpc_tpu_torch/data/reward_floor_frontier.{json,md}`` (and ``.png`` with
matplotlib; or ``--out``), stamped with the port's kernel hash and the
device.

On the card::

    python -m ldpc_tpu_torch.scripts.reward_floor_frontier

On the CPU::

    LDPC_TPU_PLATFORM=cpu python -m \\
        ldpc_tpu_torch.scripts.reward_floor_frontier --selections a.json \\
        --scoreboard chain_scoreboard.json --out /tmp/frontier
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .studies import (DATA, artifact_base, can_draw, stamp, study_device,
                      write_artifact)

FLOOR_SNR = 3.8
FLOOR_CLIP = 3e-6          # the log axis' lowest FER


def candidates(path: str, floor_snr: float = FLOOR_SNR):
    """(reward_mean, FER at ``floor_snr``, its Wilson interval) of every
    re-evaluated candidate of a selection artifact."""
    with open(path) as f:
        d = json.load(f)
    sel = d.get("selection", d)           # a summary nests its candidates
    for c in sel.get("candidates", []):
        if "fer_floor" in c:              # one floor point
            yield (c["reward_mean"], c["fer_floor"], c["fer_wilson95"])
        else:                             # a list of floor terms
            fl = [f for f in c.get("floors", [])
                  if f["snr_db"] == floor_snr]
            if fl:
                yield (c["reward_mean"], fl[0]["fer"],
                       fl[0]["fer_wilson95"])


def chain_points(scoreboard: dict) -> list:
    """(name, reward, FER, lo, hi) of each code of a scoreboard artifact."""
    return [(name, c["reward_mean"], c["fer_floor"], *c["fer_wilson95"])
            for name, c in scoreboard["codes"].items()]


def frontier(points: list) -> list:
    """The (reward, FER) points that no other point beats on both: a
    higher reward and a FER no higher, or a lower FER and a reward no
    lower; by FER, then reward."""
    out = []
    for r, f in points:
        if not any((r2 > r and f2 <= f) or (f2 < f and r2 >= r)
                   for r2, f2 in points):
            out.append((r, f))
    return sorted(set(out), key=lambda p: (p[1], -p[0]))


def draw(pools: dict, chain: list, path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 4.6))
    for label, pts in pools.items():
        if not pts:
            continue
        xs = [max(p[1], FLOOR_CLIP) for p in pts]
        lo = [max(x - max(p[2][0], FLOOR_CLIP), 0.0) for x, p in zip(xs, pts)]
        hi = [max(p[2][1], FLOOR_CLIP) - x for x, p in zip(xs, pts)]
        ax.errorbar(xs, [p[0] for p in pts], xerr=[lo, hi], fmt="o", ms=4,
                    label=label, alpha=0.75, lw=1, capsize=2)
    for name, r, fer, lo, hi in chain:
        x = max(fer, FLOOR_CLIP)
        ax.errorbar([x], [r], xerr=[[max(x - max(lo, FLOOR_CLIP), 0.0)],
                                    [max(hi, FLOOR_CLIP) - x]],
                    fmt="*", ms=13, color="#222222", capsize=3, lw=1)
        ax.annotate(name, (x, r), textcoords="offset points",
                    xytext=(6, 5), fontsize=8)
    ax.set_xscale("log")
    ax.set_xlabel(f"FER @ {FLOOR_SNR} dB (Wilson 95% CI; clipped at "
                  f"{FLOOR_CLIP:g})")
    ax.set_ylabel("plain re-evaluated reward (∫(1−fit), 3.0-3.8 dB)")
    ax.set_title("Reward vs floor — every deeply re-evaluated candidate")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8, loc="lower right")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--selections", nargs="*",
                    default=[str(DATA / "floor_topk_select.json"),
                             str(DATA / "rl_search_wide.json")],
                    help="selection artifacts whose candidates are pooled")
    ap.add_argument("--scoreboard",
                    default=str(DATA / "chain_scoreboard.json"),
                    help="a chain_scoreboard artifact: the chain members")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: ldpc_tpu_torch/data/"
                         "reward_floor_frontier on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    pools = {}
    for path in args.selections:
        if not os.path.exists(path):
            print(f"[frontier] skip {path}: not found", flush=True)
            continue
        pools[path] = list(candidates(path))
    chain = []
    if os.path.exists(args.scoreboard):
        with open(args.scoreboard) as f:
            chain = chain_points(json.load(f))
    pooled = [(p[0], p[1]) for pts in pools.values() for p in pts]
    front = frontier(pooled + [(r, fer) for _, r, fer, _, _ in chain])
    base = artifact_base("reward_floor_frontier", args.out, dev)
    figure = None
    if base is not None and can_draw() and (pooled or chain):
        figure = f"{base}.png"
        base.parent.mkdir(parents=True, exist_ok=True)
        draw(pools, chain, figure)
    out = {"floor_snr_db": FLOOR_SNR, **stamp(dev),
           "selections": {k: [list(p[:2]) + [list(p[2])] for p in v]
                          for k, v in pools.items()},
           "chain": [list(c) for c in chain],
           "frontier": [list(p) for p in front], "figure": figure}
    md = ["# Reward against floor: every re-evaluated candidate", "",
          f"Pooled from {len(pools)} selection artifact(s) and "
          f"`{args.scoreboard}` (`ldpc_tpu_torch/scripts/"
          f"reward_floor_frontier.py`; {out['device']}); "
          + (f"figure `{figure}`." if figure else "no figure."),
          "", "| source | candidates |", "|---|---|"]
    md += [f"| `{k}` | {len(v)} |" for k, v in pools.items()]
    md += ["", f"| chain member | reward | FER@{FLOOR_SNR} |",
           "|---|---|---|"]
    md += [f"| {n} | {r:.5f} | {fer:.3e} |" for n, r, fer, _, _ in chain]
    md += ["", "Frontier (no point has a higher reward at a FER no "
           "higher): " + ", ".join(f"({r:.5f}, {fer:.2e})"
                                     for r, fer in front) + "."]
    write_artifact(base, out, md)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
