"""Score code instances under the discovery chain's protocol.

The port's counterpart of the JAX package's ``scripts/chain_scoreboard.py``.
The chain's figure of merit is the plain fitted-line reward (512
transmissions x 5 SNR points x 5 seeds, the integral of 1 - fit over
3.0-3.8 dB, the reference's reward of ``gym_ldpc/envs/ldpc_env.py:319-345``)
and a deep FER floor (262,144 words at 3.8 dB, staged, batches of 16,384),
combined as ``penalized = reward - penalty * FER``.

Codes are ``name=code`` pairs, or bare carried names; a code is a carried
name, a JSON code file or a ``.npz`` instance (``studies.resolve_code``).
Near-earth is always included unless ``--no-near-earth``.  With no codes,
the five carried chain members (``data/chain/``) are scored: the JAX
artifact's six rows.  The re-evaluation and the floor both decode through
the fused kernel (``engine="cuda"``, bf16 state; its plain version on the
CPU).

Writes ``ldpc_tpu_torch/data/chain_scoreboard.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.chain_scoreboard [s47 floor2=x.npz]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.chain_scoreboard \\
        --smoke --out /tmp/chain_scoreboard
"""

from __future__ import annotations

import argparse
import sys
import time

from ..analysis.postprocess import reeval_reward
from ..codes import near_earth_code, wifi_code
from ..sim.evaluate import evaluate_code
from .studies import (artifact_base, chain_index, fer_point, resolve_code,
                      stamp, study_device, sweep_kw, write_artifact)

FLOOR_SEED = 515151


def score_codes(codes: dict, *, snr_points, reeval_tx: int, reeval_seeds,
                iters: int, floor_snr: float, floor_words: int,
                penalty: float, dev, floor_seed: int = FLOOR_SEED) -> dict:
    """name -> reward_mean, reward_std, fer_floor, fer_wilson95,
    frame_errors, words, penalized, seconds: the chain's protocol.  The
    first code is decoded once untimed (one re-evaluation seed, one floor
    batch), so that no code's ``seconds`` holds the kernel's build or the
    first calls' loading."""
    first = next(iter(codes.values()))
    batch = min(16384, floor_words)
    t0 = time.perf_counter()
    reeval_reward(first, tuple(snr_points), reeval_tx, iters,
                  list(reeval_seeds)[:1], **sweep_kw(dev))
    evaluate_code(first, [floor_snr], batch, iters, seed=floor_seed,
                  **sweep_kw(dev, batch, iters))
    print(f"[warm] {first.name}: {time.perf_counter() - t0:.2f} s, untimed",
          flush=True)
    out = {}
    for name, code in codes.items():
        t0 = time.perf_counter()
        rm, rs, _ = reeval_reward(code, tuple(snr_points), reeval_tx, iters,
                                  reeval_seeds, **sweep_kw(dev))
        stats = evaluate_code(code, [floor_snr], floor_words, iters,
                              seed=floor_seed,
                              **sweep_kw(dev, floor_words, iters))
        p = fer_point(stats, floor_snr)
        out[name] = {
            "reward_mean": rm, "reward_std": rs,
            "fer_floor": p["fer"], "fer_wilson95": p["fer_wilson95"],
            "frame_errors": p["frame_errors"], "words": p["words"],
            "penalized": rm - penalty * p["fer"],
            "seconds": time.perf_counter() - t0,
        }
        lo, hi = p["fer_wilson95"]
        print(f"[{name}] reward {rm:.5f} ± {rs:.5f}  FER@{floor_snr} "
              f"{p['fer']:.3e} [{lo:.1e},{hi:.1e}]  penalized "
              f"{out[name]['penalized']:.5f}", flush=True)
    return out


def ranked(codes: dict) -> list[tuple[str, dict]]:
    """The scoreboard's rows, best penalized objective first."""
    return sorted(codes.items(), key=lambda kv: -kv[1]["penalized"])


def score_row(name: str, c: dict) -> str:
    """One row of the JAX scripts' chain table."""
    lo, hi = c["fer_wilson95"]
    return (f"| {name} | {c['reward_mean']:.5f} ± {c['reward_std']:.5f} | "
            f"{c['fer_floor']:.3e} [{lo:.1e}, {hi:.1e}] | "
            f"{c['penalized']:.5f} |")


def scoreboard_md(out: dict) -> list[str]:
    rows = [f"# Chain scoreboard (λ={out['penalty']} @{out['floor_snr_db']} "
            f"dB, {out['floor_words']:,} floor words)", "",
            f"| code | plain reward | FER@{out['floor_snr_db']} (Wilson 95%) "
            "| penalized objective |", "|---|---|---|---|"]
    rows += [score_row(name, c) for name, c in ranked(out["codes"])]
    rows += ["", f"`ldpc_tpu_torch/scripts/chain_scoreboard.py`, the fused "
             f"kernel (bf16 state) for the re-evaluation and the floor; "
             f"{out['device']}; kernel hash `{out['kernel_hash'][:12]}`."]
    return rows


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("codes", nargs="*",
                    help="name=code pairs or carried names (near_earth is "
                         "always included as the root baseline; none: the "
                         "carried chain)")
    ap.add_argument("--penalty", type=float, default=30.0)
    ap.add_argument("--floor-snr", type=float, default=3.8)
    ap.add_argument("--floor-words", type=int, default=262144)
    ap.add_argument("--reeval-tx", type=int, default=512)
    ap.add_argument("--reeval-seeds", type=int, nargs="+",
                    default=[11, 12, 13, 14, 15])
    ap.add_argument("--snr", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6, 3.8])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/chain_scoreboard on the card)")
    ap.add_argument("--no-near-earth", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny pass on the 802.11n rate-5/6 code only")
    args = ap.parse_args(argv)

    dev = study_device()
    instances = {}
    if args.smoke:
        codes = {"wifi": wifi_code()}
        args.snr, args.floor_snr = [2.0, 2.6, 3.2], 3.2
        args.reeval_tx, args.reeval_seeds = 4, [11]
        args.floor_words, args.iters = 32, 10
    else:
        codes = {} if args.no_near_earth else {
            "near_earth": near_earth_code()}
        for pair in args.codes or chain_index()["codes"]:
            name, _, spec = pair.partition("=")
            codes[name], instances[name] = resolve_code(spec or name)

    out = {"penalty": args.penalty, "floor_snr_db": args.floor_snr,
           "floor_words": args.floor_words, "snr_points": args.snr,
           "reeval": {"transmissions": args.reeval_tx,
                      "seeds": args.reeval_seeds},
           "instances": instances, **stamp(dev)}
    out["codes"] = score_codes(
        codes, snr_points=args.snr, reeval_tx=args.reeval_tx,
        reeval_seeds=args.reeval_seeds, iters=args.iters,
        floor_snr=args.floor_snr, floor_words=args.floor_words,
        penalty=args.penalty, dev=dev)
    write_artifact(artifact_base("chain_scoreboard", args.out, dev), out,
                   scoreboard_md(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
