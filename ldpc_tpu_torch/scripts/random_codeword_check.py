"""All-zero against random-codeword Monte-Carlo validation.

The port's counterpart of the JAX package's
``scripts/random_codeword_check.py``.  The reference (like almost every LDPC
study) transmits only the all-zero codeword (ldpc.py:409-411): valid for a
linear code over a symmetric channel with a symmetric decoder, but an
assumption until measured.  For near-earth and 802.11n rate 5/6 this runs
the same sweep twice on the torch engine (unstaged, float32), once with the
all-zero word and once with random messages systematically encoded
(``codes/encode.py``) and errors counted against the TRANSMITTED word, and
checks that each point's BERs agree within their combined frame-clustered
95% CIs.  It also checks the encoder against H on real channel words.

Writes ``ldpc_tpu_torch/data/random_codeword.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.random_codeword_check

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.random_codeword_check \\
        --words 32 --iters 8 --codes wifi --out /tmp/random_codeword
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..codes import near_earth_code, wifi_code
from ..codes.io import load_code_instance
from ..sim.evaluate import evaluate_code
from ..sim.stats import frame_ber_ci
from .studies import artifact_base, stamp, study_device, write_artifact

# operating and waterfall-edge points of each code family
CASES = {"near-earth": (near_earth_code, [3.0, 3.4]),
         "wifi": (wifi_code, [2.5, 3.5])}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--codes", nargs="+", default=["near-earth", "wifi"],
                    help="near-earth, wifi, or instance:<path>[@snr1,snr2] "
                         "(a saved code instance)")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/random_codeword on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    cases = {}
    for name in args.codes:
        if name.startswith("instance:"):
            path, _, snr_s = name[len("instance:"):].partition("@")
            snrs = ([float(x) for x in snr_s.split(",")] if snr_s
                    else [3.0, 3.2])
            cases["instance:" + os.path.basename(path)[:24]] = (
                load_code_instance(path)[0], snrs)
        else:
            make, snrs = CASES[name]
            cases[name] = (make(), snrs)

    out = {"words_per_point": args.words, "max_iters": args.iters,
           "seed": args.seed, **stamp(dev), "engine": "torch",
           "codes": {}}
    all_ok = True
    for name, (code, snrs) in cases.items():
        entry = {"n": code.n, "k": code.k, "snr_points": snrs, "points": []}
        runs = {}
        for mode in ("zero", "random"):
            t0 = time.perf_counter()
            runs[mode] = evaluate_code(
                code, snrs, args.words, args.iters, seed=args.seed,
                batch_size=min(args.batch, args.words), engine="torch",
                staged=False, codewords=mode, verbose=True, device=dev)
            print(f"[{name}] {mode}: {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        for snr in snrs:
            point = {"snr_db": snr}
            for mode, st in runs.items():
                sel = st.column("snr") == snr
                errs = st.column("errors_decoded")[sel].astype(np.float64)
                ber, half = frame_ber_ci(errs, code.n)
                point[mode] = {"ber": ber, "ci95_half": half,
                               "fer": float(st.column(
                                   "frame_errors")[sel].mean()),
                               "avg_iters": float(st.column(
                                   "iterations")[sel].mean())}
            gap = abs(point["zero"]["ber"] - point["random"]["ber"])
            band = point["zero"]["ci95_half"] + point["random"]["ci95_half"]
            point["agree_within_ci"] = bool(
                gap <= band or (point["zero"]["ber"] == 0
                                and point["random"]["ber"] == 0))
            all_ok &= point["agree_within_ci"]
            print(f"[{name}] @{snr}: zero {point['zero']['ber']:.4e} "
                  f"± {point['zero']['ci95_half']:.1e}  random "
                  f"{point['random']['ber']:.4e} ± "
                  f"{point['random']['ci95_half']:.1e}  agree="
                  f"{point['agree_within_ci']}", flush=True)
            entry["points"].append(point)
        out["codes"][name] = entry
    out["all_points_agree"] = bool(all_ok)

    rows = ["# All-zero vs random-codeword validation", "",
            f"{args.words} words a point, {args.iters} iterations, the torch "
            "engine (float32, unstaged), errors counted against the "
            "transmitted word on the random path "
            f"(`ldpc_tpu_torch/scripts/random_codeword_check.py`; "
            f"{out['device']}; kernel hash `{out['kernel_hash'][:12]}`).",
            "", "| code | SNR (dB) | all-zero BER (95% CI) | "
            "random-codeword BER (95% CI) | agree |", "|---|---|---|---|---|"]
    for name, entry in out["codes"].items():
        for p in entry["points"]:
            rows.append(
                f"| {name} | {p['snr_db']} | "
                f"{p['zero']['ber']:.4e} ± {p['zero']['ci95_half']:.1e} | "
                f"{p['random']['ber']:.4e} ± "
                f"{p['random']['ci95_half']:.1e} | "
                f"{'yes' if p['agree_within_ci'] else 'NO'} |")
    rows += ["", f"All points agree within combined CIs: **{all_ok}**."]
    write_artifact(artifact_base("random_codeword", args.out, dev), out,
                   rows)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
