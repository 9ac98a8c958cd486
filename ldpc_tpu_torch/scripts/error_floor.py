"""Deep error-floor sweep: million-word BER/FER points past the waterfall.

The port's counterpart of the JAX package's ``scripts/error_floor.py``.  The
reference's published curve stops at 200 transmissions a point
(common.py:112-114 reports BER 0 at 3.44 dB realized, a resolution floor of
about 6e-7); a million near-earth words a point resolve BER to about 1e-10
and say whether the code has an error floor in the 3.6-4.2 dB region.

The sweep is the resumable staged ``evaluate_code`` (12 -> 50, batches of
32,768) on the cuda engine (the fused kernel, bfloat16 state) by default,
with a checkpoint after every point.  The checkpoint's default file is
named by a hash of the run's settings (code, engine, words, points,
budgets, batch, seed) and of the port's decode-path sources, so a run
resumes only a run like itself.  Writes
``ldpc_tpu_torch/data/error_floor.{json,md}`` (or ``--out``; a code
instance writes ``error_floor_instance_<hash>``), stamped with the port's
kernel hash and the card's name and power limit, with Wilson 95% intervals
on the FER.

On the card::

    python -m ldpc_tpu_torch.scripts.error_floor [--words 1048576] \\
        [--snr 3.6 3.8 4.0 4.2]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.error_floor \\
        --code wifi --words 64 --snr 3.0 4.0 --batch 16 --no-write
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..codes import near_earth_code, wifi_code
from ..codes.io import load_code_instance
from ..sim.evaluate import evaluate_code
from ..sim.stats import wilson_interval
from ..utils.provenance import kernel_source_hash
from .studies import artifact_base, stamp, study_device, write_artifact

SEED = 8146


def default_checkpoint(args: argparse.Namespace, code_key: str) -> str:
    """The checkpoint file of a run with these settings, in the temporary
    directory: one file for each (code, engine, words, points, budgets,
    batch, seed, decode-path sources)."""
    key = json.dumps([code_key, args.engine, args.words, args.snr,
                      args.max_iters, args.batch, args.phase_iters, SEED,
                      kernel_source_hash()])
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(),
                        f"error_floor_checkpoint_{digest}.npz")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=1 << 20)
    ap.add_argument("--snr", type=float, nargs="+",
                    default=[3.6, 3.8, 4.0, 4.2])
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--engine", default="cuda", choices=["torch", "cuda"])
    ap.add_argument("--phase-iters", default="12")
    ap.add_argument("--code", default="near-earth",
                    help="near-earth (the study), wifi (CPU smoke) or "
                         "instance:<path> (a saved code instance)")
    ap.add_argument("--no-write", action="store_true",
                    help="write no artifact (smoke runs)")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/error_floor on the card)")
    ap.add_argument("--checkpoint", default=None,
                    help="resume from and save to this file (default: a "
                         "file named by the run's settings)")
    args = ap.parse_args(argv)

    dev = study_device()
    name = "error_floor"
    code_key = args.code
    if args.code.startswith("instance:"):
        path = args.code[len("instance:"):]
        code = load_code_instance(path)[0]
        with open(path, "rb") as f:
            code_key = hashlib.sha256(f.read()).hexdigest()
        args.code = "instance:" + os.path.basename(path)[:24]
        # never clobber another instance's study: the z_Mb_Nb_sha
        # file name is unique per code
        name = "error_floor_instance_" + args.code.split("_")[-1][:12]
    elif args.code == "wifi":
        code = wifi_code()
    else:
        code = near_earth_code()
    checkpoint = args.checkpoint or default_checkpoint(args, code_key)
    t0 = time.perf_counter()
    stats = evaluate_code(
        code, args.snr, args.words, args.max_iters, seed=SEED,
        batch_size=args.batch, staged=True,
        phase1_iters=[int(p) for p in args.phase_iters.split(",")],
        engine=args.engine, checkpoint_path=checkpoint, verbose=True,
        device=dev)
    elapsed = time.perf_counter() - t0

    snr_col = np.asarray(stats.column("snr"))
    w_col = np.asarray(stats.column("weight"))
    errs_col = np.asarray(stats.column("errors_decoded"))
    fe_col = np.asarray(stats.column("frame_errors"))
    points = []
    for snr in args.snr:
        m = snr_col == snr
        words = int(w_col[m].sum())
        bit_errs = int(errs_col[m].sum())
        # a frame error: residual bit errors or no convergence
        frame_errs = int(fe_col[m].sum())
        _, lo, hi = wilson_interval(frame_errs, words)
        points.append({
            "snr_db": snr, "words": words, "bits": words * code.n,
            "bit_errors": bit_errs,
            "ber": bit_errs / (words * code.n) if words else None,
            "frame_errors": frame_errs,
            "fer": frame_errs / words if words else None,
            "fer_wilson95": [lo, hi],
        })
        print(f"[floor] {snr} dB: {words} words, BER "
              f"{points[-1]['ber']:.3e}, FER {points[-1]['fer']:.3e} "
              f"(95% CI {lo:.2e}-{hi:.2e})", flush=True)

    out = {"code": args.code, "n": code.n, "max_iters": args.max_iters,
           "engine": args.engine, "elapsed_s": elapsed, **stamp(dev),
           "points": points}
    md = ["# Deep error-floor sweep (beyond the reference's resolution)", "",
          f"{args.code} (n={code.n}), min-sum, max {args.max_iters} "
          f"iterations, {args.words:,} words a point decoded by the staged "
          f"{args.engine} engine in {elapsed:,.1f} s "
          f"(`ldpc_tpu_torch/scripts/error_floor.py`; {out['device']}; "
          f"kernel hash `{out['kernel_hash'][:12]}`).  The reference's "
          "published curve uses 200 words a point (common.py:112-114), a "
          "BER resolution floor of about 6e-7.", "",
          "| Eb/N0 (dB) | words | bit errors | BER | frame errors | FER "
          "| FER 95% CI |", "|---|---|---|---|---|---|---|"]
    for p in points:
        lo, hi = p["fer_wilson95"]
        md.append(f"| {p['snr_db']} | {p['words']:,} | {p['bit_errors']} | "
                  f"{p['ber']:.3e} | {p['frame_errors']} | {p['fer']:.3e} | "
                  f"{lo:.2e} – {hi:.2e} |")
    if not args.no_write:
        write_artifact(artifact_base(name, args.out, dev), out, md)
    print(json.dumps(out["points"][-1]), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
