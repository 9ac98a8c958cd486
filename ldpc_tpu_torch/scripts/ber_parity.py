"""BER parity study: the measured near-earth waterfall with confidence
intervals, two engines on the same LLRs, and the native engine beside them.

The port's counterpart of the JAX package's ``scripts/ber_parity.py``:

* decode ``--words`` words a point with the torch engine (float32, staged
  12 -> 50) at the reference's realized SNR points (2.9914, 3.1541, 3.3076,
  3.4404 dB, common.py:112-114) and at 3.0-3.6 dB;
* decode the same LLRs with the cuda engine (the fused kernel, bfloat16
  state, staged 12 -> 50);
* frame-clustered BER confidence intervals (bit errors arrive in bursts
  within a frame, so the frame is the independent unit) and Wilson FER
  intervals; ``engines_agree``: the BERs within their combined CIs,
  ``fer_overlap``: the FER intervals overlap;
* the native C++ engine (``ldpc_tpu_torch/native``, float64 on a dense H)
  on ``--native-words`` words at 3.2 dB against the torch engine on the
  same words: their BERs and word-exact and iteration agreement;
* the reference's published points overlaid: is each inside our CI plus
  the spread of a 200-frame run, computed from our per-frame errors?

Writes ``ldpc_tpu_torch/data/ber_parity.{json,md}`` (or ``--out``), stamped
with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.ber_parity [--words 16384]

CPU smoke (plain versions, a few words)::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.ber_parity \\
        --words 8 --native-words 4 --max-iters 8 --out /tmp/ber_parity
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..codes import near_earth_code
from ..sim.evaluate import StagedDecoder, transmit
from ..sim.stats import frame_ber_ci, wilson_interval
from .studies import artifact_base, stamp, study_device, sync, write_artifact

# the reference's published points: (realized SNR dB, decoded BER),
# common.py:112-114, each from a 200-frame run
REFERENCE_POINTS = [(2.9914, 2.3539e-2), (3.1541, 1.3595e-2),
                    (3.3076, 1.0794e-2), (3.4404, 0.0)]
REFERENCE_FRAMES = 200
NOMINAL_POINTS = (3.0, 3.2, 3.4, 3.6)
NATIVE_SNR = 3.2
PHASE1_ITERS = 12
SEED = 20260817
ENGINES = {"torch_f32": "torch", "cuda_bf16": "cuda"}


def snr_points() -> list[float]:
    return sorted({p[0] for p in REFERENCE_POINTS} | set(NOMINAL_POINTS))


def _llr(code, words: int, snr: float, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    snr_db = torch.full((words,), float(snr), dtype=torch.float32,
                        device=dev)
    return transmit(code.n, snr_db, generator=gen)


def _decode(dec, llr, dev):
    sync(dev)
    t0 = time.perf_counter()
    out = [x.cpu().numpy() for x in dec(llr)]
    return out, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=16384)
    ap.add_argument("--native-words", type=int, default=384,
                    help="native-engine cross-check sample (0 = skip)")
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--skip-cuda", action="store_true")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/ber_parity on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    code = near_earth_code()
    # the 12-iteration first stage, where it lies below the budget
    phases = [PHASE1_ITERS] if PHASE1_ITERS < args.max_iters else []
    engines = {name: StagedDecoder(code, args.max_iters,
                                   phase1_iters=phases, engine=engine,
                                   device=dev)
               for name, engine in ENGINES.items()
               if not (args.skip_cuda and engine == "cuda")}
    results: dict = {"words_per_point": args.words, "n": code.n,
                     "max_iters": args.max_iters, **stamp(dev),
                     "engines": {n: {"engine": e, "phase1_iters": phases,
                                     "store": "bfloat16" if e == "cuda"
                                     else "float32"}
                                 for n, e in ENGINES.items()
                                 if n in engines},
                     "points": {}}
    per_frame_errs: dict = {}
    for snr in snr_points():
        llr, _, sigma_actual, unc = _llr(code, args.words, snr,
                                         SEED * 100000 + round(snr * 1e4),
                                         dev)
        realized = float(10.0 * torch.log10(
            0.5 / torch.mean(sigma_actual.double() ** 2)))
        point: dict = {"realized_snr_db": realized,
                       "uncoded_ber": int(unc.sum()) / (args.words * code.n)}
        for name, dec in engines.items():
            (errs, iters, _), dt = _decode(dec, llr, dev)
            ber, half = frame_ber_ci(errs, code.n)
            fer, flo, fhi = wilson_interval(int((errs > 0).sum()), args.words)
            point[name] = {"ber": ber, "ber_ci95_half": half, "fer": fer,
                           "fer_ci95": [flo, fhi],
                           "avg_iters": float(iters.mean()),
                           "bit_per_s": args.words * code.n / dt}
            if name == "torch_f32":
                per_frame_errs[snr] = errs
            print(f"[parity] snr {snr:.4f} (realized {realized:.4f}) {name}: "
                  f"BER {ber:.4e} ± {half:.1e}  FER {fer:.4f} "
                  f"[{flo:.4f},{fhi:.4f}]  {dt:.2f}s", file=sys.stderr,
                  flush=True)
        if "cuda_bf16" in point:
            t, c = point["torch_f32"], point["cuda_bf16"]
            point["engines_agree"] = bool(
                abs(t["ber"] - c["ber"]) <= t["ber_ci95_half"] +
                c["ber_ci95_half"] + 1e-9)
            point["fer_overlap"] = bool(
                t["fer_ci95"][0] <= c["fer_ci95"][1] and
                c["fer_ci95"][0] <= t["fer_ci95"][1])
        results["points"][f"{snr:.4f}"] = point

    # the reference's points against our CI plus a 200-frame run's spread
    # (from our per-frame error distribution at the same realized SNR)
    results["reference"] = []
    for snr, ref_ber in REFERENCE_POINTS:
        pt = results["points"][f"{snr:.4f}"]["torch_f32"]
        errs = per_frame_errs[snr]
        spread = (1.96 * errs.std(ddof=1) / np.sqrt(REFERENCE_FRAMES) /
                  code.n)
        entry = {"snr_db": snr, "reference_ber": ref_ber,
                 "our_ber": pt["ber"], "our_ci95_half": pt["ber_ci95_half"],
                 "ref_run_ci95_half": float(spread),
                 "within_band": bool(abs(pt["ber"] - ref_ber) <=
                                     pt["ber_ci95_half"] + spread)}
        if ref_ber == 0.0:
            # the chance that a 200-frame run at our FER sees no error
            entry["p_zero_in_200_frames"] = float(
                (1 - pt["fer"]) ** REFERENCE_FRAMES)
        results["reference"].append(entry)

    if args.native_words:
        results["native_crosscheck"] = _native(code, engines["torch_f32"],
                                               args, dev)

    rows = ["# BER parity: the port's torch and cuda engines on the same "
            "LLRs", "",
            f"Near-earth (8176, 7154), min-sum, stages {phases} -> "
            f"{args.max_iters} iterations, {args.words:,} words a point "
            f"(`ldpc_tpu_torch/scripts/ber_parity.py`; {results['device']}; "
            f"kernel hash `{results['kernel_hash'][:12]}`).", "",
            "| SNR (dB) | realized | uncoded BER | torch f32 BER (95% CI) | "
            "cuda bf16 BER (95% CI) | torch FER (Wilson 95%) | "
            "cuda FER (Wilson 95%) | avg iters | agree |",
            "|---|---|---|---|---|---|---|---|---|"]
    for snr in snr_points():
        pt = results["points"][f"{snr:.4f}"]
        t, c = pt["torch_f32"], pt.get("cuda_bf16")
        cell = (lambda e: f"{e['ber']:.3e} ± {e['ber_ci95_half']:.1e}")
        fcell = (lambda e: f"{e['fer']:.4f} [{e['fer_ci95'][0]:.4f}, "
                 f"{e['fer_ci95'][1]:.4f}]")
        agree = ("—" if c is None else "yes" if pt["engines_agree"] and
                 pt["fer_overlap"] else "NO")
        rows.append(f"| {snr:.4f} | {pt['realized_snr_db']:.4f} | "
                    f"{pt['uncoded_ber']:.3e} | {cell(t)} | "
                    f"{cell(c) if c else '—'} | {fcell(t)} | "
                    f"{fcell(c) if c else '—'} | {t['avg_iters']:.1f} | "
                    f"{agree} |")
    nat = results.get("native_crosscheck")
    if isinstance(nat, dict):
        rows += ["", f"Native C++ engine, {nat['words']} words at "
                 f"{nat['snr_db']} dB: BER {nat['ber']:.4e} ± "
                 f"{nat['ber_ci95_half']:.1e}, torch engine on the same "
                 f"words {nat['torch_ber_same_words']:.4e}; word-exact "
                 f"{nat['word_exact_agreement']:.3f}, iterations "
                 f"{nat['iters_exact_agreement']:.3f}."]
    ok_all = all(e["within_band"] for e in results["reference"]
                 if e["reference_ber"] > 0)
    rows += ["", f"Reference points within band: {ok_all}."]
    print("\n".join(rows), flush=True)
    write_artifact(artifact_base("ber_parity", args.out, dev), results, rows)
    return results


def _native(code, torch_dec, args, dev):
    """The native engine against the torch engine on the same words."""
    from .. import native
    if not native.available():
        return "unavailable"
    llr = _llr(code, args.native_words, NATIVE_SNR, SEED * 100000 + 777,
               dev)[0]
    llr_np = llr.cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    hard, _, iters_n, _ = native.native_min_sum_decode(
        code.to_dense(np.int8), llr_np, args.max_iters)
    dt = time.perf_counter() - t0
    errs_n = hard.sum(axis=1)
    ber, half = frame_ber_ci(errs_n, code.n)
    (errs_t, iters_t, _), _ = _decode(torch_dec, llr, dev)
    out = {"snr_db": NATIVE_SNR, "words": args.native_words,
           "ber": ber, "ber_ci95_half": half,
           "torch_ber_same_words": float(errs_t.mean()) / code.n,
           "word_exact_agreement": float(np.mean(errs_n == errs_t)),
           "iters_exact_agreement": float(np.mean(iters_n == iters_t)),
           "cpu_seconds": dt}
    print(f"[parity] native C++ {args.native_words} words @{NATIVE_SNR}: "
          f"BER {ber:.4e} vs torch {out['torch_ber_same_words']:.4e}; "
          f"word-exact {out['word_exact_agreement']:.3f} ({dt:.1f}s)",
          file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
