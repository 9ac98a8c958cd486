"""802.11n rate-family sum-product waterfall.

The port's counterpart of the JAX package's ``scripts/wifi_waterfall.py``:
all four n = 1944 rates (1/2, 2/3, 3/4, 5/6) decoded by sum-product, on the
torch engine (one straight decode) by default or with ``--engine cuda`` on
the fused kernel (float32 state, staged 12 -> 50).  The reference ships only
the rate-5/6 table and a min-sum CUDA decoder (wifiMatrices.py:6-9,
wifiCUDA.py).

SNR convention: the reference channel's (ldpc.py:51-60), sigma =
sqrt(0.5 / SNR) with SNR in dB, an Es/N0-style axis not normalised by rate.

Writes ``ldpc_tpu_torch/data/wifi_waterfall.{json,md}`` (``--engine cuda``:
``wifi_waterfall_cuda``; or ``--out``), stamped with the port's kernel hash
and the card's name and power limit, and the plot beside them where
matplotlib is installed (else a printed line says it was skipped).

On the card::

    python -m ldpc_tpu_torch.scripts.wifi_waterfall [--words 4096] \\
        [--engine cuda]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.wifi_waterfall \\
        --words 4 --max-iters 5 --out /tmp/wifi_waterfall
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..analysis.plots import _plt, pam2_ber
from ..codes import wifi_code
from ..codes.wifi import wifi_rates
from ..ops.decoder import decoder_for_code
from ..sim.evaluate import StagedDecoder, transmit
from ..sim.stats import wilson_interval
from .studies import artifact_base, stamp, study_device, write_artifact

# lower rates converge at lower SNR on this un-normalised axis (the JAX
# script's grids: each rate's waterfall visible)
SNR_GRIDS = {0.5: [-1.0, -0.5, 0.0, 0.5, 1.0],
             2 / 3: [0.0, 0.5, 1.0, 1.5],
             0.75: [1.0, 1.5, 2.0, 2.5],
             5 / 6: [2.0, 2.5, 3.0, 3.5, 4.0]}
ALL_SNRS = [-1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0]
SEED = 80211
PHASE1_ITERS = 12       # the cuda engine's first stage


def grid(rate: float) -> list[float]:
    return SNR_GRIDS[min(SNR_GRIDS, key=lambda r: abs(r - rate))]


def point_seed(rate: float, snr: float) -> int:
    """The JAX script's fold_in data of a point, under the script's seed."""
    return SEED * 1000000 + int(rate * 100) * 100 + int(snr * 10)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--kind", default="sum-product")
    ap.add_argument("--engine", default="torch", choices=["torch", "cuda"],
                    help="cuda = the fused kernel's sum-product (float32 "
                         "state, staged 12 -> 50)")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: ldpc_tpu_torch/data/"
                         "wifi_waterfall[_cuda] on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    scale = args.kind == "sum-product"
    results: dict = {"words": args.words, "max_iters": args.max_iters,
                     "kind": args.kind, "engine": args.engine, **stamp(dev),
                     "rates": {}}
    curves = {}
    t0 = time.perf_counter()
    for rate in wifi_rates():
        code = wifi_code(rate=rate)
        if args.engine == "cuda":
            dec = StagedDecoder(code, args.max_iters, kind=args.kind,
                                phase1_iters=[p for p in (PHASE1_ITERS,)
                                              if p < args.max_iters],
                                engine="cuda", store_dtype="float32",
                                device=dev)
        else:
            plain = decoder_for_code(code, args.max_iters, kind=args.kind)

            def dec(llr, plain=plain):
                res = plain(llr)
                return (res.hard.sum(-1, dtype=torch.int32), res.iterations,
                        res.success)
        pts = []
        for snr in grid(rate):
            gen = torch.Generator(device=dev).manual_seed(
                point_seed(rate, snr))
            snr_db = torch.full((args.words,), float(snr),
                                dtype=torch.float32, device=dev)
            llr, _, _, unc = transmit(code.n, snr_db, generator=gen,
                                      scale_llr=scale)
            errs, iters, _ = (x.cpu().numpy() for x in dec(llr))
            frames = int((errs > 0).sum())
            _, lo, hi = wilson_interval(frames, args.words)
            pts.append({
                "snr_db": snr,
                "ber": float(errs.sum()) / (args.words * code.n),
                "fer": frames / args.words, "fer_ci95": [lo, hi],
                "uncoded_ber": int(unc.sum()) / (args.words * code.n),
                "avg_iters": float(iters.mean()),
            })
            print(f"[wifi] rate {rate:.3f} snr {snr:.1f}: "
                  f"BER {pts[-1]['ber']:.3e} FER {pts[-1]['fer']:.4f} "
                  f"iters {pts[-1]['avg_iters']:.1f}", file=sys.stderr,
                  flush=True)
        results["rates"][f"{rate:.4f}"] = pts
        curves[rate] = ([p["snr_db"] for p in pts], [p["ber"] for p in pts])
    results["elapsed_s"] = time.perf_counter() - t0

    name = "wifi_waterfall" + ("_cuda" if args.engine == "cuda" else "")
    base = artifact_base(name, args.out, dev)
    md = ["# 802.11n (n=1944, Z=81) sum-product waterfall", "",
          f"{args.kind}, max {args.max_iters} iterations, {args.words} "
          f"words a point, the {args.engine} engine "
          f"(`ldpc_tpu_torch/scripts/wifi_waterfall.py`; {results['device']};"
          f" kernel hash `{results['kernel_hash'][:12]}`; "
          f"{results['elapsed_s']:.1f} s).", "",
          "| rate | " + " | ".join("@%.1f dB" % s for s in ALL_SNRS) + " |",
          "|---|" + "---|" * len(ALL_SNRS)]
    for rate_s, pts in results["rates"].items():
        by_snr = {p["snr_db"]: p["ber"] for p in pts}
        md.append(f"| {float(rate_s):.3g} | " + " | ".join(
            f"{by_snr[s]:.2e}" if s in by_snr else "—" for s in ALL_SNRS)
            + " |")
    print("\n".join(md), flush=True)
    write_artifact(base, results, md)
    if base is not None:
        _plot(curves, args, f"{base}.png")
    return results


def _plot(curves, args, path) -> None:
    """Waterfalls per rate against uncoded PAM-2; skipped with a printed
    line where matplotlib is not installed."""
    try:
        plt = _plt()
    except ImportError as e:
        print(f"[wifi] plot skipped: {e}", file=sys.stderr, flush=True)
        return
    fig, ax = plt.subplots(figsize=(7, 5))
    snrs = np.linspace(-1.0, 4.0, 60)
    ax.semilogy(snrs, np.maximum(pam2_ber(snrs), 1e-12), "k--",
                label="uncoded PAM-2")
    for rate, (xs, ys) in sorted(curves.items()):
        ax.semilogy(xs, np.maximum(ys, 1e-7), marker="o",
                    label=f"rate {rate:.3g}")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    ax.set_title(f"802.11n n=1944 {args.kind}, max {args.max_iters} iters, "
                 f"{args.words} words/point, {args.engine} engine")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    print(f"[wifi] wrote {path}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
