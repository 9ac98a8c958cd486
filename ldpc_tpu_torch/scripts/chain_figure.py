"""The discovery chain's waterfalls, from measured waterfall artifacts.

The port's counterpart of the JAX package's ``scripts/chain_figure.py``.
Reads the BER/FER points of waterfall artifacts (each with a ``codes``
mapping of name -> measured points and their CI bands, as
``discovered_code_waterfall`` writes) and computes the overlay's series:
per code its SNR points, BER with its 95% band and FER with its Wilson
band (each clipped at 1e-9 for the log axis).  The figure (BER and FER
panels, the style of the reference's ``plotSNRvsBER``,
``common.py:103-139``) is drawn only where matplotlib is installed.  No
decode.

A series is ``PATH[:KEY[:LABEL]]``: the code ``KEY`` of a waterfall
artifact (where the artifact has no such key, its one code besides
``near_earth``), or every code of it.  Default: every code of the port's
``ldpc_tpu_torch/data/discovered_code_waterfall.json``.  Writes
``ldpc_tpu_torch/data/chain_figure.{json,md}`` (and ``.png`` with
matplotlib; or ``--out``), stamped with the port's kernel hash and the
device.

On the card::

    python -m ldpc_tpu_torch.scripts.chain_figure

On the CPU::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.chain_figure \\
        --series waterfall.json --out /tmp/chain_figure
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .studies import (DATA, artifact_base, can_draw, stamp, study_device,
                      write_artifact)

FLOOR = 1e-9               # the log axis' lowest value


def series_of(spec: str) -> list[dict]:
    """The series of one ``PATH[:KEY[:LABEL]]`` spec."""
    path, _, rest = spec.partition(":")
    key, _, label = rest.partition(":")
    with open(path) as f:
        codes = json.load(f)["codes"]
    if key and key not in codes:
        # older artifacts name the discovered code by its instance hash
        key = next(k for k in codes if k != "near_earth")
    stem = os.path.basename(path).removesuffix(".json")
    out = []
    for k in ([key] if key else list(codes)):
        pts = codes[k]
        out.append({
            "source": path, "key": k, "label": label or f"{stem}: {k}",
            "snr_db": [p["snr_db"] for p in pts],
            "ber": [max(p["ber"], FLOOR) for p in pts],
            "ber_band": [[max(p["ber"] - p.get("ber_ci95_half", 0.0), FLOOR),
                          p["ber"] + p.get("ber_ci95_half", 0.0)]
                         for p in pts],
            "fer": [max(p["fer"], FLOOR) for p in pts],
            "fer_band": [[max(p["fer_wilson95"][0], FLOOR),
                          max(p["fer_wilson95"][1], FLOOR)] for p in pts]})
    return out


def draw(series: list, path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.4), sharex=True)
    for s in series:
        for ax, field in zip(axes, ("ber", "fer")):
            line, = ax.semilogy(s["snr_db"], s[field], "o-", label=s["label"],
                                ms=4)
            band = s[f"{field}_band"]
            ax.fill_between(s["snr_db"], [b[0] for b in band],
                            [b[1] for b in band], color=line.get_color(),
                            alpha=0.18, lw=0)
    for ax, title in zip(axes, ("BER", "FER")):
        ax.set_xlabel("Eb/N0 [dB]")
        ax.set_ylabel(title)
        ax.grid(True, which="both", alpha=0.3)
    axes[0].legend(fontsize=8, loc="lower left")
    fig.suptitle("Discovery chain — measured waterfalls "
                 "(min-sum, 50 iters, CI bands)")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--series", nargs="+",
                    default=[str(DATA / "discovered_code_waterfall.json")],
                    help="PATH[:KEY[:LABEL]] of waterfall artifacts")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/chain_figure on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    series = []
    for spec in args.series:
        if not os.path.exists(spec.partition(":")[0]):
            print(f"[chain_figure] skip {spec}: not found", flush=True)
            continue
        series += series_of(spec)
    base = artifact_base("chain_figure", args.out, dev)
    figure = None
    if base is not None and can_draw() and series:
        figure = f"{base}.png"
        base.parent.mkdir(parents=True, exist_ok=True)
        draw(series, figure)
    out = {**stamp(dev), "series": series, "figure": figure}
    md = ["# Discovery chain waterfalls", "",
          f"{len(series)} series (`ldpc_tpu_torch/scripts/chain_figure.py`; "
          f"{out['device']}); "
          + (f"figure `{figure}`." if figure else "no figure."), "",
          "| series | Eb/N0 (dB) | BER | FER |", "|---|---|---|---|"]
    md += [f"| {s['label']} | {snr} | {b:.3e} | {f:.3e} |" for s in series
           for snr, b, f in zip(s["snr_db"], s["ber"], s["fer"])]
    write_artifact(base, out, md)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
