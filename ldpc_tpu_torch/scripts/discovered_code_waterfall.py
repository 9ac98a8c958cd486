"""BER/FER waterfall of a discovered code against its baseline.

The port's counterpart of the JAX package's
``scripts/discovered_code_waterfall.py``.  A code found by the search is
judged by its fitted-line reward; the domain claim needs a waterfall (the
re-evaluation protocol of the reference's ``postProcessing.py:27-49``).
This measures BER and FER of the code and of its baseline at 16,384 words
a point, 3.0-4.0 dB, 50 iterations (staged 12 -> 50 through the fused
kernel, ``engine="cuda"``, bf16 state), with frame-clustered 95% CIs (BER)
and Wilson intervals (FER), and a verdict per point.

The code is ``--instance`` (a carried name, a JSON code file or a ``.npz``;
default the carried ``s47``, with the provenance its JAX waterfall artifact
recorded), or, with ``--steps-tsv``, the max-reward observation of a search
log.  ``--save-dir`` saves it as a content-addressed instance with the
measured statistics (``save_code_instance``); without it only the
instance's name is recorded.

Writes ``ldpc_tpu_torch/data/discovered_code_waterfall.{json,md}`` (or
``--out``), stamped with the port's kernel hash and the card's name and
power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.discovered_code_waterfall

CPU smoke (a JSON code of the 802.11n shape against 802.11n)::

    LDPC_TPU_PLATFORM=cpu python -m \\
        ldpc_tpu_torch.scripts.discovered_code_waterfall \\
        --instance code.json --baseline wifi --words 16 --iters 8 \\
        --snrs 3.0 4.0 --out /tmp/discovered_code_waterfall
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

from ..codes import code_hex_name, save_code_instance, uncompress
from ..sim.evaluate import evaluate_code
from ..sim.stats import frame_ber_ci, wilson_interval
from .studies import (artifact_base, chain_index, resolve_code, stamp,
                      study_device, sweep_kw, write_artifact)

DEFAULT_INSTANCE = "s47"


def load_best_code(steps_tsv: str, name: str, shape: tuple):
    """The max-reward observation of a search log: (code, train reward)."""
    from ..analysis.postprocess import _read_steps
    df = _read_steps(steps_tsv)
    best = df.loc[df["reward"].idxmax()]
    obs = np.frombuffer(bytes.fromhex(best["observation_hex"]), np.uint8)
    return uncompress(obs, *shape, name=name), float(best["reward"])


def provenance_from(sel_art: dict, path: str) -> dict:
    """The provenance block of a selection artifact: a search's
    ``summary.json`` or a ``floor_topk_select`` artifact."""
    if "selection" in sel_art:        # a search summary.json
        sel = sel_art["selection"]
        cand = (sel.get("candidates") or [{}])[0]
        return {
            "selection_artifact": path,
            "experiment": sel_art.get("exp_name"),
            "selection_method": sel.get("method"),
            "steps_tsv": sel.get("steps_tsv"),
            "train_reward": cand.get("train_reward"),
            "reeval_reward": sel_art.get("best_found"),
            "baseline_reeval": sel_art.get("start_code"),
        }
    cand = (sel_art.get("candidates") or [{}])[0]
    return {
        "selection_artifact": path,
        "selection_method": "topk_reevaluated",
        "train_reward": cand.get("train_reward"),
        "reeval_reward": {"mean": cand.get("reward_mean"),
                          "std": cand.get("reward_std"),
                          "penalized": cand.get("penalized")},
    }


def point_verdicts(base_pts: list, disc_pts: list, base_name: str) -> list:
    """Per point: "discovered" where its BER CI lies wholly below the
    baseline's, the baseline's name where wholly above, else "tie"."""
    wins = []
    for a, b in zip(base_pts, disc_pts):
        better = (b["ber"] + b["ber_ci95_half"]
                  < a["ber"] - a["ber_ci95_half"])
        worse = (b["ber"] - b["ber_ci95_half"]
                 > a["ber"] + a["ber_ci95_half"])
        wins.append({"snr_db": a["snr_db"],
                     "verdict": ("discovered" if better else
                                 base_name if worse else "tie")})
    return wins


def instance_name(code) -> str:
    """The content-addressed name ``save_code_instance`` gives a code."""
    digest = hashlib.sha224(code_hex_name(code).encode()).hexdigest()
    return f"{code.z}_{code.block_rows}_{code.block_cols}_{digest}"


def save_instance(code, save_dir: str | None, stats) -> str:
    """Save the code with its measured statistics under ``save_dir`` (when
    given); returns the instance's content-addressed name either way."""
    if save_dir:
        return save_code_instance(code, save_dir, stats=stats)
    return instance_name(code)


def sweep(code, snrs, words, iters, engine, seed, dev):
    t0 = time.perf_counter()
    stats = evaluate_code(code, snrs, words, iters, seed=seed, verbose=True,
                          **{**sweep_kw(dev, words, iters), "engine": engine})
    points = []
    for snr in snrs:
        sel = stats.column("snr") == snr
        errs = stats.column("errors_decoded")[sel].astype(np.float64)
        fe = int(stats.column("frame_errors")[sel].sum())
        w = int(sel.sum())
        ber, half = frame_ber_ci(errs, code.n)
        fer, flo, fhi = wilson_interval(fe, w)
        points.append({
            "snr_db": snr, "words": w, "ber": ber, "ber_ci95_half": half,
            "fer": fer, "fer_wilson95": [flo, fhi], "frame_errors": fe,
            "avg_iters": float(stats.column("iterations")[sel].mean()),
        })
    return points, time.perf_counter() - t0, stats


def waterfall_md(out: dict, args, base_name: str) -> list[str]:
    prov = out["provenance"]
    if "instance" in prov:
        art = prov.get("selection_artifact") or prov.get("waterfall")
        src = (f"Instance `{prov['instance']}` — "
               f"{prov.get('selection_method', 'unknown')} selection"
               + (f" of experiment `{prov['experiment']}`"
                  if prov.get("experiment") else "")
               + (f" from `{prov['steps_tsv']}`"
                  if prov.get("steps_tsv") else "")
               + (f" (artifact `{art}`)" if art else ""))
    else:
        src = f"Max-reward code of `{prov.get('steps_tsv')}`"
    rows = [f"# {args.name}: BER/FER waterfall vs {base_name}", "",
            f"{src} (differs from {base_name} in blocks "
            f"{out['blocks_changed']}), measured at {args.words} words/point, "
            f"{args.iters} iterations ({args.engine} engine; "
            f"`ldpc_tpu_torch/scripts/discovered_code_waterfall.py`; "
            f"{out['device']}; kernel hash `{out['kernel_hash'][:12]}`).  "
            f"Instance `{out['code_instance']}` (content-addressed, "
            "fileHandler.saveCodeInstance schema).", "",
            f"| Eb/N0 (dB) | {base_name} BER (95% CI) | discovered BER "
            f"(95% CI) | {base_name} FER | discovered FER | verdict |",
            "|---|---|---|---|---|---|"]
    for a, b, v in zip(out["codes"][base_name], out["codes"]["discovered"],
                       out["per_point_verdicts"]):
        rows.append(
            f"| {a['snr_db']} | {a['ber']:.4e} ± {a['ber_ci95_half']:.1e}"
            f" | {b['ber']:.4e} ± {b['ber_ci95_half']:.1e} | "
            f"{a['fer']:.4e} | {b['fer']:.4e} | {v['verdict']} |")
    if "reeval_reward" in out:
        rr = out["reeval_reward"]["best"] or {}
        bb = out["reeval_reward"].get("baseline") or {}
        line = (f"Re-evaluated reward (selection artifact "
                f"`{out['reeval_reward']['source']}`): discovered ")
        if isinstance(rr, dict) and "mean" in rr:
            line += f"{rr['mean']:.5f} ± {rr.get('std', 0):.5f}"
            if rr.get("penalized") is not None:
                line += f" (penalized {rr['penalized']:.5f})"
        elif isinstance(rr, (int, float)):
            line += f"{rr:.5f}"
        if isinstance(bb, dict) and "mean" in bb:
            line += (f" vs start code {bb['mean']:.5f} ± "
                     f"{bb.get('std', 0):.5f}")
            if bb.get("penalized") is not None:
                line += f" (penalized {bb['penalized']:.5f})"
        rows += ["", line + "."]
    return rows


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--snrs", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6, 3.8, 4.0])
    ap.add_argument("--engine", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--seed", type=int, default=424242)
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: ldpc_tpu_torch/data/"
                         "discovered_code_waterfall on the card)")
    ap.add_argument("--steps-tsv", default=None,
                    help="search log to take the max-reward code from "
                         "(instead of --instance)")
    ap.add_argument("--instance", default=None,
                    help="the code to measure: a carried name, a JSON code "
                         f"or a .npz (default {DEFAULT_INSTANCE})")
    ap.add_argument("--provenance-json", default=None,
                    help="selection artifact (a search summary.json or a "
                         "floor_topk_select artifact) to copy the measured "
                         "code's provenance from")
    ap.add_argument("--name", default="rl_discovered_wide_s47")
    ap.add_argument("--baseline", default="near-earth",
                    help="near-earth, wifi or instance:<code> (a carried "
                         "name, a JSON code or a .npz)")
    ap.add_argument("--save-dir", default=None,
                    help="where to save the stats-stamped instance "
                         "(default: not saved)")
    args = ap.parse_args(argv)

    dev = study_device()
    if args.baseline.startswith("instance:"):
        base_name = "baseline_instance"
        base = resolve_code(args.baseline[len("instance:"):])[0]
    else:
        base = resolve_code(args.baseline)[0]
        base_name = args.baseline.replace("-", "_")
    provenance: dict = {}
    if args.provenance_json:
        with open(args.provenance_json) as f:
            provenance = provenance_from(json.load(f), args.provenance_json)
    if args.steps_tsv:
        best_code, train_reward = load_best_code(
            args.steps_tsv, args.name, (base.block_rows, base.block_cols,
                                        base.z))
        provenance.setdefault("steps_tsv", args.steps_tsv)
        provenance.setdefault("selection_method", "argmax_train_reward")
        provenance["train_reward"] = train_reward
    else:
        spec = args.instance or DEFAULT_INSTANCE
        best_code, source = resolve_code(spec)
        carried = chain_index()["codes"].get(spec, {}).get("waterfall")
        if carried and not args.provenance_json:
            provenance = {**carried["provenance"],
                          "waterfall": carried["artifact"]}
            if carried.get("reeval_reward"):
                provenance["reeval_reward"] = carried["reeval_reward"]
        provenance["instance"] = source
        train_reward = float(provenance.get("train_reward") or float("nan"))
        if not provenance.get("selection_method"):
            print("WARNING: a code without provenance: the artifact cannot "
                  "trace it to its selection step", file=sys.stderr)
    diff = [[mb, nb] for mb in range(base.block_rows)
            for nb in range(base.block_cols)
            if best_code.shifts[mb][nb] != base.shifts[mb][nb]]
    print(f"discovered code: train reward {train_reward:.4f}, differs "
          f"from {base_name} in blocks {diff}", flush=True)

    out = {"train_reward": train_reward, "provenance": provenance,
           "baseline": args.baseline, "blocks_changed": diff,
           "max_iters": args.iters, "words_per_point": args.words,
           "engine": args.engine, **stamp(dev), "codes": {}}
    rr = provenance.get("reeval_reward")
    if rr:
        out["reeval_reward"] = (
            rr if isinstance(rr, dict) and "best" in rr else
            {"best": rr, "baseline": provenance.get("baseline_reeval"),
             "source": provenance.get("selection_artifact")})
    stats_best = None
    for name, code in [(base_name, base), ("discovered", best_code)]:
        pts, dt, stats = sweep(code, args.snrs, args.words, args.iters,
                               args.engine, args.seed, dev)
        out["codes"][name] = pts
        out[f"{name}_seconds"] = dt
        if name == "discovered":
            stats_best = stats
        for p in pts:
            print(f"[{name}] @{p['snr_db']}: BER {p['ber']:.4e} ± "
                  f"{p['ber_ci95_half']:.1e}  FER {p['fer']:.4e} "
                  f"[{p['fer_wilson95'][0]:.1e}, "
                  f"{p['fer_wilson95'][1]:.1e}]  iters "
                  f"{p['avg_iters']:.1f}", flush=True)
        print(f"[{name}] swept in {dt:.1f} s", flush=True)
    out["per_point_verdicts"] = point_verdicts(
        out["codes"][base_name], out["codes"]["discovered"], base_name)
    print("verdicts:", json.dumps(out["per_point_verdicts"]), flush=True)
    out["code_instance"] = save_instance(best_code, args.save_dir,
                                         stats_best)
    write_artifact(artifact_base("discovered_code_waterfall", args.out, dev),
                   out, waterfall_md(out, args, base_name))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
