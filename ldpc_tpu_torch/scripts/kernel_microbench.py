"""Speed-of-light probes of the card's primitives and the fused decoder's
cost per iteration.

The counterpart of the JAX package's ``scripts/kernel_microbench.py``, with
its arguments (``--quick``, ``--skip-decoder``, ``--skip-primitives``) plus
``--out``: each probe (``ops/microbench.py``, kernel ``csrc/microbench.cu``)
runs a body K times on a tile in shared memory, and its cost is the slope
between two K values (K 2,000 and 42,000; ``--quick`` 1,000 and 11,000):
the launch overhead subtracts out.  Each K is timed with CUDA events, the
best of 5 trials on distinct inputs (the trial index added to the tile).
The probes run at G = 1 tile (the JAX function: 8 blocks, latency) and at
the card-filling G (``fill``: one full wave of blocks on every SM), and
each slope is also given per element, beside the least time shared memory
needs for the bytes the body moves an element (``smem_ceiling_ps``).

The decoder's slope is ``(t(40) - t(10)) / 30`` of the cuda engine's fused
kernel (``ops/cuda_static.make_static_sweep_decoder``, min-sum) on 0 dB
words from ``sim.evaluate.transmit``, where nothing converges, best of 4
trials, at 128 words (one block on each of 128 SMs: the JAX key, latency)
and at the main path's 32,768 words (throughput): flooding in bf16 and
f32, microseconds an iteration, and layered in bf16, microseconds a
sweep.  With the flooding slopes measured it prints an op-count model of
one near-earth iteration: per word, 32,704 phase-A edge gathers and folds
and as many phase-B gathers and rebuilds, each costed with the probes at
the card-filling G.

On the card::

    python -m ldpc_tpu_torch.scripts.kernel_microbench [--quick] \\
        [--skip-decoder] [--skip-primitives] [--out FILE]

It prints one JSON line, with the card's name and power limit, and writes
it to ``--out`` only when given one.  ``LDPC_TPU_PLATFORM=cpu`` runs it on
the CPU with the plain versions (host clock; no device number).  The K
pairs (``K_FULL``, ``K_QUICK``), the tile counts (``TILES``) and the
decoder's word counts (``DECODER_WORDS``) are module constants.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..cli import _device
from ..codes import near_earth_code
from ..ops.cuda_static import make_static_sweep_decoder
from ..ops.microbench import (LANES, NAMES, PROBES, SMEM_BYTES_PER_ELEMENT,
                              fill_tiles, input_tile, probe)
from ..sim.evaluate import transmit
from ..utils.device import resolve_device
from ..utils.profiling import smem_bytes_per_s, smi_query, timed_once

TRIALS = 5
K_FULL = (2000, 42000)   # the two K values of a slope
K_QUICK = (1000, 11000)  # with --quick
TILES = (1, "fill")      # tile counts G; "fill": the card-filling G
DECODER_TRIALS = 4
DECODER_ITERS = (10, 40)
DECODER_STORES = ("bfloat16", "float32")
LAYERED_STORES = ("bfloat16",)   # the layered slopes' stores
MAIN_WORDS = 32768
DECODER_WORDS = (128, MAIN_WORDS)
# the op-count model's primitives: the rotation's gather (mod-511 less the
# baseline), the phase-A fold and the phase-B rebuild
GATHER, BASE = "baseline+mod511_rot", "abs_add_baseline"
FOLD, REBUILD = "twomin_edge_no_rot", "recon_no_rot"


def _best(make_input, run, dev, trials: int) -> float:
    """Best seconds over trials with distinct inputs, a warm call first in
    each (as the JAX script's ``_time``)."""
    best = float("inf")
    for t in range(trials):
        x = make_input(t)
        run(x)
        best = min(best, timed_once(lambda: run(x), dev)[1] / 1e3)
    return best


def slope_ns(name: str, k1: int, k2: int, tiles: int, dev,
             trials: int = TRIALS) -> float:
    """Nanoseconds per run of probe ``name``'s body on ``tiles`` tiles."""
    _, n_bufs, rows, dtype = PROBES[name]

    def make(t):
        return input_tile(n_bufs, rows, dtype, t, tiles, dev)

    t1 = _best(make, lambda x: probe(name, x, k1), dev, trials)
    t2 = _best(make, lambda x: probe(name, x, k2), dev, trials)
    return (t2 - t1) / (k2 - k1) * 1e9


def decoder_input(words: int, max_iters: int, t: int, dev) -> torch.Tensor:
    """The LLRs of trial ``t`` of the ``max_iters`` decode: ``words``
    near-earth words at 0 dB."""
    gen = torch.Generator(device=dev).manual_seed(100 * max_iters + t)
    snr = torch.zeros(words, dtype=torch.float32, device=dev)
    return transmit(near_earth_code().n, snr, generator=gen)[0]


def decoder_slope_us(store: str, words: int, dev, iters=DECODER_ITERS,
                     trials: int = DECODER_TRIALS,
                     schedule: str = "flooding") -> float:
    """Microseconds per iteration (flooding) or sweep (layered) of the
    fused kernel on ``words`` near-earth words at 0 dB (nothing
    converges)."""
    code = near_earth_code()
    times = {}
    for mi in iters:
        dec = make_static_sweep_decoder(code, mi, store_dtype=store,
                                        schedule=schedule, device=dev)
        times[mi] = _best(lambda t, mi=mi: decoder_input(words, mi, t, dev),
                          dec, dev, trials)
    lo, hi = iters
    return (times[hi] - times[lo]) / (hi - lo) * 1e6


def decoder_key(store: str, words: int, schedule: str = "flooding") -> str:
    """The result's key of a decoder slope: the JAX key at 128 words
    (flooding); layered slopes are microseconds a sweep."""
    key = (f"decoder_us_per_iter_{store}" if schedule == "flooding"
           else f"decoder_us_per_sweep_{schedule}_{store}")
    return key if words == 128 else f"{key}_{words}"


def _card(dev) -> dict:
    if dev.type != "cuda":
        return {"device": "cpu"}
    name, limit, clock = smi_query("name", "power.limit", "clocks.max.sm")
    mhz = float(clock.split()[0])
    return {"device": torch.cuda.get_device_name(dev),
            "smi": f"{name}, {limit}", "power_limit": limit,
            "sm_clock_max_mhz": mhz,
            "smem_bytes_per_s": smem_bytes_per_s(mhz * 1e6)}


def model(results: dict, words: int = MAIN_WORDS) -> dict:
    """The op-count model of one near-earth flooding iteration of ``words``
    words from the card-filling probes, against the measured slopes."""
    fill = results["fill"]
    ps = {n: fill[n]["ps_per_element"] for n in (GATHER, BASE, FOLD,
                                                 REBUILD)}
    gather = ps[GATHER] - ps[BASE]
    edges = near_earth_code().num_edges
    phase_a = edges * (gather + ps[FOLD])
    phase_b = edges * (gather + ps[REBUILD])
    us = words * (phase_a + phase_b) / 1e6
    out = {"words": words, "edges_per_word": edges,
           "ps_per_edge": {"gather": gather, "fold": ps[FOLD],
                           "rebuild": ps[REBUILD]},
           "us_per_iter": us}
    for store in DECODER_STORES:
        got = results.get(decoder_key(store, words))
        if got is not None:
            out[f"measured_over_model_{store}"] = got / us
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-decoder", action="store_true")
    ap.add_argument("--skip-primitives", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write the result to this JSON file")
    args = ap.parse_args(argv)

    dev = resolve_device(_device())
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    k1, k2 = K_QUICK if args.quick else K_FULL
    results: dict = {**_card(dev), "tile": [PROBES[BASE][2], LANES],
                     "k": [k1, k2], "trials": TRIALS}

    if not args.skip_primitives:
        results["fill"] = {}
        for name in NAMES:
            rows = PROBES[name][2]
            for spec in TILES:
                tiles = fill_tiles(name, dev) if spec == "fill" else spec
                ns = slope_ns(name, k1, k2, tiles, dev)
                per = ns * 1e3 / (tiles * rows * LANES)
                row = {"tiles": tiles, "ns": ns, "ps_per_element": per}
                if "smem_bytes_per_s" in results:   # the card's ceiling
                    row["smem_ceiling_ps"] = (SMEM_BYTES_PER_ELEMENT[name] /
                                              results["smem_bytes_per_s"] *
                                              1e12)
                if tiles == 1:
                    results[name] = ns        # the JAX key: one tile
                else:                         # the card-filling G
                    results["fill"][name] = row
                print(f"{name:28s} G={tiles:5d} {ns:12.1f} ns/run "
                      f"{per:9.3f} ps/element", file=sys.stderr, flush=True)

    if not args.skip_decoder:
        runs = ([(s, "flooding") for s in DECODER_STORES] +
                [(s, "layered") for s in LAYERED_STORES])
        for store, schedule in runs:
            for words in DECODER_WORDS:
                us = decoder_slope_us(store, words, dev, schedule=schedule)
                results[decoder_key(store, words, schedule)] = us
                unit = "iter" if schedule == "flooding" else "sweep"
                print(f"decoder {store} {schedule}, {words} words: {us:.3f} "
                      f"us/{unit} ({us * 1e3 / words:.3f} ns/word-{unit})",
                      file=sys.stderr, flush=True)

    if results.get("fill") and all(n in results["fill"] for n in
                                   (GATHER, BASE, FOLD, REBUILD)):
        results["model"] = model(results, DECODER_WORDS[-1])
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
