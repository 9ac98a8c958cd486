"""One-process A/B of the fused decoder and the phase-split decoder.

The counterpart of the JAX package's ``scripts/split_ab.py``, with the same
arguments less ``--interpret``: the mono decoder is the cuda engine's fused
kernel (``ops/cuda_static.py``, min-sum flooding), the split one the kernel
pair of ``ops/cuda_split.py``.  One process, word-exactness asserted on a
shared input before any timing (a mismatch exits non-zero), then the two
timed on distinct inputs, interleaved across trials so that drift cancels.
It prints one JSON summary line (best and median wall ms of each, ending in
a synchronise, stamped with ``kernel_hash`` and ``split_kernel_hash``, the
hashes of the decode path's sources and of the split pair's,
``csrc/split.cu`` and ``ops/cuda_split.py``) and writes it to ``--out``
only when given one.

On the card::

    python -m ldpc_tpu_torch.scripts.split_ab [--batch 16384] [--mi 10] \\
        [--snr 3.4] [--trials 4] [--store bfloat16] [--code near-earth|wifi]

``LDPC_TPU_PLATFORM=cpu`` runs it on the CPU with the plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli import _device
from ..codes import near_earth_code, wifi_code
from ..ops.cuda_split import make_split_sweep_decoder
from ..ops.cuda_static import make_static_sweep_decoder
from ..sim.evaluate import transmit
from ..utils.device import resolve_device
from ..utils.provenance import SPLIT_SOURCES, kernel_source_hash


def _llr(code, batch: int, snr: float, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    snr_db = torch.full((batch,), snr, dtype=torch.float32, device=dev)
    return transmit(code.n, snr_db, generator=gen)[0]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--mi", type=int, default=10)
    ap.add_argument("--snr", type=float, default=3.4)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--store", default="bfloat16")
    ap.add_argument("--code", default="near-earth",
                    choices=("near-earth", "wifi"))
    ap.add_argument("--out", default=None,
                    help="also write the summary to this JSON file")
    args = ap.parse_args(argv)

    dev = resolve_device(_device())
    code = wifi_code() if args.code == "wifi" else near_earth_code()
    decs = {}
    for name, make in (("mono", make_static_sweep_decoder),
                       ("split", make_split_sweep_decoder)):
        t0 = time.perf_counter()
        dec = make(code, args.mi, store_dtype=args.store, device=dev)
        out = dec(_llr(code, args.batch, args.snr, 1000 + len(decs), dev))
        _sync(dev)
        print(f"{name}: built+warm in {time.perf_counter() - t0:.1f} s, "
              f"nfail={int((~out[2]).sum())}", flush=True)
        decs[name] = dec

    shared = _llr(code, args.batch, args.snr, 5, dev)
    ref = decs["mono"](shared)
    got = decs["split"](shared)
    exact = all(torch.equal(a, b) for a, b in zip(ref, got))
    print(f"shared-input exactness: {'WORD-EXACT' if exact else 'MISMATCH'}",
          flush=True)
    if not exact:
        print("ABORTING: timing is only meaningful for a word-exact "
              "variant; fix the split kernels first", flush=True)
        raise SystemExit(1)

    times: dict[str, list[float]] = {n: [] for n in decs}
    for t in range(args.trials):
        for name, dec in decs.items():
            llr = _llr(code, args.batch, args.snr,
                       7919 * t + (1 if name == "split" else 0), dev)
            _sync(dev)
            t0 = time.perf_counter()
            dec(llr)
            _sync(dev)
            dt = time.perf_counter() - t0
            times[name].append(dt)
            print(f"trial {t} {name:5s}: {dt * 1e3:8.1f} ms", flush=True)

    summary = {
        "context": {"batch": args.batch, "mi": args.mi, "snr": args.snr,
                    "code": args.code, "store": args.store,
                    "trials": args.trials},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "kernel_hash": kernel_source_hash(),
        "split_kernel_hash": kernel_source_hash(sources=SPLIT_SOURCES),
        "word_exact": exact,
        "best_ms": {n: min(v) * 1e3 for n, v in times.items()},
        "median_ms": {n: float(np.median(v)) * 1e3
                      for n, v in times.items()},
        "speedup_split_vs_mono": min(times["mono"]) / min(times["split"]),
        "split_host_reads": decs["split"].host_reads,
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
