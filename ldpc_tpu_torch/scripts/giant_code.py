"""Giant-code demonstration: the row-sharded decode of synthetic QC codes
whose circulants run to tens of thousands.

The port's counterpart of the JAX package's ``scripts/giant_code.py``.  The
reference's largest code is near-earth (n = 8176), which one device holds
thousands of times over; the row-sharded decoder (``parallel/rowshard.py``,
plain torch, two ``all_reduce``s an iteration) is the path for codes whose
state a word outgrows one device.  This builds ``synthetic_qc_code(z, 8,
24)`` for each ``--z-list`` entry and decodes it over a (data x row) mesh
of ``--ranks`` ranks for each ``--layouts`` entry that uses every rank,
recording each rank's state bytes, decoded bit/s, BER and iterations; first
an exact cross-check: integer LLRs decoded row-sharded over every rank
must equal the unsharded decoder (``ops/decoder.py``) word for word.

The ranks are processes of one gloo group that this script starts (one
per rank, ``python -m ldpc_tpu_torch.scripts.giant_code --rank ...``) and
waits for; rank 0 reports.  On the card every rank decodes on it (gloo
puts several ranks on one card; NCCL refuses that), on the CPU
(``LDPC_TPU_PLATFORM=cpu``) on the host.  The JAX script ran its mesh of 8
virtual CPU devices in one process.

Writes ``ldpc_tpu_torch/data/giant_code.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.giant_code [--ranks 8]

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m ldpc_tpu_torch.scripts.giant_code \\
        --ranks 2 --z-list 64 --layouts 1x2,2x1 --crosscheck-z 32 \\
        --out /tmp/giant_code
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from .studies import artifact_base, stamp, study_device, sync, write_artifact

TIMEOUT_S = 600.0       # the ranks together, the start of each included


def state_bytes_per_device(code, n_row: int, b_local: int,
                           d_cn: int) -> int:
    """float32 live set a rank: its check rows' messages and the three
    [B, n] frames every rank of a row group holds (channel, totals,
    partial)."""
    s_l = (code.block_rows // n_row) * d_cn
    frames = 3 * code.block_cols
    return (s_l + frames) * code.z * b_local * 4


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--z-list", default="2048,8192,16384,32768")
    ap.add_argument("--block-rows", type=int, default=8)
    ap.add_argument("--block-cols", type=int, default=24)
    ap.add_argument("--layouts", default="1x8,2x4",
                    help="comma list of DATAxROW mesh layouts; those that "
                         "do not use every rank are skipped")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--words-per-data", type=int, default=2)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--snr-db", type=float, default=4.0)
    ap.add_argument("--crosscheck-z", type=int, default=512,
                    help="z of the exact cross-check (0: skip)")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/giant_code on the card)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--report", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _crosscheck(args, world: int, dev) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from ..codes import synthetic_qc_code
    from ..ops.decoder import decoder_for_code
    from ..parallel import make_row_sharded_decoder
    code = synthetic_qc_code(args.crosscheck_z, args.block_rows,
                             args.block_cols, seed=3)
    mesh = DeviceMesh(_mesh_type(), torch.arange(world),
                      mesh_dim_names=("row",))
    dec = make_row_sharded_decoder(code, mesh, max_iters=args.iters)
    rng = np.random.default_rng(5)
    llr = rng.integers(-5, 6, size=(4, code.n)).astype(np.float32)
    llr[llr == 0] = -1.0
    llr = torch.as_tensor(llr, device=dev)
    got = dec(llr)
    ref = decoder_for_code(code, args.iters)(llr)
    exact = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
        got, (ref.hard.sum(-1, dtype=torch.int32), ref.iterations,
              ref.success)))
    return {"z": args.crosscheck_z, "n": code.n, "row_ranks": world,
            "words": 4, "exact": bool(exact)}


def _mesh_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _run(args, world: int, dev, z: int, layout: str) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from ..codes import synthetic_qc_code
    from ..parallel import make_row_sharded_decoder
    from ..sim.channel import transmit_zero_codeword
    nd, nr = (int(v) for v in layout.split("x"))
    code = synthetic_qc_code(z, args.block_rows, args.block_cols, seed=1)
    mesh = DeviceMesh(_mesh_type(), torch.arange(world).reshape(nd, nr),
                      mesh_dim_names=("data", "row"))
    b = args.words_per_data * nd
    dec = make_row_sharded_decoder(code, mesh, max_iters=args.iters,
                                   data_axis="data")
    # every rank draws the same global batch
    noisy = transmit_zero_codeword(
        b, code.n, args.snr_db, device=dev,
        generator=torch.Generator(device=dev).manual_seed(z))[0]
    import torch.distributed as dist
    dist.barrier()
    sync(dev)
    t0 = time.perf_counter()
    e, it, ok = (x.cpu().numpy() for x in dec(noisy))
    wall = time.perf_counter() - t0
    mem = state_bytes_per_device(code, nr, args.words_per_data,
                                 max(code.row_degrees()))
    return {"z": z, "n": code.n, "m": code.m, "layout": layout, "words": b,
            "wall_s": wall, "bit_per_s": b * code.n / wall,
            "state_mib_per_device": mem / 2 ** 20,
            "avg_iterations": float(it.mean()),
            "ber": float(e.sum()) / (b * code.n),
            "frames": int((e > 0).sum()),
            "success_rate": float(ok.mean())}


def _rank_main(args) -> None:
    """One rank: join the group, run the cross-check and every run; rank 0
    writes the report."""
    import torch.distributed as dist

    from ..parallel import initialize_distributed
    dev = study_device()
    initialize_distributed(f"localhost:{args.port}", args.ranks, args.rank,
                           device=dev, backend="gloo")
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        report: dict = {"runs": []}
        if args.crosscheck_z:
            report["crosscheck"] = _crosscheck(args, args.ranks, dev)
        for z in (int(v) for v in args.z_list.split(",")):
            for layout in args.layouts.split(","):
                nd, nr = (int(v) for v in layout.split("x"))
                if nd * nr != args.ranks or args.block_rows % nr:
                    continue
                report["runs"].append(_run(args, args.ranks, dev, z,
                                           layout))
        if args.rank == 0:
            pathlib.Path(args.report).write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _args(argv)
    if args.rank is not None:
        _rank_main(args)
        return {}
    dev = study_device()
    t0 = time.perf_counter()
    from ..parallel.mesh import spawn_module_ranks
    report = spawn_module_ranks(        # rank 0 alone writes the report
        "ldpc_tpu_torch.scripts.giant_code",
        lambda r, port, path: [*argv, "--rank", str(r), "--port", str(port),
                               "--report", path],
        args.ranks, TIMEOUT_S, one_thread=True)[0]
    results = {"ranks": args.ranks, "backend": "gloo",
               "block_rows": args.block_rows, "block_cols": args.block_cols,
               "max_iters": args.iters, "snr_db": args.snr_db, **stamp(dev),
               **report, "elapsed_s": time.perf_counter() - t0}
    cross = results.get("crosscheck")
    if cross is not None:
        print(f"[giant] crosscheck z={cross['z']} over {cross['row_ranks']} "
              f"row ranks: {'EXACT' if cross['exact'] else 'MISMATCH'}",
              file=sys.stderr, flush=True)
    rows = ["| z | n | layout | words | MiB/rank | bit/s | BER | iters |",
            "|---|---|---|---|---|---|---|---|"]
    for r in results["runs"]:
        rows.append(f"| {r['z']} | {r['n']:,} | {r['layout']} | "
                    f"{r['words']} | {r['state_mib_per_device']:.1f} | "
                    f"{r['bit_per_s']:,.0f} | {r['ber']:.2e} | "
                    f"{r['avg_iterations']:.1f} |")
    print("\n".join(rows), flush=True)
    md = ["# Giant codes, row-sharded", "",
          f"`synthetic_qc_code(z, {args.block_rows}, {args.block_cols})`, "
          f"{args.ranks} gloo ranks on {results['device']}, min-sum, "
          f"{args.iters} iterations, {args.snr_db} dB; the cross-check "
          f"(integer LLRs, z = {args.crosscheck_z}, every rank a row rank) "
          f"against the unsharded decoder: "
          f"{'exact' if cross and cross['exact'] else cross} "
          f"(`ldpc_tpu_torch/scripts/giant_code.py`; kernel hash "
          f"`{results['kernel_hash'][:12]}`; {results['elapsed_s']:.1f} s, "
          "the ranks' start included).", "", *rows]
    write_artifact(artifact_base("giant_code", args.out, dev), results, md)
    if cross is not None and not cross["exact"]:
        raise SystemExit("row-sharded decode diverged from the unsharded "
                         "decoder")
    return results


if __name__ == "__main__":
    main()
