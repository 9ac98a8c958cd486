"""Command-line entry points of the port: ``python -m ldpc_tpu_torch.cli``.

The counterpart of ``python -m ldpc_tpu.cli``, with the same commands,
arguments and defaults:

  evaluate     BER/FER sweep of a code on the card (``--sharded``: over
               the ranks of a ``torch.distributed`` group, ``parallel/``)
  bench        the reference's benchmark presets (near-earth, wifi)
  probe        deterministic epsilon/bit-flip probe (ldpcCUDA.py:677)
  random-agent random code-search baseline (each candidate decoded by the
               fused kernel)
  perturb      write the zeroed-circulant robustness suite
  train        PPO code search (``rl/train.py``; its arguments follow the
               command, after an optional ``--``)
  getting-started  environment check: torch and the card, a 1-flip
               802.11n probe, the native engine
  post-mortem  re-evaluate an experiment's best codes, action heat maps
  reward-surface  the reward landscape over (slope, bias)

Engines: ``--engine torch`` is the counterpart of ``xla`` (plain torch
ops), ``--engine cuda`` of ``pallas`` (the CUDA kernel: flooding or
layered schedule, bfloat16, float32 or int8 state).
Everything runs on the card; ``LDPC_TPU_PLATFORM=cpu`` runs it on the CPU
instead (the kernel's plain PyTorch version stands in for it there), as it
forces the CPU in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _device():
    """``"cpu"`` when ``LDPC_TPU_PLATFORM=cpu``, else None: the card."""
    name = os.environ.get("LDPC_TPU_PLATFORM")
    if name and name != "cpu":
        raise SystemExit(f"LDPC_TPU_PLATFORM={name!r}: the port takes "
                         "'cpu' or nothing (the card)")
    return name or None


def _get_code(name: str):
    from .codes import load_code_json, near_earth_code, wifi_code
    if name in ("near-earth", "nearearth", "ccsds"):
        return near_earth_code()
    if name in ("wifi", "802.11n"):
        return wifi_code()
    return load_code_json(name)


def cmd_evaluate(args):
    """The sweep; prints the summary line and returns the statistics."""
    from .sim import evaluate_code
    if args.tile_b is not None and args.engine != "cuda":
        raise SystemExit("--tile-b is a kernel scheduling lever; combine it "
                         "with --engine cuda")
    code = _get_code(args.code)
    # a phase budget must sit below the full iteration budget; drop the
    # ones that don't (the default "12" with e.g. --iterations 8 simply
    # means an unstaged decode)
    phases = [int(p) for p in str(args.phase_iters).split(",")
              if int(p) < args.iterations]
    staged = not args.no_staged and bool(phases)
    if args.codewords == "random":
        if args.sharded:
            raise SystemExit("--codewords random is the one-process "
                             "validation path (torch engine, unstaged)")
        if (args.engine != "torch" or args.schedule != "flooding"
                or args.store_dtype or args.tile_b is not None):
            raise SystemExit(
                "--codewords random runs the torch engine unstaged "
                "(flooding, f32): drop --engine/--schedule/--store-dtype/"
                "--tile-b rather than having them silently ignored")
        staged = False
    common = dict(
        seed=args.seed, batch_size=args.batch_size, kind=args.kind,
        scale_llr=(args.kind == "sum-product"), engine=args.engine,
        staged=staged, phase1_iters=phases,
        store_dtype=args.store_dtype, schedule=args.schedule,
        sort_words=args.sort_words, checkpoint_path=args.checkpoint,
        early_abort_ber=args.early_abort_ber, verbose=True,
        device=_device())
    if args.sharded:
        # the reference wrapper's numberOfCudaDevices path
        # (ldpcCUDA.py:891-932): the batch split over the ranks of the
        # group (one rank without one; LDPC_TPU_DISTRIBUTED=1 joins the
        # group a launcher describes), the counters summed
        from .parallel import evaluate_code_sharded, initialize_distributed
        initialize_distributed(device=_device())
        stats = evaluate_code_sharded(
            code, args.snr, args.transmissions, args.iterations,
            pallas_tile_b=args.tile_b, **common)
    else:
        stats = evaluate_code(
            code, args.snr, args.transmissions, args.iterations,
            tile_b=args.tile_b, codewords=args.codewords, **common)
    print(json.dumps(stats.summary()))
    if args.plot:
        from .analysis import plot_snr_vs_ber
        (_, _, _, axis, _, ber, _) = stats.get_stats_v2()
        plot_snr_vs_ber(axis, ber, file_name=args.plot)
        print(f"wrote {args.plot}", file=sys.stderr)
    return stats


def cmd_bench(args):
    """Benchmark presets mirroring the reference's in-module self-tests.

    ``near-earth`` reproduces ``ldpc.testNearEarth`` (ldpc.py:480-498): roi
    [3.0, 3.2, 3.4, 3.6] dB, min-sum, 50 iterations, decoded bit/s and
    per-point BER.  ``wifi`` reproduces ``wifiCUDA.testWifi`` (seed 460101,
    same roi, 50 iterations, status 'OK' iff the BER at the two highest SNR
    points is zero — wifiCUDA.py:660-682).  Prints one JSON line and
    returns it as a dict.
    """
    from .sim import evaluate_code
    preset = args.preset
    code = _get_code(preset)
    seed = 460101 if preset == "wifi" else args.seed
    t0 = time.time()
    stats = evaluate_code(
        code, args.snr, args.transmissions, args.iterations, seed=seed,
        batch_size=args.batch_size, staged=True, engine=args.engine,
        verbose=True, device=_device())
    dt = time.time() - t0
    (_, _, _, axis, _, ber, _) = stats.get_stats_v2()
    status = "OK" if len(ber) >= 2 and ber[-1] == 0 and ber[-2] == 0 \
        else f"{preset} problem"
    out = {
        "preset": preset,
        "throughput_bit_per_s": code.n * len(args.snr)
        * args.transmissions / dt,
        "seconds": dt,
        "ber": {float(s): float(b) for s, b in zip(axis, ber)},
        "status": status,
    }
    print(json.dumps(out))
    return out


def cmd_probe(args):
    """The probe on the torch engine; prints and returns its dict."""
    from .sim import evaluate_epsilon_probe
    code = _get_code(args.code)
    unc, dec, iters, ok = evaluate_epsilon_probe(
        code, epsilon=args.epsilon, flips=tuple(args.flips),
        max_iters=args.iterations, device=_device())
    out = {"errors_uncoded": unc, "errors_decoded": dec,
           "iterations": iters, "success": ok}
    print(json.dumps(out))
    return out


def cmd_random_agent(args):
    """The random-search baseline; prints and returns its rewards."""
    from .envs import LdpcCodeSearchEnv
    from .rl import run_random_agent
    env = LdpcCodeSearchEnv(code=_get_code(args.code),
                            num_transmissions=args.transmissions,
                            seed=args.seed, device=_device())
    rewards, env = run_random_agent(env, num_steps=args.steps,
                                    seed=args.seed)
    print(json.dumps({"rewards": rewards}))
    return rewards


def cmd_perturb(args):
    """Writes the zeroed-circulant suite; prints and returns its summary."""
    from .codes import write_suite
    code = _get_code(args.code)
    names = write_suite(code, args.out)
    out = {"written": len(names), "dir": args.out}
    print(json.dumps(out))
    return out


def cmd_train(args):
    """The PPO trainer; returns (actor, critic, logger)."""
    from .rl.train import main as train_main
    return train_main(args.rest, device=_device())


def cmd_post_mortem(args):
    """Re-evaluates the best codes of an experiment's steps.tsv and/or
    draws its action heat maps (postProcessing.py:27-160 equivalents);
    prints and returns what it found."""
    from .analysis import action_heatmaps, post_mortem_best_codes
    out = {}
    if args.heatmaps:
        grids = action_heatmaps(args.tsv, save_figures=True)
        out["heatmaps"] = {k: list(v.shape) for k, v in grids.items()}
        print(json.dumps(out["heatmaps"]))
    if args.best:
        results = post_mortem_best_codes(
            args.tsv, num_transmissions=args.transmissions,
            device=_device())
        out["best"] = [stats.summary() for _, stats in results]
        for summary in out["best"]:
            print(json.dumps(summary))
    return out


def cmd_reward_surface(args):
    """Writes the reward-surface plot; returns (slope, bias, reward)."""
    from .analysis import reward_surface
    out = reward_surface(start_point=args.start, end_point=args.end,
                         save_path=args.out)
    print(f"wrote {args.out}", file=sys.stderr)
    return out


def cmd_getting_started(args):
    """Environment check (gettingStarted.py equivalent); returns the
    probe's outcome and whether the native engine is available."""
    import torch
    dev = _device()
    if dev is None and torch.cuda.is_available():
        cuda = (f"cuda {torch.version.cuda}; devices: "
                f"{torch.cuda.device_count()} x "
                f"{torch.cuda.get_device_name(0)}")
    else:
        cuda = "devices: cpu" + ("" if torch.cuda.is_available()
                                 else " (no CUDA device)")
    print(f"torch {torch.__version__}; {cuda}")
    from .codes import near_earth_code, wifi_code
    ne = near_earth_code()
    print(f"near-earth: ({ne.n}, {ne.k}), {ne.block_rows}x"
          f"{ne.block_cols} blocks of Z={ne.z}")
    from .sim import evaluate_epsilon_probe
    unc, dec, iters, ok = evaluate_epsilon_probe(
        wifi_code(), flips=(0,), max_iters=10, device=dev)
    status = "OK" if (ok and dec == 0) else "FAILED"
    print(f"decoder smoke test (1 flip on 802.11n): {status} "
          f"({iters} iterations)")
    from . import native
    have_native = native.available()
    print(f"native C++ engine: "
          f"{'available' if have_native else 'unavailable'}")
    print("ready — see README.md for the API tour")
    return {"probe": status, "iterations": iters, "native": have_native}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ldpc_tpu_torch", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("evaluate", help="BER/FER sweep")
    e.add_argument("--code", default="near-earth")
    e.add_argument("--snr", type=float, nargs="+",
                   default=[3.0, 3.2, 3.4, 3.6])
    e.add_argument("--transmissions", type=int, default=50)
    e.add_argument("--iterations", type=int, default=50)
    e.add_argument("--seed", type=int, default=7134066)
    e.add_argument("--batch-size", type=int, default=1024)
    e.add_argument("--kind", default="min-sum")
    e.add_argument("--no-staged", action="store_true")
    e.add_argument("--engine", default="torch", choices=["torch", "cuda"])
    e.add_argument("--schedule", default="flooding",
                   choices=["flooding", "layered"],
                   help="cuda-engine message schedule: flooding "
                        "(reference semantics) or layered (serial-C "
                        "schedule, ~2x fewer sweeps; requires "
                        "--engine cuda)")
    e.add_argument("--tile-b", type=int, default=None,
                   help="the JAX kernel's codeword tile; refused (the CUDA "
                        "kernel runs one word per block)")
    e.add_argument("--store-dtype", default=None,
                   choices=["bfloat16", "float32", "int8"],
                   help="cuda engine state dtype (int8 = Q4.3 "
                        "fixed-point message memory)")
    e.add_argument("--sharded", action="store_true",
                   help="evaluate over the ranks of a torch.distributed "
                        "group (one rank without one; the counters summed "
                        "with all_reduce: evaluateCodeCudaWrapper's "
                        "numberOfCudaDevices equivalent)")
    e.add_argument("--phase-iters", default="12",
                   help="staged-decode cascade budgets, e.g. '6,16' for "
                        "6 -> 16 -> full-iteration stages (exactly "
                        "equivalent results, less straggler waste)")
    e.add_argument("--checkpoint", default=None,
                   help="save statistics after every SNR point and resume "
                        "past completed points on restart")
    e.add_argument("--sort-words", action="store_true",
                   help="difficulty-sort the batch before decoding "
                        "(bit-identical outputs; an order of work only)")
    e.add_argument("--codewords", default="zero",
                   choices=["zero", "random"],
                   help="'random' transmits encoded random messages and "
                        "counts errors vs the transmitted word (validates "
                        "the all-zero protocol; ldpc.py:409-416 done "
                        "right; torch engine, unstaged)")
    e.add_argument("--early-abort-ber", type=float, default=None,
                   help="stop the sweep once a point's BER exceeds this "
                        "reference value (ldpc.py:473-475)")
    e.add_argument("--plot", default=None)
    e.set_defaults(fn=cmd_evaluate)

    be = sub.add_parser("bench", help="reference benchmark presets")
    be.add_argument("preset", choices=["near-earth", "wifi"])
    be.add_argument("--snr", type=float, nargs="+",
                    default=[3.0, 3.2, 3.4, 3.6])
    be.add_argument("--transmissions", type=int, default=50)
    be.add_argument("--iterations", type=int, default=50)
    be.add_argument("--seed", type=int, default=7134066)
    be.add_argument("--batch-size", type=int, default=1024)
    be.add_argument("--engine", default="cuda", choices=["torch", "cuda"])
    be.set_defaults(fn=cmd_bench)

    pr = sub.add_parser("probe", help="deterministic epsilon probe")
    pr.add_argument("--code", default="near-earth")
    pr.add_argument("--epsilon", type=float, default=1e-2)
    pr.add_argument("--flips", type=int, nargs="*", default=[0])
    pr.add_argument("--iterations", type=int, default=50)
    pr.set_defaults(fn=cmd_probe)

    ra = sub.add_parser("random-agent", help="random-search baseline")
    ra.add_argument("--code", default="near-earth")
    ra.add_argument("--steps", type=int, default=10)
    ra.add_argument("--transmissions", type=int, default=10)
    ra.add_argument("--seed", type=int, default=42)
    ra.set_defaults(fn=cmd_random_agent)

    pe = sub.add_parser("perturb", help="zeroed-circulant suite")
    pe.add_argument("--code", default="near-earth")
    pe.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "ldpc_tpu_test_matrices"))
    pe.set_defaults(fn=cmd_perturb)

    # every argument after "train" is rl.train's (its own --help too): a
    # prefix no argument uses keeps this parser from taking any of them
    tr = sub.add_parser("train", help="PPO code search", prefix_chars="+",
                        add_help=False)
    tr.add_argument("rest", nargs="*", help="args passed to rl.train")
    tr.set_defaults(fn=cmd_train)

    gs = sub.add_parser("getting-started", help="environment sanity check")
    gs.set_defaults(fn=cmd_getting_started)

    pm = sub.add_parser("post-mortem", help="experiment post-hoc analysis")
    pm.add_argument("tsv", help="experiment TSV log")
    pm.add_argument("--best", action="store_true",
                    help="re-evaluate best codes")
    pm.add_argument("--heatmaps", action="store_true",
                    help="write action heat maps")
    pm.add_argument("--transmissions", type=int, default=64)
    pm.set_defaults(fn=cmd_post_mortem)

    rs = sub.add_parser("reward-surface", help="reward landscape plot")
    rs.add_argument("--start", type=float, default=2.8)
    rs.add_argument("--end", type=float, default=3.8)
    rs.add_argument("--out", default="rewardSurface.png")
    rs.set_defaults(fn=cmd_reward_surface)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
