"""Env steps/s of the vector rollout.

The port's counterpart of the JAX package's ``scripts/rollout_throughput.py``.
Drives ``EnvironmentVector`` at 1, 4 and 8 envs with random actions of the
reference's random agent (uniform block coordinates, 3-7 hot bits,
``randomAgent.py:35-131``) and reports wall-clock env steps/s and the
legal fraction of the actions on the env's defaults (near-earth, SNR
3.0/3.2/3.4 dB x 10 transmissions, 50 iterations).  Both vector modes are
measured: sequential (``batched=False``, one decode a candidate with a
host read each, what ``ppo(num_envs=N)`` uses on one card) and fused
(``batched=True``, every candidate's decode back to back on one stream and
one host read).  On the card each candidate decodes through the fused
kernel (f32 state, the code's tables as data); on the CPU
(``LDPC_TPU_PLATFORM=cpu``) through ``ops/dynamic.py``.

Writes ``ldpc_tpu_torch/data/rollout_throughput.{json,md}`` (or ``--out``),
stamped with the port's kernel hash and the card's name and power limit.

On the card::

    python -m ldpc_tpu_torch.scripts.rollout_throughput

CPU smoke::

    LDPC_TPU_PLATFORM=cpu python -m \\
        ldpc_tpu_torch.scripts.rollout_throughput --steps 2 --warm 1 \\
        --envs 1 2 --code wifi --out /tmp/rollout
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..envs import LdpcCodeSearchEnv
from ..envs.vector import EnvironmentVector
from .studies import (artifact_base, resolve_code, stamp, study_device, sync,
                      write_artifact)


def random_actions(envs, rng, hot=(3, 7)):
    """One action per env, the random agent's distribution
    (``randomAgent.py:35-131``: uniform i/j, 3-7 hot bits)."""
    acts = []
    for e in envs:
        x = rng.randint(0, e.state.block_rows)
        y = rng.randint(0, e.state.block_cols)
        k = rng.randint(hot[0], hot[1] + 1)
        row = np.zeros(e.z, np.int32)
        row[rng.choice(e.z, size=k, replace=False)] = 1
        xb = [int(b) for b in np.binary_repr(x, e.x_bits)]
        yb = [int(b) for b in np.binary_repr(y, e.y_bits)]
        acts.append(np.concatenate([xb, yb, row]).astype(np.int32))
    return acts


def measure(n_envs, batched, steps, warm, code, seed, tx, dev):
    kw = dict(num_transmissions=tx, device=dev)
    if code is not None:
        kw["code"] = code
        kw.update(num_iterations=8, dmax_cn_cap=32, dmax_vn_cap=12)
    vec = EnvironmentVector(
        [lambda i=i: LdpcCodeSearchEnv(seed=seed + 10000 * i, **kw)
         for i in range(n_envs)], batched=batched if n_envs > 1 else None)
    vec.reset()
    rng = np.random.RandomState(seed)
    for _ in range(warm):
        vec.step(random_actions(vec.envs, rng))
    sync(dev)
    t0 = time.perf_counter()
    legal = 0
    for _ in range(steps):
        _, _, _, infos = vec.step(random_actions(vec.envs, rng))
        legal += sum(1 for i in infos if i["legal"])
    sync(dev)
    dt = time.perf_counter() - t0
    return {"envs": n_envs, "mode": ("fused" if batched else "sequential"),
            "steps": steps, "legal_fraction": legal / (steps * n_envs),
            "wall_s": dt, "env_steps_per_s": steps * n_envs / dt}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--tx", type=int, default=10)
    ap.add_argument("--seed", type=int, default=97)
    ap.add_argument("--code", default="near-earth",
                    help="near-earth (the env's defaults) or wifi (8 "
                         "iterations, caps 32/12)")
    ap.add_argument("--out", default=None,
                    help="artifact base path (default: "
                         "ldpc_tpu_torch/data/rollout_throughput on the card)")
    args = ap.parse_args(argv)

    dev = study_device()
    code = resolve_code("wifi")[0] if args.code == "wifi" else None
    rows = []
    for n in args.envs:
        for batched in ([False] if n == 1 else [False, True]):
            r = measure(n, batched, args.steps, args.warm, code, args.seed,
                        args.tx, dev)
            rows.append(r)
            print(json.dumps(r), flush=True)
    base = next((r["env_steps_per_s"] for r in rows if r["envs"] == 1),
                rows[0]["env_steps_per_s"])
    out = {"config": {"code": args.code, "tx": args.tx, "steps": args.steps,
                      "warm": args.warm},
           **stamp(dev), "rows": rows, "single_env_steps_per_s": base}
    route = ("the fused kernel (f32 state, each candidate's tables as data)"
             if dev.type == "cuda" else "ops/dynamic.py")
    md = ["# Vector rollout throughput (env steps/s)", "",
          f"{args.code} code-search env (SNR 3.0/3.2/3.4 x {args.tx} "
          f"transmissions), random actions of the random agent, "
          f"{args.steps} timed steps after {args.warm} warm ones, wall "
          f"clock; each candidate decoded by {route} "
          f"(`ldpc_tpu_torch/scripts/rollout_throughput.py`; {out['device']}; "
          f"kernel hash `{out['kernel_hash'][:12]}`).  `ppo(num_envs=N)` "
          "steps sequentially; the fused mode puts every candidate's decode "
          "back to back with one host read.", "",
          "| envs | mode | env steps/s | vs 1 env | legal |",
          "|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['envs']} | {r['mode']} | "
                  f"{r['env_steps_per_s']:.3f} | "
                  f"{r['env_steps_per_s'] / base:.2f}x | "
                  f"{r['legal_fraction']:.3f} |")
    write_artifact(artifact_base("rollout_throughput", args.out, dev), out,
                   md)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
