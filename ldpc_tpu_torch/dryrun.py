"""Dry-run entry points of the port: ``entry()`` and ``dryrun_multichip(n)``,
the counterparts of the JAX package's functions of the same names.

``entry()`` returns the flagship step and its example arguments: one
Monte-Carlo decode step of CCSDS near-earth (8176, 7154) on the torch
engine (transmit the all-zero codeword through AWGN, batched min-sum
decode, per-word statistics).

``dryrun_multichip(n)`` spawns n ranks of one ``torch.distributed`` group
(``python -m ldpc_tpu_torch.dryrun``, one process a rank, on free local
ports) and runs on each:

* a sharded straight step (``parallel.sharded_sweep_step``) on the cuda
  engine (the fused kernel on the card, its plain version on the CPU)
  and, at the tiny size, on the torch engine;
* the sharded staged step, its counters equal to ONE rank's staged step
  (``sim.StagedSweep``, no collective) on the same global batch;
* the same staged step over a hierarchical (dcn, ici) mesh, equal again;
* the row-sharded decoder (``parallel.make_row_sharded_decoder``) on
  802.11n rate 1/2 with integer LLRs, equal word for word to the
  unsharded decoder;
* a vector step of the code search with its candidates sharded over the
  mesh (``EnvironmentVector(mesh=)``), equal to the unsharded step;
* ``rl.train.dryrun_train_step``: one PPO update with the batch sharded,
  within float rounding of the one-process update.

Any disagreement raises in a rank, and the dry run raises with its error.
It returns every rank's report: the counters, each part's seconds and the
fused kernel's launches by part.  ``config`` sets the sizes: ``TINY``
(the default: 802.11n, 2 words a rank) or ``FULL`` (near-earth, 16,384
words a rank at 3.4 dB, the 12 -> 50 cascade on the fused kernel; 8 envs
at the code search's defaults).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from .parallel.mesh import spawn_module_ranks

__all__ = ["entry", "dryrun_multichip", "DRYRUN_SEED", "TINY", "FULL"]

DRYRUN_SEED = 20261018
TINY = dict(code="wifi", words_per_rank=2, snr=3.5, max_iters=5,
            phase1_iters=2, redo_capacity=None, engine="torch",
            straight_engines=("torch", "cuda"), envs=2, env_code="wifi",
            row_words=2, row_iters=3)
# the torch engine takes seconds a near-earth batch: the kernel only
FULL = dict(code="near-earth", words_per_rank=16384, snr=3.4, max_iters=50,
            phase1_iters=12, redo_capacity=3 * 16384 // 16, engine="cuda",
            straight_engines=("cuda",), envs=8, env_code="near-earth",
            row_words=64, row_iters=12)


def entry(device=None):
    """(step, example_args) for the single-card check: ``step(*args)``
    decodes 64 near-earth words at 3.4 dB."""
    from .codes import near_earth_code
    from .sim.evaluate import sweep_step
    from .utils.device import resolve_device

    dev = resolve_device(device)
    step = sweep_step(near_earth_code(), max_iters=50, device=dev)
    snr = torch.full((64,), 3.4, dtype=torch.float32, device=dev)
    return step, (snr, torch.Generator(device=dev).manual_seed(0))


def _counters(out: dict) -> dict:
    keys = ("frames", "errors_uncoded", "errors_decoded", "iterations_sum",
            "success_count", "frame_errors")
    return {k: int(out[k]) for k in keys}


def _one_rank_counters(step_out: dict) -> dict:
    """A ``StagedSweep`` batch's per-word outputs as the sharded step's
    counters."""
    e, ok = step_out["errors_decoded"], step_out["success"]
    return {"frames": int(e.shape[0]),
            "errors_uncoded": int(step_out["errors_uncoded"].sum()),
            "errors_decoded": int(e.sum()),
            "iterations_sum": int(step_out["iterations"].sum()),
            "success_count": int(ok.sum()),
            "frame_errors": int(((e > 0) | ~ok).sum())}


def _expect_equal(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{what}: sharded {got} != unsharded {want}")


def _code(name: str):
    from .codes import near_earth_code, wifi_code
    return near_earth_code() if name == "near-earth" else wifi_code()


def _part(report: dict, name: str, dev, fn):
    """Run one part with the fused kernel's launches cleared before it;
    keep its seconds and launches in ``report``."""
    from .ops import cuda_static
    cuda_static.launches.clear()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report["seconds"][name] = time.perf_counter() - t0
    report["launches"][name] = {",".join(map(str, k)): c for k, c in
                                cuda_static.launches.items()}
    return out


def _sweep_parts(report, mesh, dev, cfg) -> None:
    from .parallel import (make_hierarchical_mesh, sharded_staged_sweep_step,
                           sharded_sweep_step)
    from .parallel.mesh import mesh_position
    from .sim.evaluate import StagedSweep

    world = mesh_position(mesh)[1]
    code = _code(cfg["code"])
    b = cfg["words_per_rank"] * world
    snr = torch.full((b,), cfg["snr"], dtype=torch.float32, device=dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(DRYRUN_SEED)

    for engine in cfg["straight_engines"]:
        step = sharded_sweep_step(code, mesh, max_iters=cfg["max_iters"],
                                  engine=engine, device=dev)
        out = _part(report, f"straight {engine}", dev,
                    lambda: step(snr, generator=gen()))
        if out["frames"] != b:
            raise AssertionError(f"straight {engine}: {out['frames']} "
                                 f"frames for {b}")
        report[f"straight_{engine}"] = _counters(out)
    staged = dict(max_iters=cfg["max_iters"],
                  phase1_iters=cfg["phase1_iters"],
                  redo_capacity=cfg["redo_capacity"], engine=cfg["engine"],
                  device=dev)
    step = sharded_staged_sweep_step(code, mesh, **staged)
    out = _part(report, "staged", dev, lambda: step(snr, generator=gen()))
    report["staged"] = got = _counters(out)
    report["sigma_actual_mean"] = out["sigma_actual_mean"]
    one_kw = dict(staged, redo_capacity=(None if cfg["redo_capacity"] is None
                                         else cfg["redo_capacity"] * world))
    one = StagedSweep(code, **one_kw)
    ref = _part(report, "staged one rank", dev,
                lambda: one(snr, generator=gen()))
    _expect_equal("staged step", got, _one_rank_counters(ref))
    dcn = 2 if world % 2 == 0 else world
    hmesh = make_hierarchical_mesh(dcn=dcn, ici=world // dcn, device=dev)
    hstep = sharded_staged_sweep_step(code, hmesh, **staged)
    hout = _part(report, "staged hierarchical", dev,
                 lambda: hstep(snr, generator=gen()))
    _expect_equal(f"hierarchical ({dcn}, {world // dcn}) staged step",
                  _counters(hout), got)


def _rowshard_part(report, mesh, dev, cfg) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    from .codes import wifi_code
    from .ops.decoder import decoder_for_code
    from .parallel import make_row_sharded_decoder
    from .parallel.mesh import mesh_position

    world = mesh_position(mesh)[1]
    code = wifi_code(rate=0.5)     # 12 block rows
    rows = world if code.block_rows % world == 0 else 2
    rmesh = DeviceMesh(mesh.device_type,
                       torch.arange(world).reshape(world // rows, rows),
                       mesh_dim_names=("data", "row"))
    dec = make_row_sharded_decoder(code, rmesh, max_iters=cfg["row_iters"],
                                   data_axis="data")
    rng = np.random.default_rng(11)
    words = cfg["row_words"] * (world // rows)
    llr = rng.integers(-5, 6, size=(words, code.n)).astype(np.float32)
    llr[llr == 0] = -1.0
    llr = torch.as_tensor(llr, device=dev)
    errors, iters, ok = _part(report, "row-sharded", dev, lambda: dec(llr))
    ref = decoder_for_code(code, cfg["row_iters"])(llr)
    for name, a, r in (("errors", errors, ref.hard.sum(-1, dtype=torch.int32)),
                       ("iterations", iters, ref.iterations),
                       ("success", ok, ref.success)):
        if not torch.equal(a, r):
            raise AssertionError(f"row-sharded {name} differ from the "
                                 f"unsharded decoder's")
    report["row_sharded"] = {"mesh": [world // rows, rows], "words": words,
                             "iterations": cfg["row_iters"],
                             "converged": int(ok.sum())}


def _env_part(report, mesh, dev, cfg) -> None:
    from .codes import wifi_code
    from .envs import EnvironmentVector, LdpcCodeSearchEnv
    from .parallel.mesh import mesh_position

    world = mesh_position(mesh)[1]
    n_envs = cfg["envs"] * (world if cfg["env_code"] == "wifi" else 1)
    kw = (dict(code=wifi_code(), snr_points=(3.0, 3.5), num_transmissions=4,
               num_iterations=10, dmax_cn_cap=24, dmax_vn_cap=8)
          if cfg["env_code"] == "wifi" else {})

    def fns():
        return [(lambda s=s: LdpcCodeSearchEnv(seed=s, device=dev, **kw))
                for s in range(n_envs)]

    sharded = EnvironmentVector(fns(), mesh=mesh)
    plain = EnvironmentVector(fns(), batched=True)
    sharded.reset(), plain.reset()
    e0 = plain.envs[0]
    xb, yb = e0.x_bits, e0.y_bits
    rng = np.random.RandomState(5)
    actions = []
    for _ in range(n_envs):
        a = np.zeros(e0.action_bits, np.int32)
        a[xb + yb + rng.randint(0, e0.z)] = 1
        actions.append(a)
    got = _part(report, "vector step sharded", dev,
                lambda: sharded.step(actions))
    want = _part(report, "vector step unsharded", dev,
                 lambda: plain.step(actions))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for es, ep in zip(sharded.envs, plain.envs):
        _expect_equal("env state", es.state.shifts, ep.state.shifts)
        _expect_equal("env iterations", es.accumulated_iterations,
                      ep.accumulated_iterations)
    report["vector_step"] = {"envs": n_envs,
                             "rewards": [float(r) for r in got[1]],
                             "legal": [bool(i["legal"]) for i in got[3]]}


def _rank_main(rank: int, world: int, port: int, device: str | None,
               backend: str | None, cfg: dict, out: str) -> None:
    import torch.distributed as dist

    from .parallel import initialize_distributed, make_mesh
    from .rl.train import dryrun_train_step
    from .utils.device import resolve_device

    initialize_distributed(f"localhost:{port}", world, rank, device=device,
                           backend=backend)
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(device=dev)
        report = {"rank": rank, "world": world, "device": str(dev),
                  "backend": dist.get_backend(), "config": cfg,
                  "seconds": {}, "launches": {}}
        _sweep_parts(report, mesh, dev, cfg)
        _rowshard_part(report, mesh, dev, cfg)
        _env_part(report, mesh, dev, cfg)
        report["train_step"] = tr = _part(
            report, "train step", dev,
            lambda: dryrun_train_step(mesh, device=dev))
        if tr["max_param_diff"] > 1e-5:
            raise AssertionError(f"sharded PPO update apart from the "
                                 f"one-process update: {tr}")
        pathlib.Path(out).write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, *, device=None, backend: str | None =
                     None, config: dict | None = None,
                     timeout_s: float = 900.0) -> list[dict]:
    """Spawn ``n_devices`` ranks, run the sharded pipeline on each (see the
    module note) and return their reports, rank 0 first.

    ``config``: the sizes, ``TINY`` (default) or ``FULL``, or a dict of
    the same keys.  ``device``: where every rank runs ("cpu", or None: the card, rank r on
    card r modulo the cards); ``backend`` of the group: NCCL on the card,
    gloo on the CPU by default; ``backend="gloo"`` with the card puts every
    rank on one card.  Raises if a rank fails or the ranks take more than
    ``timeout_s``; every process is stopped either way."""
    return spawn_module_ranks(
        "ldpc_tpu_torch.dryrun",
        lambda r, port, report: [str(port), str(r), str(n_devices),
                                 str(device or ""), str(backend or ""),
                                 json.dumps(config or TINY), report],
        n_devices, timeout_s, one_thread=device == "cpu")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of dryrun_multichip")
    for name in ("port", "rank", "world"):
        ap.add_argument(name, type=int)
    ap.add_argument("device")
    ap.add_argument("backend")
    ap.add_argument("config", type=json.loads)
    ap.add_argument("out")
    a = ap.parse_args()
    _rank_main(a.rank, a.world, a.port, a.device or None, a.backend or None,
               a.config, a.out)
