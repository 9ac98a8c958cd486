"""One rank of the port's multi-process CPU tests.

    python tests/torch_dist_worker.py <mode> <port> <rank> <world> <outdir>

joins a gloo group of ``world`` ranks on ``localhost:<port>`` through
``parallel.initialize_distributed`` and writes ``<outdir>/<mode>_<world>_
<rank>.json``:

* ``parallel`` (``tests/test_torch_parallel.py``): each case of the JAX
  package's ``tests/test_parallel.py`` on the port, the single-process
  reference it is held to computed in the same rank (no collective), the
  row-sharded decoder's outputs on the integer LLRs the test feeds JAX,
  the vector env and PPO with meshes;
* ``multihost`` (``tests/test_torch_multihost.py``): the port of
  ``tests/multihost_worker.py`` (two ranks).

Imports torch, numpy and ldpc_tpu_torch only: the spawned ranks do not load
JAX.
"""

import json
import os
import pathlib
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch.set_num_threads(1)

from ldpc_tpu_torch.codes import synthetic_qc_code, wifi_code  # noqa: E402
from ldpc_tpu_torch.parallel import (  # noqa: E402
    evaluate_code_sharded, initialize_distributed, make_hierarchical_mesh,
    make_mesh, make_row_sharded_decoder, process_batch_slice,
    sharded_sweep_step)
from ldpc_tpu_torch.sim import evaluate_code  # noqa: E402

CPU = "cpu"


def row_llrs(n: int, words: int = 8, seed: int = 11) -> np.ndarray:
    """Integer LLRs in {-5..5} \\ {0}: every float32 partial sum exact."""
    rng = np.random.default_rng(seed)
    llr = rng.integers(-5, 6, size=(words, n)).astype(np.float32)
    llr[llr == 0] = -1.0
    return llr


def _decoded(res) -> dict:
    return {"errors": res.hard.sum(-1).tolist(),
            "iterations": res.iterations.tolist(),
            "success": res.success.tolist()}


def _triple(out) -> dict:
    e, i, s = out
    return {"errors": e.tolist(), "iterations": i.tolist(),
            "success": s.tolist()}


def _mesh2(world: int, names=("data", "row")):
    from torch.distributed.device_mesh import DeviceMesh
    rows = max(1, world // 2)
    return DeviceMesh("cpu", torch.arange(world).reshape(world // rows,
                                                         rows),
                      mesh_dim_names=names)


def parallel_cases(rank: int, world: int, outdir: pathlib.Path) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from ldpc_tpu_torch.ops.decoder import decode
    from ldpc_tpu_torch.sim.evaluate import sweep_step

    wifi = wifi_code()
    mesh = make_mesh(device=CPU)
    out = {"mesh": {"size": mesh.size(), "names": list(mesh.mesh_dim_names),
                    "slice": list(process_batch_slice(100)),
                    "hier": list(make_hierarchical_mesh(device=CPU).shape)}}

    # test_sharded_step_matches_single_device
    snr = torch.full((16,), 3.5)
    step = sharded_sweep_step(wifi, mesh, max_iters=20, device=CPU)
    got = step(snr, generator=torch.Generator().manual_seed(4))
    ref = sweep_step(wifi, max_iters=20, device=CPU)(
        snr, generator=torch.Generator().manual_seed(4))
    out["step"] = {"sharded": {k: v for k, v in got.items()},
                   "single": {"frames": 16,
                              "errors_uncoded": int(ref["errors_uncoded"]
                                                    .sum()),
                              "errors_decoded": int(ref["errors_decoded"]
                                                    .sum()),
                              "iterations_sum": int(ref["iterations"].sum()),
                              "success_count": int(ref["success"].sum()),
                              "sigma_actual_mean": float(
                                  ref["sigma_actual"].double().mean())}}

    # test_evaluate_code_sharded_waterfall
    st = evaluate_code_sharded(wifi, [2.0, 4.0], 32, max_iters=20,
                               mesh=mesh, batch_size=16, seed=11,
                               device=CPU)
    out["waterfall"] = {"len": len(st), "summary": st.summary()}

    # test_sharded_staged_equals_single_device_staged
    kw = dict(max_iters=20, batch_size=32, seed=21, staged=True,
              phase1_iters=6, device=CPU)
    out["staged_vs_single"] = {
        "sharded": evaluate_code_sharded(wifi, [2.5, 3.5], 64, mesh=mesh,
                                         **kw).summary(),
        "single": evaluate_code(wifi, [2.5, 3.5], 64, **kw).summary()}

    # test_sharded_staged_equals_sharded_unstaged
    kw = dict(max_iters=16, mesh=mesh, batch_size=32, seed=5, device=CPU)
    out["staged_vs_unstaged"] = {
        "staged": evaluate_code_sharded(wifi, [3.0], 32, staged=True,
                                        phase1_iters=4, **kw).summary(),
        "unstaged": evaluate_code_sharded(wifi, [3.0], 32, **kw).summary()}

    # test_sharded_layered_needs_pallas: the cuda engine here
    refused = {}
    for name, extra in (("layered", dict(engine="torch",
                                         schedule="layered")),
                        ("tile_b", dict(pallas_tile_b=128)),
                        ("sort_words", dict(sort_words=True))):
        try:
            evaluate_code_sharded(wifi, [3.0], 8, max_iters=10, mesh=mesh,
                                  device=CPU, **extra)
            refused[name] = None
        except ValueError as exc:
            refused[name] = str(exc)
    out["refused"] = refused

    # test_sharded_layered_schedule_matches_single_device (the kernel's
    # plain version on the CPU)
    kw = dict(max_iters=12, batch_size=16, seed=3, staged=True,
              phase1_iters=4, engine="cuda", schedule="layered", device=CPU)
    out["layered"] = {
        "sharded": evaluate_code_sharded(wifi, [3.0], 32, mesh=mesh,
                                         **kw).summary(),
        "single": evaluate_code(wifi, [3.0], 32, **kw).summary()}

    # test_sharded_checkpoint_resume_and_early_abort
    ckpt = str(outdir / f"sweep_{world}.npz")
    kw = dict(max_iters=12, mesh=mesh, batch_size=16, seed=9, staged=True,
              phase1_iters=4, device=CPU)
    a = evaluate_code_sharded(wifi, [2.0, 4.0], 32, checkpoint_path=ckpt,
                              **kw)
    b = evaluate_code_sharded(wifi, [2.0, 4.0], 32, checkpoint_path=ckpt,
                              **kw)
    c = evaluate_code_sharded(wifi, [2.0, 4.0], 32, early_abort_ber=1e-6,
                              **kw)
    out["checkpoint"] = {"a": a.summary(), "b": b.summary(),
                         "c_snrs": np.unique(c.column("snr")).tolist()}

    # test_sharded_and_unsharded_sweeps_agree_statistically (the same
    # batching: equal here, word for word)
    out["statistical"] = {
        "sharded": evaluate_code_sharded(wifi, [3.5], 64, max_iters=20,
                                         mesh=mesh, batch_size=32, seed=21,
                                         device=CPU).summary(),
        "single": evaluate_code(wifi, [3.5], 64, max_iters=20,
                                batch_size=32, seed=21,
                                device=CPU).summary()}

    # test_sharded_pallas_engine_matches_xla: cuda against torch
    kw = dict(max_iters=12, mesh=mesh, batch_size=32, seed=13, device=CPU)
    out["engines"] = {
        "cuda": evaluate_code_sharded(wifi, [2.8], 32, engine="cuda",
                                      **kw).summary(),
        "torch": evaluate_code_sharded(wifi, [2.8], 32, engine="torch",
                                       **kw).summary()}

    # the JAX comparison's sweep: 256 words at 2.5 dB
    out["vs_jax"] = evaluate_code_sharded(
        wifi, [2.5], 256, max_iters=20, mesh=mesh, batch_size=64, seed=17,
        device=CPU).summary()

    # test_row_sharded_decoder_exact_integer_llrs (1-D and 2-D meshes)
    half = wifi_code(rate=0.5)          # 12 block rows
    llr = torch.as_tensor(row_llrs(half.n))
    rmesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("row",))
    out["row_1d"] = _triple(make_row_sharded_decoder(
        half, rmesh, max_iters=12)(llr))
    out["row_2d"] = _triple(make_row_sharded_decoder(
        half, _mesh2(world), max_iters=12, data_axis="data")(llr))
    out["row_mesh_2d"] = list(_mesh2(world).shape)
    out["row_plain"] = _decoded(decode(half, llr, max_iters=12))

    # test_synthetic_qc_code_and_giant_rowshard
    giant = synthetic_qc_code(2048, 8, 24, seed=1)
    gllr = torch.as_tensor(row_llrs(giant.n, words=2, seed=2))
    out["giant"] = {"sharded": _triple(make_row_sharded_decoder(
        giant, rmesh, max_iters=6)(gllr)),
        "plain": _decoded(decode(giant, gllr, max_iters=6)),
        "degrees": sorted(set(giant.col_degrees())), "n": giant.n}

    # test_row_sharded_decoder_2d_mesh_awgn
    from ldpc_tpu_torch.sim.channel import transmit_zero_codeword
    noisy, _, _ = transmit_zero_codeword(
        8, half.n, 2.0, generator=torch.Generator().manual_seed(3),
        device=CPU)
    out["row_awgn"] = {"sharded": _triple(make_row_sharded_decoder(
        half, _mesh2(world), max_iters=10, data_axis="data")(noisy)),
        "plain": _decoded(decode(half, noisy, max_iters=10))}

    out["vector_env"] = vector_env_case(mesh, world)
    out["ppo"] = ppo_case(mesh, outdir / f"ppo_{world}_{rank}")
    from ldpc_tpu_torch.rl.train import dryrun_train_step
    out["train_step"] = dryrun_train_step(mesh, device=CPU)
    return out


def small_env_fns(n: int, mesh_seed: int = 0):
    from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
    kw = dict(code=wifi_code(), snr_points=(3.0, 3.5), num_transmissions=4,
              num_iterations=10, dmax_cn_cap=24, dmax_vn_cap=8, device=CPU)
    return [(lambda s=s: LdpcCodeSearchEnv(seed=s + mesh_seed, **kw))
            for s in range(n)]


def vector_env_case(mesh, world: int) -> dict:
    """Two steps of 2 x world envs (one illegal action a step): sharded
    over the mesh (batched=None fuses) against sequential stepping."""
    from ldpc_tpu_torch.envs import EnvironmentVector
    n = 2 * world
    sharded = EnvironmentVector(small_env_fns(n), mesh=mesh)
    seq = EnvironmentVector(small_env_fns(n), batched=False)
    sharded.reset(), seq.reset()
    e0 = seq.envs[0]
    xb, yb = e0.x_bits, e0.y_bits
    rng = np.random.RandomState(0)
    rec = {"rewards": [], "seq_rewards": [], "legal": [], "equal_state": [],
           "iterations": [], "seq_iterations": []}
    for _ in range(2):
        actions = []
        for _ in range(n):
            a = np.zeros(e0.action_bits, np.int32)
            a[xb + yb + rng.randint(0, e0.z)] = 1
            actions.append(a)
        actions[-1][xb:xb + yb] = 1       # block col 31 of 24: illegal
        _, r, d, info = sharded.step(actions)
        _, r2, d2, _ = seq.step(actions)
        rec["rewards"].append(r.tolist())
        rec["seq_rewards"].append(r2.tolist())
        rec["legal"].append([i["legal"] for i in info])
        rec["equal_state"].append(all(
            a.state.shifts == b.state.shifts
            for a, b in zip(sharded.envs, seq.envs)))
        rec["iterations"].append([e.accumulated_iterations
                                  for e in sharded.envs])
        rec["seq_iterations"].append([e.accumulated_iterations
                                      for e in seq.envs])
    return rec


def ppo_case(mesh, outdir: pathlib.Path) -> dict:
    """One epoch of PPO on 2 envs with the update batch and the env step
    sharded over the mesh, against the same run in this process alone."""
    from ldpc_tpu_torch.rl import ActorCriticConfig, PPOConfig, ppo
    cfg = PPOConfig(steps_per_epoch=3, epochs=1, train_pi_iters=2,
                    train_v_iters=2, seed=5)
    env_fn = small_env_fns(1)[0]
    ac = ActorCriticConfig(obs_dim=env_fn().observation_space.shape[0],
                           hidden=16, row_range=4, col_range=24, z=81,
                           max_hot=3)
    runs = {}
    for name, m in (("sharded", mesh), ("one", None)):
        actor, critic, _ = ppo(env_fn, cfg, ac, num_envs=2, mesh=m,
                               env_mesh=m, output_dir=outdir / name,
                               device=CPU)
        runs[name] = [p.detach().clone() for p in (*actor.parameters(),
                                                   *critic.parameters())]
    diff = max(float((p - q).abs().max())
               for p, q in zip(runs["sharded"], runs["one"]))
    steps = outdir / "sharded" / "steps.tsv"
    return {"max_param_diff": diff,
            "steps_tsv_written": steps.exists(),
            "steps_equal": (steps.exists() and steps.read_text() ==
                            (outdir / "one" / "steps.tsv").read_text())}


def multihost_cases(rank: int, world: int, outdir: pathlib.Path) -> dict:
    """The port of tests/multihost_worker.py."""
    import torch.distributed as dist

    from ldpc_tpu_torch.rl.buffer import PPOBuffer
    from ldpc_tpu_torch.utils.logging import EpochLogger, statistics_scalar

    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    start, size = process_batch_slice(10)
    out["slice"] = [start, size]
    stats = evaluate_code_sharded(
        wifi_code(), [2.0, 4.0], 16, max_iters=12, batch_size=16, seed=11,
        staged=True, phase1_iters=4, device=CPU)
    out["summary"] = stats.summary()
    local_vals = [float(rank * 10 + j) for j in range(3)]
    out["stat"] = list(statistics_scalar(local_vals, with_min_and_max=True,
                                         distributed=True))
    buf = PPOBuffer(obs_dim=2, act_dim=3, size=3, gamma=1.0, lam=1.0,
                    num_entropy_heads=2)
    for r in local_vals:
        buf.store(np.zeros(2), np.zeros(3), r, 0.0, -1.0, 0.0, np.zeros(2))
    buf.finish_path(0.0)
    raw = buf.adv_buf.copy()
    data = buf.get(stat_fn=lambda a: statistics_scalar(a, distributed=True))
    out["raw_adv"] = [float(x) for x in raw]
    out["adv_norm"] = [float(x) for x in data["adv"]]
    logger = EpochLogger(output_dir=outdir / f"logger_{rank}")
    logger.store(Reward=float(rank + 1))
    logger.log_tabular("Reward", with_min_and_max=True)
    logger.dump_tabular()
    logger.close()
    out["logger_wrote"] = (outdir / f"logger_{rank}" /
                           "progress.txt").exists()
    return out


def spawn_groups(mode: str, worlds, outdir, timeout_s: float) -> dict:
    """Start one group of each size in ``worlds`` (all at once, each on a
    port free at run time), wait for every rank at most ``timeout_s`` in
    all, and return {(world, rank): result}.  A rank that fails, or a
    group past the time, raises with the ranks' errors; no process is
    left running."""
    import socket
    import subprocess
    import time

    outdir = pathlib.Path(outdir)
    procs = []
    try:
        for world in worlds:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            procs += [(world, rank, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, str(port),
                 str(rank), str(world), str(outdir)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
                for rank in range(world)]
        deadline = time.monotonic() + timeout_s
        errors = []
        for world, rank, p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                errors.append(f"{mode} world {world} rank {rank} exited "
                              f"{p.returncode}:\n{err[-3000:]}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return {(w, r): json.loads((outdir / f"{mode}_{w}_{r}.json")
                               .read_text())
            for w, r, _ in procs}


def main():
    mode, port, rank, world, outdir = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), int(sys.argv[4]),
                                       pathlib.Path(sys.argv[5]))
    import torch.distributed as dist
    initialize_distributed(f"localhost:{port}", world, rank, device=CPU,
                           timeout_s=120)
    path = outdir / f"{mode}_{world}_{rank}.json"
    try:
        cases = {"parallel": parallel_cases,
                 "multihost": multihost_cases}[mode]
        result = cases(rank, world, outdir)
    except Exception:  # noqa: BLE001 - the test reads the traceback
        result = {"error": traceback.format_exc()}
        path.write_text(json.dumps(result))
        raise
    finally:
        dist.destroy_process_group()
    path.write_text(json.dumps(result))


if __name__ == "__main__":
    main()
