"""Training entry point (the port of ``ldpc_tpu.rl.train``).

``main`` is the ``python openAIppo.py`` equivalent (openAIppo.py:546-576)
with argparse defaults matching the reference CLI.  It trains on the card;
``main(argv, device="cpu")`` (or ``LDPC_TPU_PLATFORM=cpu`` through
``python -m ldpc_tpu_torch.cli train``) trains on the CPU.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from ..utils.device import resolve_device
from .ppo import PPOConfig, ppo

__all__ = ["main", "dryrun_train_step"]


def dryrun_train_step(mesh, device=None) -> dict:
    """One PPO policy + value update on tiny shapes, the batch (2 rows a
    rank) sharded over ``mesh`` (``parallel.make_mesh``; every rank of it
    calls this), beside the same update in one process from the same
    weights and batch.  Returns the sharded update's extras and value
    loss, and the largest difference between the two updates' parameters
    (``max_param_diff``), which float rounding alone sets.  ``device``:
    where this rank runs (default: the card)."""
    import torch

    from ..parallel.mesh import mesh_position
    from .model import ActorCriticConfig, init_params
    from .ppo import make_update_fns

    dev = resolve_device(device)
    ndev = mesh_position(mesh)[1]
    cfg = ActorCriticConfig(obs_dim=64, hidden=16, row_range=2, col_range=4,
                            z=31, max_hot=3)
    ppo_cfg = PPOConfig(steps_per_epoch=2 * ndev)
    b = 2 * ndev
    gen = torch.Generator().manual_seed(0)
    obs = torch.rand(b, cfg.obs_dim, generator=gen).to(dev)
    act = torch.cat([torch.zeros(b, 2, dtype=torch.int64),
                     torch.ones(b, 1, dtype=torch.int64),
                     torch.zeros(b, cfg.max_hot, dtype=torch.int64)],
                    -1).to(dev)
    adv = torch.linspace(-1.0, 1.0, b, device=dev)
    ret = torch.ones(b, device=dev)
    logp = torch.full((b,), -3.0, device=dev)
    out, params = {}, {}
    for name, m in (("sharded", mesh), ("one_process", None)):
        actor, critic = init_params(cfg, seed=0, device=dev)
        pi_opt, vf_opt, pi_update, v_update = make_update_fns(
            cfg, ppo_cfg, mesh=m)
        pi_opt, vf_opt = (pi_opt(actor.parameters()),
                          vf_opt(critic.parameters()))
        extras = pi_update(actor, pi_opt, obs, act, adv, logp)
        v_l = v_update(critic, vf_opt, obs, ret)
        out[name] = {**{k: float(v) for k, v in extras.items()},
                     "loss_v": float(v_l)}
        params[name] = [p.detach() for p in (*actor.parameters(),
                                             *critic.parameters())]
    diff = max(float((p - q).abs().max()) for p, q in zip(
        params["sharded"], params["one_process"]))
    return {**out["sharded"], "one_process": out["one_process"],
            "max_param_diff": diff, "batch": b}


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        description="PPO code search (openAIppo.py equivalent)")
    parser.add_argument("--hid", type=int, default=64)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--seed", "-s", type=int, default=30)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--entropyCoefficient", type=float, default=0.01)
    parser.add_argument("--entropy_bonus", action="store_true",
                        help="standard entropy bonus (explore) instead of "
                             "the reference's penalty sign, openAIppo.py:337")
    parser.add_argument("--policyCoefficient", type=float, default=1.0)
    parser.add_argument("--exp_name", type=str, default="ppo")
    parser.add_argument("--data_dir", type=str,
                        default=os.path.join(tempfile.gettempdir(),
                                             "experiments",
                                             str(int(time.time()))))
    parser.add_argument("--num_transmissions", type=int, nargs="+",
                        default=[10],
                        help="per (SNR, step); one value applies to every "
                             "SNR point, N values give each point its own "
                             "count (deep floor points are nearly free — "
                             "high-SNR words converge in ~4-6 iterations)")
    parser.add_argument("--phase1_iterations", type=int, default=None,
                        help="host-staged env decode: phase-1 cap; only "
                             "failures pay the full budget (identical "
                             "results, big win for deep floor points)")
    parser.add_argument("--floor_penalty", type=float, nargs="+",
                        default=[0.0],
                        help="subtract penalty_i * FER(floor point i) "
                             "from the reward (floor-aware search; the "
                             "plain integral is waterfall-dominated); one "
                             "value per --floor_snr_index entry")
    parser.add_argument("--floor_snr_index", type=int, nargs="+",
                        default=[-1],
                        help="indices into --snr of the floor-penalty "
                             "points (default: the highest point)")
    parser.add_argument("--floor_penalty_final", type=float, default=None,
                        help="anneal the floor-penalty SCALE linearly "
                             "from 1.0 at epoch 0 to final/initial at the "
                             "last epoch (initial = the largest "
                             "--floor_penalty term); resume recomputes "
                             "the schedule from the epoch number")
    parser.add_argument("--snr", type=float, nargs="+", default=None,
                        help="env SNR points (default 3.0 3.2 3.4, "
                             "ldpc_env.py:88; e.g. 3.0 3.2 3.4 3.6 3.8 "
                             "searches the reference's wide reward window, "
                             "postProcessing.py:18)")
    parser.add_argument("--num_envs", "--cpu", type=int, default=1,
                        help="parallel rollout envs (the reference's "
                             "mpi_fork rank count, openAIppo.py:564; "
                             "replicas are reseeded seed + 10000*i)")
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest checkpoint (parameters, "
                             "optimizer states, generators, env states) "
                             "and continue; progress/steps logs are "
                             "appended")
    parser.add_argument("--start_instance", default=None,
                        help="path to a saved code instance (.npz/.mat) "
                             "to use as the search start state instead of "
                             "CCSDS near-earth — e.g. bootstrap a new "
                             "search from a previously discovered code")
    parser.add_argument("--start_code", default=None,
                        choices=["near-earth", "wifi"],
                        help="named start state: 'wifi' searches the "
                             "802.11n rate-5/6 shape (4x24, Z=81) — the "
                             "env/decoder/encoder are code-agnostic, so "
                             "the MDP generalizes beyond the reference's "
                             "hardcoded near-earth family "
                             "(wifiMatrices.py:6-34 + ldpc_env.py:82-90)")
    parser.add_argument("--dmax_cn_cap", type=int, default=None,
                        help="check-degree cap for the dynamic decoder "
                             "(default: env default 48; wifi uses 24)")
    parser.add_argument("--dmax_vn_cap", type=int, default=None,
                        help="variable-degree cap (default 18; wifi 8)")
    args = parser.parse_args(argv)
    resolve_device(device)    # no card and no "cpu": raise before any I/O

    from ..envs.code_search import LdpcCodeSearchEnv
    from ..utils.logging import EpochLogger

    ppo_cfg = PPOConfig(
        steps_per_epoch=args.steps, epochs=args.epochs, gamma=args.gamma,
        seed=args.seed, entropy_coefficient=args.entropyCoefficient,
        entropy_bonus=args.entropy_bonus,
        policy_coefficient=args.policyCoefficient)
    logger = EpochLogger(
        output_dir=f"{args.data_dir}/{args.exp_name}/"
                   f"{args.exp_name}_s{args.seed}",
        exp_name=args.exp_name, append=args.resume)
    env_kw = {} if args.snr is None else {"snr_points": tuple(args.snr)}
    tx = (args.num_transmissions[0] if len(args.num_transmissions) == 1
          else tuple(args.num_transmissions))
    if any(args.floor_penalty):
        env_kw["floor_penalty"] = (
            args.floor_penalty[0] if len(args.floor_penalty) == 1
            else tuple(args.floor_penalty))
        env_kw["floor_snr_index"] = (
            args.floor_snr_index[0] if len(args.floor_snr_index) == 1
            else tuple(args.floor_snr_index))
    epoch_callback = None
    if args.floor_penalty_final is not None and any(args.floor_penalty):
        initial = max(args.floor_penalty)
        ratio = args.floor_penalty_final / initial
        last = max(1, args.epochs - 1)

        def epoch_callback(epoch, envs):  # noqa: F811 — the anneal hook
            scale = 1.0 + (ratio - 1.0) * min(epoch, last) / last
            for e in envs:
                e.floor_penalty_scale = scale
    if args.phase1_iterations:
        env_kw["phase1_iterations"] = args.phase1_iterations
    if args.start_instance:
        from ..codes.io import load_code_instance
        env_kw["code"] = load_code_instance(args.start_instance)[0]
    elif args.start_code == "wifi":
        from ..codes import wifi_code
        env_kw["code"] = wifi_code()
        env_kw.setdefault("dmax_cn_cap", 24)
        env_kw.setdefault("dmax_vn_cap", 8)
    if args.dmax_cn_cap:
        env_kw["dmax_cn_cap"] = args.dmax_cn_cap
    if args.dmax_vn_cap:
        env_kw["dmax_vn_cap"] = args.dmax_vn_cap
    return ppo(lambda: LdpcCodeSearchEnv(
        seed=args.seed, num_transmissions=tx, device=device, **env_kw),
        ppo_cfg, logger=logger, num_envs=args.num_envs, resume=args.resume,
        checkpoint_dir=f"{args.data_dir}/{args.exp_name}/checkpoints",
        epoch_callback=epoch_callback, device=device)


if __name__ == "__main__":
    main()
