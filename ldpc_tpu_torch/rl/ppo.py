"""PPO for LDPC code search (reference ``openAIppo.py:135-544``; the port of
``ldpc_tpu.rl.ppo``).

Faithful to the reference algorithm: clipped surrogate objective
(openAIppo.py:303-339), optional entropy coefficient applied to the i-head
entropy only (:337 — note the reference ADDS ``coef * iEntropy`` to the
minimized loss; we keep that sign and the default coef 0.01), KL early stop
at ``1.5 * target_kl`` (:390-392), separate Adam optimizers and iteration
counts for policy and value (:342-348, 406-412), GAE buffer with
normalized advantages, bootstrap on epoch truncation (:471-483), model/env
checkpoints every ``save_freq`` epochs (:507-508).

On the card: the policy, the value net and the update batch live on
``device``; each rollout step samples every env's action in one batched
forward pass and reads the actions, values, log-probs and entropies back
in ONE transfer; each env step decodes its candidate through the fused
kernel (``envs/code_search.py``).  ``torch.optim.Adam`` (b1 0.9, b2
0.999, eps 1e-8, no weight decay) takes optax's place.

Data-parallel rollout (the reference's headline ``mpi_fork(args.cpu)``
training mode, mpi_tools.py:6-39 + buffer.py:110-181): ``num_envs > 1``
drives an :class:`~ldpc_tpu_torch.envs.vector.EnvironmentVector` — one
PPOBuffer per env merged by :class:`BufferContainer` at update time.  Each
env samples from its own ``torch.Generator`` (``env_generators``), so
per-env action/reward streams are IDENTICAL to stepping the same envs
sequentially with the same generators (each env also draws channel noise
from its own RandomState).

Advantage normalization reduces across ranks when a ``torch.distributed``
process group of more than one rank is initialised
(``statistics_scalar(distributed=True)``, the ``mpi_statistics_scalar``
contract of the reference, buffer.py:97).

Checkpoints (every ``save_freq`` epochs and at the end) hold the FULL
training state — parameters, both optimizer states, every env's sampling
generator, every env's code/budgets/RandomState, per-env episode
accumulators and the current observations — so ``ppo(..., resume=True)``
continues an interrupted search exactly where it stopped (the reference
saves a pickle but has no resume logic, openAIppo.py:507-508 / SURVEY.md
§5).

The reference's known-broken tail (a live debug ``env.step`` inside
``update()``, openAIppo.py:399) is intentionally not reproduced.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..envs.vector import EnvironmentVector
from ..utils.device import resolve_device
from ..utils.logging import (EpochLogger, TsvLogger, _is_chief,
                             statistics_scalar)
from .buffer import BufferContainer
from .model import (ActorCriticConfig, action_to_env_action,
                    evaluate_actions, init_params, sample_step)

__all__ = ["PPOConfig", "ppo", "make_update_fns", "env_generators"]


@dataclasses.dataclass
class PPOConfig:
    steps_per_epoch: int = 64      # PER ENV (openAIppo.py:137; an epoch
    epochs: int = 50               # collects num_envs * steps_per_epoch)
    gamma: float = 0.99
    clip_ratio: float = 0.2
    pi_lr: float = 3e-4
    vf_lr: float = 1e-3
    train_pi_iters: int = 80
    train_v_iters: int = 80
    lam: float = 0.97
    target_kl: float = 0.01
    entropy_coefficient: float = 0.01   # CLI default, openAIppo.py:560
    # The reference ADDS coef * iEntropy to the MINIMIZED loss
    # (openAIppo.py:337) — an entropy *penalty*.  The default keeps that
    # sign for parity; set entropy_bonus=True for the standard
    # exploration bonus (entropy subtracted from the loss), which is
    # what a long search should use.
    entropy_bonus: bool = False
    policy_coefficient: float = 1.0
    seed: int = 30
    save_freq: int = 10
    max_ep_len: int = 1000


def _sum_over_mesh(params, extras: torch.Tensor, mesh) -> torch.Tensor:
    """Sum every parameter's gradient and ``extras`` over ``mesh`` in one
    ``all_reduce``; the gradients are written back, the summed extras
    returned."""
    from ..parallel.mesh import all_reduce_sum
    params = list(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads] +
                                    [extras.to(grads[0].dtype)]), mesh)
    at = 0
    for p, g in zip(params, grads):
        p.grad = flat[at:at + g.numel()].view_as(g)
        at += g.numel()
    return flat[at:]


def make_update_fns(cfg: ActorCriticConfig, ppo_cfg: PPOConfig,
                    mesh=None):
    """(pi_opt, vf_opt, pi_update, v_update).

    ``pi_opt(params)``/``vf_opt(params)`` make the two Adam optimisers;
    ``pi_update(actor, opt, obs, act, adv, logp_old) -> extras`` and
    ``v_update(critic, opt, obs, ret) -> loss`` take one step in place.
    The extras (``kl``, ``entropy``, ``i_entropy``, ``loss_pi``,
    ``clipfrac``, detached tensors) come from the forward pass before the
    step, so the first KL of a batch is 0.

    ``mesh`` (``parallel.make_mesh``) shards the update batch, which every
    rank holds whole: each rank takes its rows, its losses are its rows'
    sums over the global count, and the gradients (and the extras) are
    summed over the ranks in one ``all_reduce`` before Adam, so the step
    equals the one-process step within float tolerance on every rank.
    """
    from ..parallel.mesh import mesh_rows
    pi_opt, vf_opt = _adam(ppo_cfg.pi_lr), _adam(ppo_cfg.vf_lr)
    clip = ppo_cfg.clip_ratio
    ent_sign = -1.0 if ppo_cfg.entropy_bonus else 1.0

    def pi_update(actor, opt, obs, act, adv, logp_old):
        n = obs.shape[0]
        if mesh is not None:
            rows = mesh_rows(mesh, n)
            obs, act, adv, logp_old = (x[rows] for x in (obs, act, adv,
                                                         logp_old))
        mean = torch.mean if mesh is None else (lambda x: x.sum() / n)
        out = evaluate_actions(cfg, actor, obs, act)
        logp = out["logp"]
        ratio = torch.exp(logp - logp_old)
        clip_adv = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
        loss_pi = -mean(torch.minimum(ratio * adv, clip_adv))
        i_entropy = mean(out["entropy_per_head"][..., 0])
        total = (ppo_cfg.policy_coefficient * loss_pi +
                 ent_sign * ppo_cfg.entropy_coefficient * i_entropy)
        opt.zero_grad(set_to_none=True)
        total.backward()
        with torch.no_grad():
            clipped = (ratio > 1 + clip) | (ratio < 1 - clip)
            extras = torch.stack([
                mean(logp_old - logp), mean(out["entropy"]),
                i_entropy.detach(), loss_pi.detach(),
                mean(clipped.to(torch.float32))])
            if mesh is not None:
                extras = _sum_over_mesh(actor.parameters(), extras, mesh)
        opt.step()
        return dict(zip(("kl", "entropy", "i_entropy", "loss_pi",
                         "clipfrac"), extras))

    def v_update(critic, opt, obs, ret):
        """One step of the value net on the mean squared error to
        ``ret``."""
        n = obs.shape[0]
        if mesh is None:
            return _value_update(critic, opt, obs, ret)
        rows = mesh_rows(mesh, n)
        loss = ((critic(obs[rows]) - ret[rows]) ** 2).sum() / n
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = _sum_over_mesh(critic.parameters(), loss.detach()[None],
                              mesh)[0]
        opt.step()
        return loss

    return pi_opt, vf_opt, pi_update, v_update


def _adam(lr: float):
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, no weight decay."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def _value_update(critic, opt, obs, ret):
    """One step of the value net on the mean squared error to ``ret``."""
    loss = torch.mean((critic(obs) - ret) ** 2)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def env_generators(seed: int, num_envs: int, device) -> list:
    """Each env's sampling generator on the policy's device: env i's is
    seeded ``seed + 10000 * i``, the envs' own reseeding rule."""
    return [torch.Generator(device=device).manual_seed(seed + 10000 * i)
            for i in range(num_envs)]


def _env_checkpoint_state(envs, obs, ep_ret, ep_len) -> dict:
    """Every env's full mutable state as tensors (``weights_only`` loads
    take no numpy arrays)."""
    rows = np.stack([np.asarray(e.state.first_rows()) for e in envs])
    rstates = [e.rng.get_state() for e in envs]
    return {
        "first_rows": torch.tensor(rows, dtype=torch.int32),
        "acc_time": torch.tensor([e.accumulated_evaluation_time
                                  for e in envs], dtype=torch.float64),
        "acc_iters": torch.tensor([e.accumulated_iterations for e in envs],
                                  dtype=torch.int64),
        # numpy MT19937 state: ('MT19937', keys[624] u32, pos, has_gauss,
        # cached_gaussian); the uint32 keys kept in int64
        "rng_keys": torch.tensor(np.stack([s[1] for s in rstates]).astype(
            np.int64)),
        "rng_pos": torch.tensor([s[2] for s in rstates], dtype=torch.int64),
        "rng_has_gauss": torch.tensor([s[3] for s in rstates],
                                      dtype=torch.int64),
        "rng_cached": torch.tensor([s[4] for s in rstates],
                                   dtype=torch.float64),
        "obs": torch.tensor(np.asarray(obs, np.float32)),
        "ep_ret": torch.tensor(np.asarray(ep_ret, np.float64)),
        "ep_len": torch.tensor(np.asarray(ep_len, np.int64)),
    }


def _restore_env_state(envs, st) -> tuple:
    """Inverse of :func:`_env_checkpoint_state`; returns (obs, ep_ret,
    ep_len)."""
    from ..codes.qc import QCCode

    for i, e in enumerate(envs):
        ref = e.reset_value
        e.state = QCCode.from_first_rows(
            st["first_rows"][i].numpy(), name=ref.name,
            message_size=ref.message_size)
        e.accumulated_evaluation_time = float(st["acc_time"][i])
        e.accumulated_iterations = int(st["acc_iters"][i])
        e.rng.set_state(("MT19937",
                         st["rng_keys"][i].numpy().astype(np.uint32),
                         int(st["rng_pos"][i]),
                         int(st["rng_has_gauss"][i]),
                         float(st["rng_cached"][i])))
        e.observed_state = e.compress()
    return (st["obs"].numpy().astype(np.float32),
            st["ep_ret"].numpy().astype(np.float64),
            st["ep_len"].numpy().astype(np.int64))


def _truncate_steps_tsv(path, max_epoch):
    lines = path.read_text().splitlines()
    kept = lines[:1] + [ln for ln in lines[1:]
                        if int(ln.split("\t")[0]) <= max_epoch]
    path.write_text("\n".join(kept) + ("\n" if kept else ""))


def _policy_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_env_devices(envs, dev: torch.device) -> None:
    """An env that decodes on another device than the policy's raises
    (an env without a ``device`` runs on the host only)."""
    for i, e in enumerate(envs):
        env_dev = getattr(e, "device", None)
        if env_dev is not None and torch.device(env_dev) != dev:
            raise ValueError(f"env {i} decodes on {env_dev}, the policy "
                             f"runs on {dev}: pass both the same device")


def ppo(env_fn: Callable | Sequence[Callable],
        ppo_cfg: PPOConfig | None = None,
        ac_cfg: ActorCriticConfig | None = None, *, num_envs: int = 1,
        mesh=None, env_mesh=None, env_batched: bool | None = None,
        logger: EpochLogger | None = None, output_dir=None,
        checkpoint_dir=None, resume: bool = False,
        deterministic_eval: bool = False, epoch_callback=None,
        device=None):
    """Run PPO; returns (actor, critic, logger).

    ``env_fn`` is a thunk ``() -> env`` with the LdpcCodeSearchEnv
    interface, like the reference's ``gym.make`` thunk (openAIppo.py:573),
    or a sequence of such thunks (one per env).  With a single thunk and
    ``num_envs > 1`` the envs are replicas reseeded ``seed + 10000 * i``
    — the reference's per-rank seeding (openAIppo.py:264).

    ``num_envs`` parallel envs collect ``num_envs * steps_per_epoch``
    transitions per epoch through an EnvironmentVector (``env_mesh`` /
    ``env_batched`` forwarded: a mesh shards one vector step's candidate
    decodes over its ranks; True steps every candidate with one host
    read); ``mesh`` shards the UPDATE batch (``make_update_fns``).  With a
    mesh, every rank of the ``torch.distributed`` group calls ``ppo`` with
    the same arguments: the rollout is the same on every rank, and only
    rank 0 writes logs and checkpoints.

    ``device``: where the policy, the value net and the update batch live
    (default: the card; ``"cpu"`` only when asked).  An env that decodes
    on another device raises.

    ``resume=True`` restores the latest checkpoint in ``checkpoint_dir``
    (parameters, optimizer states, generators, env states, episode
    accumulators) and continues from the next epoch; pass a
    logger/output_dir opened in append mode to keep one contiguous
    progress/steps log.

    ``epoch_callback(epoch, envs)`` (optional) runs before each epoch's
    rollout — the hook for schedules that mutate env knobs per epoch
    (e.g. annealing ``floor_penalty_scale`` on the code-search env).  It
    must be a pure function of ``epoch`` for resume to reproduce the
    schedule (it is re-invoked at the resumed epoch, not replayed).
    """
    ppo_cfg = ppo_cfg or PPOConfig()
    dev = _policy_device(device)
    if callable(env_fn):
        env_fns = [env_fn] * num_envs
        reseed = num_envs > 1
    else:
        env_fns = list(env_fn)
        num_envs = len(env_fns)
        reseed = False
    vec = EnvironmentVector(env_fns, batched=env_batched, mesh=env_mesh)
    _check_env_devices(vec.envs, dev)
    if reseed:
        base = getattr(vec.envs[0], "seed_value", ppo_cfg.seed)
        vec.seed([base + 10000 * i for i in range(num_envs)])
    env0 = vec.envs[0]
    obs_dim = vec.observation_space.shape[0]
    if ac_cfg is None:
        ac_cfg = ActorCriticConfig(
            obs_dim=obs_dim,
            row_range=env0.state.block_rows,
            col_range=env0.state.block_cols,
            z=env0.z)
    logger = logger or EpochLogger(output_dir=output_dir, exp_name="ppo",
                                   append=resume)
    if not resume:
        logger.save_config({"ppo": dataclasses.asdict(ppo_cfg),
                            "model": dataclasses.asdict(ac_cfg),
                            "num_envs": num_envs})
    gens = env_generators(ppo_cfg.seed, num_envs, dev)
    actor, critic = init_params(ac_cfg, ppo_cfg.seed, device=dev)
    pi_opt, vf_opt, pi_update, v_update = make_update_fns(ac_cfg, ppo_cfg,
                                                          mesh=mesh)
    pi_opt, vf_opt = pi_opt(actor.parameters()), vf_opt(critic.parameters())
    adim = ac_cfg.buffer_action_dim

    def sample_vec(obs):
        """Every env's action from its own generator, one batched forward
        pass, read back in one transfer: [N, adim + 2 + heads] float32."""
        ba, v, logp, ent = sample_step(
            ac_cfg, actor, critic, torch.as_tensor(obs, device=dev), gens,
            deterministic=deterministic_eval)
        return torch.cat([ba.to(torch.float32), v[:, None], logp[:, None],
                          ent], -1).cpu().numpy()

    def critic_apply(obs):
        with torch.no_grad():
            return critic(torch.as_tensor(obs, device=dev)).cpu().numpy()

    bufs = BufferContainer(obs_dim, adim, ppo_cfg.steps_per_epoch,
                           num_envs, ppo_cfg.gamma, ppo_cfg.lam,
                           num_entropy_heads=ac_cfg.num_entropy_heads)

    # Cross-process advantage normalization (buffer.py:97 ->
    # mpi_statistics_scalar): global when a process group of more than
    # one rank is initialised, local otherwise.
    def stat_fn(a):
        return statistics_scalar(a, distributed=True)

    start_epoch = 0
    obs = vec.reset().astype(np.float32)
    ep_ret = np.zeros(num_envs, np.float64)
    ep_len = np.zeros(num_envs, np.int64)

    def full_state(epoch):
        return {
            "actor": actor.state_dict(), "critic": critic.state_dict(),
            "pi_opt": pi_opt.state_dict(), "vf_opt": vf_opt.state_dict(),
            "rng": [g.get_state() for g in gens],
            "epoch": torch.tensor(epoch, dtype=torch.int64),
            # env 0's code alone, for post-mortem consumers
            "code_first_rows": torch.tensor(
                np.asarray(vec.envs[0].state.first_rows()),
                dtype=torch.int32),
            "env": _env_checkpoint_state(vec.envs, obs, ep_ret, ep_len),
        }

    if resume:
        if checkpoint_dir is None:
            raise ValueError("resume=True needs a checkpoint_dir")
        from ..utils.checkpoint import restore_checkpoint
        state = restore_checkpoint(checkpoint_dir, template=full_state(0))
        actor.load_state_dict(state["actor"])
        critic.load_state_dict(state["critic"])
        pi_opt.load_state_dict(state["pi_opt"])
        vf_opt.load_state_dict(state["vf_opt"])
        if len(state["rng"]) != num_envs:
            raise ValueError(f"checkpoint has {len(state['rng'])} envs' "
                             f"generators, this run {num_envs} envs")
        for g, s in zip(gens, state["rng"]):
            g.set_state(s)
        obs, ep_ret, ep_len = _restore_env_state(vec.envs, state["env"])
        last = int(state["epoch"])
        start_epoch = last + 1
        logger.log(f"Resumed from epoch {last} in {checkpoint_dir}")
        # A crash BETWEEN checkpoints leaves log rows for epochs newer
        # than the restored state; those epochs re-run now, so drop their
        # rows to keep one row per (epoch, step, env) in the merged logs.
        logger.drop_epochs_after(last)

    # Per-step TSV: the experiment.txt equivalent consumed by post-mortem
    # analysis (postProcessing.py:27-49 reads Reward, Observation,
    # epochNumber, i/j/kAction).  Observations are stored as hex so
    # post-mortem can uncompress the exact visited codes.
    tsv_path = (None if logger.output_dir is None
                else logger.output_dir / "steps.tsv")
    if resume and tsv_path is not None and tsv_path.exists():
        _truncate_steps_tsv(tsv_path, start_epoch - 1)
    tsv = TsvLogger(
        ["epoch", "step", "env", "reward", "value", "logp", "i", "j", "k",
         "observation_hex"],
        path=tsv_path, print_rows=False, append=resume)

    start_time = time.time()

    for epoch in range(start_epoch, ppo_cfg.epochs):
        if epoch_callback is not None:
            epoch_callback(epoch, vec.envs)
        for t in range(ppo_cfg.steps_per_epoch):
            packed = sample_vec(obs)
            ba = packed[:, :adim].astype(np.int64)
            v = packed[:, adim]
            logp = packed[:, adim + 1]
            ent_heads = packed[:, adim + 2:]
            env_actions = [action_to_env_action(ac_cfg, ba[e])
                           for e in range(num_envs)]
            next_obs, rewards, dones, infos = vec.step(env_actions)
            ep_ret += rewards
            ep_len += 1
            for e in range(num_envs):
                bufs[e].store(obs[e], ba[e], rewards[e], float(v[e]),
                              float(logp[e]), float(ent_heads[e].sum()),
                              ent_heads[e])
                logger.store(VVals=float(v[e]), Reward=float(rewards[e]),
                             IEntropy=float(ent_heads[e][0]),
                             JEntropy=float(ent_heads[e][1]),
                             KEntropy=float(ent_heads[e][2]))
                tsv.log(epoch=epoch, step=t, env=e,
                        reward=float(rewards[e]), value=float(v[e]),
                        logp=float(logp[e]), i=int(ba[e][0]),
                        j=int(ba[e][1]), k=int(ba[e][2]),
                        observation_hex=bytes(
                            np.asarray(next_obs[e], np.uint8)).hex())
            obs = next_obs.astype(np.float32)

            timeouts = ep_len == ppo_cfg.max_ep_len
            epoch_ended = t == ppo_cfg.steps_per_epoch - 1
            if dones.any() or timeouts.any() or epoch_ended:
                last_vs = critic_apply(obs)
                for e in range(num_envs):
                    terminal = bool(dones[e]) or bool(timeouts[e])
                    if not (terminal or epoch_ended):
                        continue
                    # bootstrap on truncation, zero on true termination
                    # (openAIppo.py:471-483 semantics)
                    last_v = (float(last_vs[e])
                              if (timeouts[e] or epoch_ended) else 0.0)
                    bufs[e].finish_path(last_v)
                    if terminal:
                        logger.store(EpRet=float(ep_ret[e]),
                                     EpLen=int(ep_len[e]))
                        obs[e] = vec.envs[e].reset().astype(np.float32)
                        ep_ret[e], ep_len[e] = 0.0, 0

        data = bufs.get(stat_fn=stat_fn)
        obs_b, act_b, adv_b, ret_b, logp_b = (
            torch.as_tensor(data[k], device=dev)
            for k in ("obs", "act", "adv", "ret", "logp"))

        stop_iter = ppo_cfg.train_pi_iters
        # defaults cover train_pi_iters=0 / train_v_iters=0 (the loops
        # below then never bind extras / v_l)
        extras = {"loss_pi": np.nan, "kl": 0.0, "clipfrac": np.nan}
        v_l = np.nan
        for i in range(ppo_cfg.train_pi_iters):
            extras = pi_update(actor, pi_opt, obs_b, act_b, adv_b, logp_b)
            kl = float(extras["kl"])
            if kl > 1.5 * ppo_cfg.target_kl:
                logger.log(f"Early stopping at step {i} due to reaching "
                           f"max kl.")
                stop_iter = i
                break
        for _ in range(ppo_cfg.train_v_iters):
            v_l = v_update(critic, vf_opt, obs_b, ret_b)

        if checkpoint_dir is not None and _is_chief() and (
                epoch % ppo_cfg.save_freq == 0 or
                epoch == ppo_cfg.epochs - 1):
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(checkpoint_dir, epoch, full_state(epoch))

        logger.log_tabular("Epoch", epoch)
        logger.log_tabular("EpRet", with_min_and_max=True)
        logger.log_tabular("EpLen", average_only=True)
        logger.log_tabular("VVals", with_min_and_max=True)
        logger.log_tabular("Reward", average_only=True)
        logger.log_tabular("IEntropy", average_only=True)
        logger.log_tabular("JEntropy", average_only=True)
        logger.log_tabular("KEntropy", average_only=True)
        logger.log_tabular("LossPi", float(extras["loss_pi"]))
        logger.log_tabular("LossV", float(v_l))
        logger.log_tabular("KL", float(extras["kl"]))
        logger.log_tabular("ClipFrac", float(extras["clipfrac"]))
        logger.log_tabular("StopIter", stop_iter)
        logger.log_tabular("TotalEnvInteracts",
                           (epoch + 1) * ppo_cfg.steps_per_epoch * num_envs)
        logger.log_tabular("Time", time.time() - start_time)
        logger.dump_tabular()

    return actor, critic, logger
