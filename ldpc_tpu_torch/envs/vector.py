"""Vectorized environments (reference ``envContainer.py``; the port of
``ldpc_tpu.envs.vector``).

The reference pins one env per CUDA device and steps them through a
``ProcessPoolExecutor`` (envContainer.py:10-57).  Here a vector step can
run every legal candidate with no host read between them
(``batched=True``): on the card each candidate's decode is one launch of
the fused kernel, back to back on one stream, and the results of all come
back in one host read at the end; on the CPU the candidates are one call
of ``ops.dynamic.make_multi_dynamic_decoder`` (the candidate axis a tensor
axis).  Per-env DECODE results (rewards, statistics, iteration counts,
state transitions) are identical to sequential stepping: each env draws
from its own RandomState, and a word's decode does not depend on the
others.  Episode termination is identical too under the default iteration
budget; under a WALL-CLOCK budget it is only approximate — the fused
step's wall time is apportioned by per-candidate iteration share, a
deterministic cost model, but not the sequential timings themselves.

With a ``mesh`` (``parallel.make_mesh``: every rank of a
``torch.distributed`` group holds the same envs and steps them with the
same actions) a fused step shards its candidates over the ranks: when the
live candidates divide over them, each rank decodes only its contiguous
share, and one ``all_reduce`` of zero-filled [N, B] counts gives every
rank every candidate's results.  Every rank still draws every live
candidate's channel, so each env's RandomState stays equal on all ranks,
and the rewards, statistics and states equal the unsharded step's.
``batched=None`` (the default) fuses when a mesh is given and the envs
can batch, as the JAX package does, and steps sequentially otherwise.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from .code_search import DecodeCounts, LdpcCodeSearchEnv, _to_host

__all__ = ["EnvironmentVector"]


class EnvironmentVector:
    """N independent envs with batched step/reset (envContainer semantics).

    ``step`` takes one action per env and returns stacked observations,
    rewards, dones and an info list — the interface of
    ``multiDeviceEnvironment.step`` (envContainer.py:38-56).

    ``batched=True`` fuses the vector step (the envs must share a decode
    shape family and the dynamic backend), ``False`` steps sequentially,
    ``None`` fuses when a ``mesh`` is given and the envs can batch.
    ``mesh`` shards the candidates of a fused step over its ranks
    (len(envs) should be a multiple of the rank count).  ``env_kwargs``
    (with an int ``env_fns``) go to every ``LdpcCodeSearchEnv``,
    ``device`` included.
    """

    def __init__(self, env_fns: Sequence[Callable[[], LdpcCodeSearchEnv]]
                 | int = 1, batched: bool | None = None, mesh=None,
                 **env_kwargs):
        if isinstance(env_fns, int):
            self.envs = [LdpcCodeSearchEnv(**env_kwargs)
                         for _ in range(env_fns)]
        else:
            self.envs = [fn() for fn in env_fns]
        self.batched = batched
        self.mesh = mesh
        if batched and not self._can_batch():
            raise ValueError("batched=True but envs do not share a decode "
                             "shape family / dynamic backend / device")

    def __len__(self):
        return len(self.envs)

    @property
    def action_space(self):
        return self.envs[0].action_space

    @property
    def observation_space(self):
        return self.envs[0].observation_space

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def _can_batch(self) -> bool:
        keys = {(e.decoder_backend, e.state.z, e.state.block_rows,
                 e.state.block_cols, e.dmax_cn_cap, e.dmax_vn_cap,
                 e.num_iterations, e.decoder_kind, e.state.n,
                 tuple(e.snr_points), e.num_transmissions,
                 # fused stepping decodes at the full budget (identical
                 # results; the host-staged phase1_iterations applies to
                 # the sequential path only)
                 e.phase1_iterations, e.device)
                for e in self.envs}
        return (len(keys) == 1 and len(self.envs) > 1
                and self.envs[0].decoder_backend == "dynamic")

    def step(self, actions):
        batched = self.batched if self.batched is not None else (
            self.mesh is not None and self._can_batch())
        results = (self._step_batched(actions) if batched else
                   [e.step(a) for e, a in zip(self.envs, actions)])
        obs = np.stack([r[0] for r in results])
        rewards = np.array([r[1] for r in results], np.float64)
        dones = np.array([r[2] for r in results], bool)
        infos = [r[3] for r in results]
        return obs, rewards, dones, infos

    def _live_decoder(self, live):
        """``decode(llrs) -> DecodeCounts`` [N, B] of the live candidates'
        codes, everything a code needs built now: ``decode`` makes no host
        read and, on the card, launches the kernel once a candidate, back
        to back."""
        e0 = self.envs[live[0]]
        if e0.device.type == "cuda":
            fns = [self.envs[i].counts_fn(self.envs[i].state,
                                          e0.num_iterations) for i in live]

            def decode(llrs):
                res = [fn(llr) for fn, llr in zip(fns, llrs)]
                return DecodeCounts(*(torch.stack(x) for x in zip(
                    *((r.errors, r.iterations, r.success) for r in res))))

            return decode
        from ..ops.dynamic import (dynamic_plan, make_multi_dynamic_decoder,
                                   stack_plans)
        plans = stack_plans([
            dynamic_plan(self.envs[i].state, e0.dmax_cn_cap,
                         e0.dmax_vn_cap, device=e0.device) for i in live])
        dec = make_multi_dynamic_decoder(
            e0.z, e0.state.block_rows, e0.state.block_cols,
            e0.dmax_cn_cap, e0.dmax_vn_cap, e0.num_iterations,
            kind=e0.decoder_kind)

        def decode(llrs):
            res = dec(plans, torch.stack(llrs))
            return DecodeCounts(res.hard.sum(-1, dtype=torch.int32),
                                res.iterations, res.success)

        return decode

    def _decode_live(self, live, llrs) -> DecodeCounts:
        """[N, B] counts of the live candidates: all of them here, or with
        a mesh over which they divide, this rank's contiguous share,
        zero-filled and summed over the ranks in one ``all_reduce``."""
        if self.mesh is None:
            return self._live_decoder(live)(llrs)
        from ..parallel.mesh import all_reduce_sum, mesh_position, mesh_rows
        if len(live) % mesh_position(self.mesh)[1]:
            return self._live_decoder(live)(llrs)
        rows = mesh_rows(self.mesh, len(live))
        part = self._live_decoder(live[rows])(llrs[rows])
        counts = torch.zeros(3, len(live), llrs[0].shape[0],
                             dtype=torch.int64, device=llrs[0].device)
        counts[:, rows] = torch.stack(
            [x.to(torch.int64) for x in (part.errors, part.iterations,
                                         part.success)])
        all_reduce_sum(counts, self.mesh)
        return DecodeCounts(counts[0].to(part.errors.dtype),
                            counts[1].to(part.iterations.dtype),
                            counts[2].to(torch.bool))

    def _step_batched(self, actions):
        """All legal candidates of one vector step, one host read."""
        prep = [e._prepare_step(a) for e, a in zip(self.envs, actions)]
        live = [i for i, (legal, _) in enumerate(prep) if legal]
        stats = [None] * len(self.envs)
        if live:
            t0 = time.perf_counter()
            for i in live:
                self.envs[i].state = prep[i][1]
            trans = [self.envs[i]._transmit() for i in live]
            res = self._decode_live(live, [tr[1] for tr in trans])
            cols = LdpcCodeSearchEnv._device_columns(
                torch.stack([tr[1] for tr in trans]),
                torch.stack([tr[2] for tr in trans]),
                torch.stack([tr[3] for tr in trans]), res)
            host = _to_host(cols)
            wall = time.perf_counter() - t0
            # Apportion the fused step's wall time by each candidate's
            # decode-iteration share — a deterministic cost model, so
            # time-budget-driven episode termination matches sequential
            # stepping far more closely than an even wall/len(live) split.
            # Iteration budgets (the primary, reproducible terminator) are
            # charged from the exact per-candidate counts either way.
            it_sums = host["iterations"].astype(np.float64).sum(axis=1)
            shares = (it_sums / it_sums.sum() if it_sums.sum() > 0
                      else np.full(len(live), 1.0 / len(live)))
            for j, i in enumerate(live):
                host_i = {k: v[j] for k, v in host.items()}
                stats[i] = self.envs[i]._stats_from_host(trans[j][0],
                                                         host_i)
                self.envs[i]._charge(wall * float(shares[j]),
                                     host_i["iterations"])
        return [e._finish_step(prep[i][0], stats[i])
                for i, e in enumerate(self.envs)]

    def seed(self, seeds=None):
        if seeds is None:
            seeds = range(len(self.envs))
        for e, s in zip(self.envs, seeds):
            e.seed(int(s))
