"""Sharded Monte-Carlo evaluation: the port of
``ldpc_tpu.parallel.evaluate``.

Replaces the reference's multi-GPU fan-out (``evaluateCodeCudaWrapper``,
``ldpcCUDA.py:891-932``: one OS process per CUDA device, transmissions
split ``T // n_devices``, results merged by unpickling ``berStatistics``
objects) with a ``torch.distributed`` mesh (``parallel/mesh.py``): each
rank decodes its contiguous rows of the global batch (dcn-major on a 2-D
mesh) with the port's engines, the fused kernel on the card with
``engine="cuda"``, and the decode counters are summed with one
``all_reduce`` a batch, in int64.

Sharding is transparent: the counters are equal at every world size, and
equal to ``sim.evaluate_code`` with the same seed and batching.  The noise
makes that so.  Philox cannot draw a slice of a batch's rows, and a
generator seeded per rank would draw other words at every world size, so
EVERY rank draws the whole global batch from the generator seeded
``batch_seed(seed, s_idx, done)``, exactly as ``evaluate_code`` does, and
keeps its own rows.  At world size w the channel is computed w times (on
one card, about 5.6 ms a 32,768-word near-earth batch); since every rank
holds the whole channel, the mean realized sigma is read from it on each
rank; the other counters are summed over the ranks' rows.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..codes.qc import QCCode
from ..sim.channel import snr_db_to_sigma
from ..sim.evaluate import StagedDecoder, batch_seed, transmit
from ..sim.stats import BerStatistics
from .mesh import all_reduce_sum, make_mesh, mesh_position, mesh_rows

__all__ = ["sharded_sweep_step", "sharded_staged_sweep_step",
           "evaluate_code_sharded"]


class ShardedSweep:
    """``step(snr_db[B], generator=None) -> dict`` of one Monte-Carlo batch
    over a mesh: the global batch's channel from ``generator``, this rank's
    rows decoded by ``decoder``, the counters summed over the mesh.  The
    keys are the JAX step's: frames, errors_uncoded, errors_decoded,
    iterations_sum, success_count, frame_errors (ints, equal on every
    rank) and sigma_actual_mean."""

    def __init__(self, code: QCCode, mesh: DeviceMesh,
                 decoder: StagedDecoder, scale_llr: bool):
        self.n = code.n
        self.mesh = mesh
        self.decoder = decoder
        self.scale_llr = scale_llr
        self.world = mesh_position(mesh)[1]

    def __call__(self, snr_db, generator: torch.Generator | None = None
                 ) -> dict:
        dev = self.decoder.device
        snr_db = torch.as_tensor(snr_db, dtype=torch.float32, device=dev)
        b = snr_db.shape[0]
        if b % self.world:
            raise ValueError(f"batch {b} must divide over {self.world} "
                             f"ranks")
        rows = mesh_rows(self.mesh, b)
        llr, _, sigma_actual, unc = transmit(
            self.n, snr_db, generator=generator, scale_llr=self.scale_llr)
        errors, iters, success = self.decoder(llr[rows])
        frame_err = (errors > 0) | ~success
        counts = torch.stack([
            x.sum(dtype=torch.int64) for x in (
                errors, iters, success, frame_err, unc[rows])])
        all_reduce_sum(counts, self.mesh)
        # one host read; the counts are exact in float64 below 2**53
        host = torch.cat([counts.to(torch.float64), sigma_actual.mean(
            dtype=torch.float64)[None]]).tolist()
        return {"frames": b, "errors_uncoded": int(host[4]),
                "errors_decoded": int(host[0]),
                "iterations_sum": int(host[1]),
                "success_count": int(host[2]),
                "frame_errors": int(host[3]), "sigma_actual_mean": host[5]}


def sharded_sweep_step(code: QCCode, mesh: DeviceMesh, max_iters: int = 50,
                       *, kind: str = "min-sum", scale_llr: bool = False,
                       dtype=torch.float32, engine: str = "torch",
                       pallas_tile_b: int | None = None,
                       schedule: str = "flooding", store_dtype=None,
                       popcount_sign: bool | None = None,
                       device=None) -> ShardedSweep:
    """One straight ``max_iters`` decode a batch, the batch axis sharded
    over ``mesh``; see :class:`ShardedSweep`.  ``engine="cuda"`` decodes
    each rank's rows on the fused kernel (``store_dtype`` default
    bfloat16, ``popcount_sign``); ``schedule`` other than flooding needs
    it, and ``pallas_tile_b`` is refused, as by ``evaluate_code``.
    ``device``: where this rank draws and decodes (default: the card)."""
    dec = StagedDecoder(code, max_iters, phase1_iters=[], kind=kind,
                        dtype=dtype, engine=engine, store_dtype=store_dtype,
                        schedule=schedule, tile_b=pallas_tile_b,
                        popcount_sign=popcount_sign, device=device)
    return ShardedSweep(code, mesh, dec, scale_llr)


def sharded_staged_sweep_step(code: QCCode, mesh: DeviceMesh,
                              max_iters: int = 50, *,
                              phase1_iters=12, redo_capacity=None,
                              kind: str = "min-sum",
                              scale_llr: bool = False,
                              dtype=torch.float32, store_dtype=None,
                              tile_b: int | None = None,
                              schedule: str = "flooding",
                              engine: str = "torch",
                              sort_words: bool = False,
                              popcount_sign: bool | None = None,
                              device=None) -> ShardedSweep:
    """The sharded step with the staged cascade (``phase1_iters`` ->
    ``max_iters``) on each rank's rows: latching makes every cascade equal
    to a straight ``max_iters`` decode, so the counters equal
    ``evaluate_code(staged=True)``'s with matched batching.
    ``redo_capacity`` is a rank's (default: ``default_redo_capacity`` of
    its rows); the other keywords are :class:`~ldpc_tpu_torch.sim.evaluate.
    StagedDecoder`'s."""
    dec = StagedDecoder(code, max_iters, phase1_iters=phase1_iters,
                        redo_capacity=redo_capacity, kind=kind, dtype=dtype,
                        store_dtype=store_dtype, schedule=schedule,
                        engine=engine, tile_b=tile_b, sort_words=sort_words,
                        popcount_sign=popcount_sign, device=device)
    return ShardedSweep(code, mesh, dec, scale_llr)


def _save(stats: BerStatistics, path) -> None:
    """Every rank holds the same statistics and saves them; a write to a
    temporary file moved into place keeps a rank that loads the
    checkpoint from reading another's half-written file."""
    target = str(path) if str(path).endswith(".npz") else f"{path}.npz"
    tmp = f"{target}.{os.getpid()}.tmp.npz"
    stats.save(tmp)
    os.replace(tmp, target)


def evaluate_code_sharded(code: QCCode,
                          snr_points: Sequence[float],
                          num_transmissions: int,
                          max_iters: int = 50,
                          *,
                          mesh: DeviceMesh | None = None,
                          seed: int = 7134066,
                          batch_size: int | None = None,
                          kind: str = "min-sum",
                          scale_llr: bool = False,
                          dtype=torch.float32,
                          engine: str = "torch",
                          pallas_tile_b: int | None = None,
                          staged: bool = False,
                          phase1_iters=12,
                          redo_capacity=None,
                          store_dtype=None,
                          schedule: str = "flooding",
                          sort_words: bool = False,
                          popcount_sign: bool | None = None,
                          early_abort_ber: float | None = None,
                          checkpoint_path=None,
                          stats: BerStatistics | None = None,
                          verbose: bool = False,
                          device=None) -> BerStatistics:
    """Full sweep over a mesh of ranks; returns weighted BerStatistics,
    equal on every rank.  Every rank of ``mesh`` calls it with the same
    arguments.

    ``num_transmissions`` is the GLOBAL count per SNR point (like the
    reference wrapper's total split across GPUs, ldpcCUDA.py:898-900).
    ``batch_size`` is the global batch a step (default: 256 a rank),
    rounded down to a multiple of the rank count, and each step's batch is
    rounded up to one.  ``mesh`` defaults to ``make_mesh(device=device)``:
    every rank of the group, or a one-rank group.

    As ``sim.evaluate_code``:

    * ``staged=True`` runs the staged cascade on each rank's rows
      (:func:`sharded_staged_sweep_step`): identical statistics;
      ``phase1_iters``/``redo_capacity`` configure it, ``engine="cuda"``
      with ``store_dtype``/``schedule``/``popcount_sign`` the fused
      kernel; ``sort_words`` needs ``staged=True``;
    * ``checkpoint_path`` saves the statistics after every SNR point and
      resumes past completed points on restart;
    * ``early_abort_ber`` stops the sweep once a finished point's BER
      exceeds the reference value (ldpc.py:473-475 semantics).
    """
    mesh = mesh if mesh is not None else make_mesh(device=device)
    rank, ndev = mesh_position(mesh)
    if batch_size is None:
        batch_size = 256 * ndev
    batch_size = max(ndev, (batch_size // ndev) * ndev)
    if staged:
        step = sharded_staged_sweep_step(
            code, mesh, max_iters, phase1_iters=phase1_iters,
            redo_capacity=redo_capacity, kind=kind, scale_llr=scale_llr,
            dtype=dtype, store_dtype=store_dtype, schedule=schedule,
            tile_b=pallas_tile_b, engine=engine, sort_words=sort_words,
            popcount_sign=popcount_sign, device=device)
    else:
        if sort_words:
            raise ValueError("sort_words on the sharded path needs "
                             "staged=True (the per-shard cascade is where "
                             "the sort lives)")
        step = sharded_sweep_step(
            code, mesh, max_iters, kind=kind, scale_llr=scale_llr,
            dtype=dtype, engine=engine, schedule=schedule,
            pallas_tile_b=pallas_tile_b, store_dtype=store_dtype,
            popcount_sign=popcount_sign, device=device)
    dev = step.decoder.device
    if stats is None:
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            stats = BerStatistics.load(checkpoint_path)
        else:
            stats = BerStatistics(code.n)
    for s_idx, snr in enumerate(snr_points):
        already = int(stats.column("weight")[
            stats.column("snr") == snr].sum()) if len(stats) else 0
        if already >= num_transmissions:
            continue  # resumed past this point
        t0 = time.time()
        done = already
        point_errs = int(stats.column("errors_decoded")[
            stats.column("snr") == snr].sum()) if already else 0
        point_words = already
        while done < num_transmissions:
            b = min(batch_size, num_transmissions - done)
            b = max(ndev, (b + ndev - 1) // ndev * ndev)
            gen = torch.Generator(device=dev).manual_seed(
                batch_seed(seed, s_idx, done))
            out = step(torch.full((b,), snr, dtype=torch.float32,
                                  device=dev), generator=gen)
            stats.add_aggregate(
                snr=snr, sigma=float(snr_db_to_sigma(snr, device="cpu")),
                sigma_actual_mean=out["sigma_actual_mean"],
                errors_uncoded=out["errors_uncoded"],
                errors_decoded=out["errors_decoded"],
                iterations_sum=out["iterations_sum"],
                max_iterations=max_iters,
                success_count=out["success_count"],
                frame_errors=out["frame_errors"],
                weight=out["frames"])
            point_errs += out["errors_decoded"]
            point_words += b
            done += b
        if verbose and rank == 0:
            dt = time.time() - t0
            print(f"[sharded] snr {snr}: {dt:.3f}s over {ndev} ranks, "
                  f"{(done - already) * code.n / dt:,.0f} bit/s decoded")
        if checkpoint_path is not None:
            _save(stats, checkpoint_path)
        if early_abort_ber is not None:
            ber = point_errs / (point_words * code.n)
            if ber > early_abort_ber:
                break
    return stats
