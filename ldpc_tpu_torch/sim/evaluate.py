"""Monte-Carlo BER/FER evaluation: the port of ``ldpc_tpu.sim.evaluate``.

Two decode engines, named after what they replace:

* ``"torch"``, the counterpart of the JAX package's ``"xla"`` engine: the
  plain-torch flooding decoder of ``ops/decoder.py`` (compute ``dtype``);
* ``"cuda"``, the counterpart of ``"pallas"``: the CUDA kernel of
  ``ops/cuda_static.py`` (state in ``store_dtype``, default bfloat16; the
  ``schedule`` "flooding" or "layered"; ``popcount_sign``; ``dep_stride``,
  which decodes as 0 after the barrier probe).

A staged decode runs a batch with a small iteration budget first; the words
that did not converge are decoded again from scratch with the full budget.
Latching makes each word's (errors, iterations, success) equal to those of
one straight ``max_iters`` decode, while most words pay only the first
budget.  Two JAX constructs have no counterpart in PyTorch and are
replaced:

* ``lax.cond(nfail <= cap, few, many)`` becomes one host-side branch on the
  number of failures (one device-to-host read per stage);
* the fixed-size redo chunk whose padding is scattered to an out-of-range
  index with ``mode="drop"`` becomes a gather of exactly the failed rows
  (ascending index, the order of the JAX stable sort) and a write back of
  only those rows.  A kernel with one block per word needs no tile padding.

"few" and "many" decode the same words the same way, so the branch changes
only the cost, never the result.  ``sort_words`` orders a batch by its
hard-decision error count against the all-zero word (a stable sort, as
JAX's) before the cascade and puts every output back in the caller's
order: with one block per word it changes only the order of work, and
every output is bit-identical.

``staged_decode_counts`` keeps the JAX package's signature for its
host-staged two-phase decode and runs it as the cascade above with one
stage and a redo capacity of B/4 (the whole batch again above 25%
failures).  Its ``pad_to`` fixed the redo chunk's shape for XLA's compiler
and changes nothing here.

``codewords="random"`` (``random_codeword_sweep_step``) transmits
systematically encoded uniform messages (``codes/encode.py``) and counts
errors against the transmitted word on the torch engine, which returns
its hard decisions; it validates the all-zero protocol that every other
path relies on.

``evaluate_code`` keeps the JAX loop over points and batches: batch
``done_words`` of point ``s_idx`` draws its noise from a Philox generator
seeded by ``batch_seed(seed, s_idx, done_words)`` (the JAX package folds the
same two numbers into its key), so a resumed sweep skips exactly the
batches a checkpoint holds.  Philox never draws JAX's bits: the two packages
agree in statistics, not sample for sample.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from ..codes.encode import encoder_for_code
from ..codes.qc import QCCode
from ..ops.cuda_static import make_static_sweep_decoder
from ..ops.decoder import decoder_for_code
from ..utils.device import resolve_device
from .channel import awgn, epsilon_probe, llr_from_channel, modulate, slicer
from .stats import BerStatistics

__all__ = ["ENGINES", "batch_seed", "default_redo_capacity",
           "evaluate_code", "evaluate_epsilon_probe", "sweep_step",
           "random_codeword_sweep_step", "make_staged_decoder_device",
           "make_staged_sweep_device", "staged_decode_counts"]

ENGINES = ("torch", "cuda")


def default_redo_capacity(b: int, engine: str = "cuda") -> int:
    """The JAX cascade's default redo capacity for a batch of ``b`` words
    (its ``round_cap``): B/4, at least 1; the cuda engine rounds it up to
    the 128-word tile the Pallas engine's branches were tuned on (at least
    128); at most B.  The bench protocol passes 3B/16 explicitly."""
    c = max(1, b // 4)
    if engine == "cuda":
        c = max(128, -(-c // 128) * 128)
    return min(c, b)


def _refuse_options(*, engine, store_dtype, schedule, tile_b, dep_stride,
                   popcount_sign):
    """Options that the engine does not take, with the JAX package's
    exception types."""
    if engine not in ENGINES:
        raise ValueError(f"unknown decode engine: {engine}")
    if schedule != "flooding" and engine != "cuda":
        raise ValueError("schedules other than flooding need the cuda "
                         "engine")
    if engine != "cuda" and (dep_stride is not None
                             or popcount_sign is not None):
        raise ValueError("dep_stride/popcount_sign are cuda-kernel "
                         "scheduling levers")
    if tile_b is not None:
        raise ValueError("tile_b is a pallas-engine scheduling lever; the "
                         "port's engines run one word per block")
    if engine == "torch" and store_dtype is not None:
        raise ValueError("store_dtype is a cuda-engine option (the torch "
                         "engine's compute dtype is `dtype`)")


def _engine_counts_fn(code: QCCode, max_iters: int, *, kind: str, dtype,
                      engine: str, store_dtype, schedule: str,
                      popcount_sign, dep_stride, device):
    """``fn(llr[B, n]) -> (errors, iterations, success)`` of one engine."""
    if engine == "torch":
        dec = decoder_for_code(code, max_iters, kind=kind, dtype=dtype)

        def fn(llr):
            res = dec(llr)
            return (res.hard.sum(-1, dtype=torch.int32), res.iterations,
                    res.success)

        return fn
    return make_static_sweep_decoder(
        code, max_iters, kind=kind,
        store_dtype="bfloat16" if store_dtype is None else store_dtype,
        schedule=schedule, popcount_sign=popcount_sign,
        dep_stride=dep_stride, device=device)


class StagedDecoder:
    """``decoder(llr[B, n]) -> (errors, iterations, success)`` of a cascade
    ``phase1_iters`` -> ``max_iters``.  ``last_branches`` records, for the
    last call, each re-decode stage's branch: "few" (only the failures),
    "many" (the whole batch) or "none" (nothing failed).  An empty
    ``phase1_iters`` is one straight ``max_iters`` decode.  ``sort_words``
    runs the cascade in the order of each word's hard-decision error count
    (stable) and returns the outputs in the caller's order."""

    def __init__(self, code: QCCode, max_iters: int = 50, *,
                 phase1_iters: int | Sequence[int] = 12,
                 redo_capacity: int | Sequence[int] | None = None,
                 kind: str = "min-sum", dtype=torch.float32,
                 store_dtype=None, schedule: str = "flooding",
                 engine: str = "torch", tile_b: int | None = None,
                 sort_words: bool = False, dep_stride: int | None = None,
                 popcount_sign: bool | None = None, device=None):
        _refuse_options(engine=engine, store_dtype=store_dtype,
                        schedule=schedule, tile_b=tile_b,
                        dep_stride=dep_stride, popcount_sign=popcount_sign)
        phases = ([int(phase1_iters)] if isinstance(phase1_iters, int)
                  else [int(p) for p in phase1_iters])
        if sorted(phases) != phases or (phases and phases[-1] >= max_iters):
            raise ValueError(f"phase iteration budgets must ascend below "
                             f"max_iters: {phases} vs {max_iters}")
        caps = (list(redo_capacity)
                if isinstance(redo_capacity, (list, tuple))
                else [redo_capacity] * len(phases))
        if len(caps) != len(phases):
            raise ValueError("redo_capacity needs one entry per re-decode "
                             "stage")
        self.caps = caps
        self.engine = engine
        self.sort_words = bool(sort_words)
        self.device = resolve_device(device)
        self.decoders = [_engine_counts_fn(
            code, it, kind=kind, dtype=dtype, engine=engine,
            store_dtype=store_dtype, schedule=schedule,
            popcount_sign=popcount_sign, dep_stride=dep_stride,
            device=self.device)
            for it in phases + [max_iters]]
        self.last_branches: list[str] = []

    def capacities(self, b: int) -> list[int]:
        """Each stage's redo capacity for a batch of ``b`` words: an explicit
        value as given (at most B), else (None or 0, as in the JAX package)
        ``default_redo_capacity(b, engine)``."""
        return [min(int(c), b) if c else
                default_redo_capacity(b, self.engine) for c in self.caps]

    def __call__(self, llr: torch.Tensor):
        if not self.sort_words:
            return self._cascade(llr)
        unc = (llr > 0).sum(1, dtype=torch.int32)
        order = torch.argsort(unc, stable=True)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        out = self._cascade(llr.index_select(0, order))
        return tuple(x.index_select(0, inv) for x in out)

    def _cascade(self, llr: torch.Tensor):
        errors, iters, success = self.decoders[0](llr)
        branches = []
        for decode, cap in zip(self.decoders[1:],
                               self.capacities(llr.shape[0])):
            failed = torch.nonzero(~success).squeeze(1)
            nfail = failed.numel()
            if nfail == 0:
                branches.append("none")
            elif nfail <= cap:
                e2, it2, ok2 = decode(llr.index_select(0, failed))
                errors = errors.index_copy(0, failed, e2)
                iters = iters.index_copy(0, failed, it2)
                success = success.index_copy(0, failed, ok2)
                branches.append("few")
            else:
                e2, it2, ok2 = decode(llr)
                errors = torch.where(success, errors, e2)
                iters = torch.where(success, iters, it2)
                success = success | ok2
                branches.append("many")
        self.last_branches = branches
        return errors, iters, success


def make_staged_decoder_device(code: QCCode, max_iters: int = 50,
                               **staged_kw) -> StagedDecoder:
    """The staged decoder on ``device`` (default: the card); see
    :class:`StagedDecoder` for the keywords (``engine`` defaults to
    "torch", as the JAX package's to "xla")."""
    return StagedDecoder(code, max_iters, **staged_kw)


def staged_decode_counts(code: QCCode, llr: torch.Tensor,
                         max_iters: int = 50, *, phase1_iters: int = 12,
                         pad_to: int = 256, kind: str = "min-sum",
                         dtype=torch.float32, engine: str = "torch",
                         **decoder_kw):
    """Two-phase decode on ``llr``'s device with exactly the semantics of a
    single ``max_iters`` decode: the cascade ``phase1_iters`` ->
    ``max_iters`` of :class:`StagedDecoder`, whose redo capacity B/4 makes
    it decode the whole batch again when more than a quarter of it failed
    phase 1, as the JAX package's does.  ``pad_to`` is accepted for the JAX
    signature: there it fixes the redo chunk's shape so that XLA compiles
    one phase-2 program; a kernel with one block per word needs no chunk,
    so it has no effect.  ``decoder_kw``: the cuda engine's
    ``store_dtype``, ``schedule``, ``popcount_sign``, ``dep_stride``.

    Returns (bit_errors[B] int64, iterations[B], success[B]) as numpy
    arrays.
    """
    opts = dict(store_dtype=None, schedule="flooding", popcount_sign=None,
                dep_stride=None)
    unknown = set(decoder_kw) - set(opts)
    if unknown:
        raise ValueError(f"unsupported decoder options: {sorted(unknown)}")
    opts.update(decoder_kw)
    decoder = StagedDecoder(code, max_iters, phase1_iters=[phase1_iters],
                            redo_capacity=max(1, llr.shape[0] // 4),
                            kind=kind, dtype=dtype, engine=engine,
                            device=llr.device, **opts)
    errors, iters, success = (t.cpu().numpy() for t in decoder(llr))
    return errors.astype(np.int64), iters, success


def transmit(n: int, snr_db: torch.Tensor, *,
             generator: torch.Generator | None = None,
             scale_llr: bool = False):
    """All-zero codeword of length ``n`` per entry of ``snr_db[B]``:
    (llr, sigma, sigma_actual, uncoded bit errors).  The LLRs are the raw
    noisy samples, as min-sum takes them (it is scale-invariant), or with
    ``scale_llr`` the true LLRs 2y/sigma^2 that sum-product needs."""
    clean = torch.full((snr_db.shape[0], n), -1.0, dtype=torch.float32,
                       device=snr_db.device)
    noisy, sigma, sigma_actual = awgn(clean, snr_db, generator=generator)
    llr = llr_from_channel(noisy, sigma) if scale_llr else noisy
    unc = (noisy > 0).sum(-1, dtype=torch.int32)
    return llr, sigma, sigma_actual, unc


class StagedSweep:
    """``step(snr_db[B], generator=None) -> dict`` of one Monte-Carlo
    batch: transmit the all-zero codeword through BPSK + AWGN, staged-decode,
    count.  The keys are those of the JAX step: errors_uncoded,
    errors_decoded, iterations, success, sigma, sigma_actual (each [B], on
    the device).  Noise comes from ``generator``, else the one given when
    the step was built."""

    def __init__(self, code: QCCode, max_iters: int = 50, *,
                 scale_llr: bool = False, device=None,
                 generator: torch.Generator | None = None, **staged_kw):
        self.decoder = StagedDecoder(code, max_iters, device=device,
                                     **staged_kw)
        self.n = code.n
        self.scale_llr = scale_llr
        self.generator = generator

    def __call__(self, snr_db, generator: torch.Generator | None = None
                 ) -> dict:
        snr_db = torch.as_tensor(snr_db, dtype=torch.float32,
                                 device=self.decoder.device)
        llr, sigma, sigma_actual, unc = transmit(
            self.n, snr_db,
            generator=self.generator if generator is None else generator,
            scale_llr=self.scale_llr)
        errors, iters, success = self.decoder(llr)
        return {
            "errors_uncoded": unc,
            "errors_decoded": errors,
            "iterations": iters,
            "success": success,
            "sigma": sigma,
            "sigma_actual": sigma_actual,
        }


def make_staged_sweep_device(code: QCCode, max_iters: int = 50, *,
                             scale_llr: bool = False, device=None,
                             generator: torch.Generator | None = None,
                             **staged_kw) -> StagedSweep:
    """Transmit + staged decode on ``device`` (default: the card), noise
    from ``generator``; see :class:`StagedSweep`.  Accepts every
    :class:`StagedDecoder` keyword."""
    return StagedSweep(code, max_iters, scale_llr=scale_llr, device=device,
                       generator=generator, **staged_kw)


def sweep_step(code: QCCode, max_iters: int = 50, *, kind: str = "min-sum",
               scale_llr: bool = False, dtype=torch.float32, device=None,
               generator: torch.Generator | None = None) -> StagedSweep:
    """The unstaged Monte-Carlo step of the torch engine:
    ``step(snr_db[B], generator=None) -> dict`` with the keys of
    :class:`StagedSweep`."""
    return StagedSweep(code, max_iters, scale_llr=scale_llr, device=device,
                       generator=generator, phase1_iters=[], kind=kind,
                       dtype=dtype, engine="torch")


class RandomCodewordSweep:
    """``step(snr_db[B], generator=None) -> dict`` of one Monte-Carlo batch
    of random codewords: uniform messages and then the noise, both from
    ``generator`` (else the one given when the step was built), a
    systematic encode, BPSK + AWGN, a torch-engine decode, and the bit
    errors counted against the transmitted word.  The keys are those of
    :class:`StagedSweep`."""

    def __init__(self, code: QCCode, max_iters: int = 50, *,
                 kind: str = "min-sum", scale_llr: bool = False,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        self.encoder = encoder_for_code(code)
        self.decoder = decoder_for_code(code, max_iters, kind=kind,
                                        dtype=dtype)
        self.scale_llr = scale_llr
        self.device = resolve_device(device)
        self.generator = generator

    def __call__(self, snr_db, generator: torch.Generator | None = None
                 ) -> dict:
        snr_db = torch.as_tensor(snr_db, dtype=torch.float32,
                                 device=self.device)
        gen = self.generator if generator is None else generator
        msgs = torch.randint(0, 2, (snr_db.shape[0], self.encoder.k_eff),
                             generator=gen, dtype=torch.int8,
                             device=self.device)
        cw = self.encoder(msgs)
        noisy, sigma, sigma_actual = awgn(modulate(cw), snr_db,
                                          generator=gen)
        llr = llr_from_channel(noisy, sigma) if self.scale_llr else noisy
        res = self.decoder(llr)
        return {
            "errors_uncoded": (slicer(noisy) != cw).sum(-1,
                                                        dtype=torch.int32),
            "errors_decoded": (res.hard != cw).sum(-1, dtype=torch.int32),
            "iterations": res.iterations,
            "success": res.success,
            "sigma": sigma,
            "sigma_actual": sigma_actual,
        }


def random_codeword_sweep_step(code: QCCode, max_iters: int = 50, *,
                               kind: str = "min-sum",
                               scale_llr: bool = False, dtype=torch.float32,
                               device=None,
                               generator: torch.Generator | None = None
                               ) -> RandomCodewordSweep:
    """Monte-Carlo step transmitting RANDOM codewords (not all-zero): the
    reference's G-based path (ldpc.py:409-416) on the torch engine, whose
    hard decisions the errors are counted from; see
    :class:`RandomCodewordSweep`.  Validates the all-zero protocol
    (linearity, channel and decoder symmetry) end to end."""
    return RandomCodewordSweep(code, max_iters, kind=kind,
                               scale_llr=scale_llr, dtype=dtype,
                               device=device, generator=generator)


def batch_seed(seed: int, s_idx: int, done_words: int) -> int:
    """Philox seed of batch ``done_words`` of point ``s_idx``: the JAX
    loop's ``fold_in(fold_in(key(seed), s_idx), done_words)``, as a numpy
    SeedSequence of the same three numbers."""
    return int(np.random.SeedSequence([seed, s_idx, done_words])
               .generate_state(1, np.uint64)[0])


def evaluate_code(code: QCCode,
                  snr_points: Sequence[float],
                  num_transmissions: int,
                  max_iters: int = 50,
                  *,
                  seed: int = 7134066,
                  batch_size: int = 256,
                  kind: str = "min-sum",
                  scale_llr: bool = False,
                  dtype=torch.float32,
                  staged: bool = False,
                  phase1_iters: int | Sequence[int] = 12,
                  engine: str = "torch",
                  store_dtype=None,
                  schedule: str = "flooding",
                  tile_b: int | None = None,
                  sort_words: bool = False,
                  popcount_sign: bool | None = None,
                  codewords: str = "zero",
                  early_abort_ber: float | None = None,
                  stats: BerStatistics | None = None,
                  checkpoint_path=None,
                  verbose: bool = False,
                  device=None) -> BerStatistics:
    """Run a full SNR sweep; returns mergeable BerStatistics.

    ``early_abort_ber``: stop the sweep if a finished SNR point's BER
    exceeds this reference value (ldpc.py:473-475).

    ``staged=True`` decodes each batch in phases (``phase1_iters`` ->
    ``max_iters``), with the same statistics as a straight decode.
    ``engine`` is "torch" (the XLA engine's counterpart) or "cuda" (the
    kernel; ``store_dtype`` bfloat16, float32 or int8, ``schedule``
    "flooding" or "layered", ``popcount_sign``).

    ``codewords``: "zero" (the reference's all-zero Monte-Carlo path,
    ldpc.py:409-411) or "random": uniform messages, systematically encoded,
    errors counted against the transmitted word (the torch engine,
    unstaged, without ``sort_words``; see
    :func:`random_codeword_sweep_step`).

    ``checkpoint_path``: save the accumulated statistics after every SNR
    point and, on restart, resume by skipping points already completed
    with at least ``num_transmissions`` words, and the batches already
    recorded of a point begun.
    """
    dev = resolve_device(device)
    if codewords == "random":
        if tile_b is not None:
            raise ValueError("tile_b is a pallas-engine scheduling lever; "
                             "the port's engines run one word per block")
        if staged or engine != "torch" or sort_words:
            raise ValueError(
                "codewords='random' uses the torch engine unstaged, without "
                "sort_words (the kernel counts errors against the all-zero "
                "word on the card; this path encodes random messages to "
                "validate that protocol)")
        step = random_codeword_sweep_step(
            code, max_iters, kind=kind, scale_llr=scale_llr, dtype=dtype,
            device=dev)
    elif codewords != "zero":
        raise ValueError(f"unknown codewords mode: {codewords!r}")
    else:
        step = make_staged_sweep_device(
            code, max_iters, scale_llr=scale_llr, device=dev,
            phase1_iters=phase1_iters if staged else [], kind=kind,
            dtype=dtype, engine=engine, store_dtype=store_dtype,
            schedule=schedule, tile_b=tile_b, sort_words=sort_words,
            popcount_sign=popcount_sign)
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
        # Resume mid-point without double counting: the checkpointed
        # batches used seeds batch_seed(.., 0..already-1), so starting
        # done_words there continues with fresh draws; the running error
        # count starts from the checkpointed entries.
        done_words = already
        point_errs = int(stats.column("errors_decoded")[
            stats.column("snr") == snr].sum()) if already else 0
        while done_words < num_transmissions:
            b = min(batch_size, num_transmissions - done_words)
            gen = torch.Generator(device=dev).manual_seed(
                batch_seed(seed, s_idx, done_words))
            out = step(torch.full((b,), snr, dtype=torch.float32,
                                  device=dev), generator=gen)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            stats.add_batch(
                snr=np.full(b, snr), sigma=out["sigma"],
                sigma_actual=out["sigma_actual"],
                errors_uncoded=out["errors_uncoded"],
                errors_decoded=out["errors_decoded"],
                iterations=out["iterations"], max_iterations=max_iters,
                success=out["success"])
            point_errs += int(out["errors_decoded"].sum())
            done_words += b
        if verbose:
            dt = time.time() - t0
            bits = num_transmissions * code.n
            print(f"[evaluate] snr {snr}: {dt:.3f}s, "
                  f"{bits / dt:,.0f} bit/s decoded, "
                  f"BER {point_errs / bits:.3e}")
        if checkpoint_path is not None:
            stats.save(checkpoint_path)
        if early_abort_ber is not None:
            ber = point_errs / (num_transmissions * code.n)
            if ber > early_abort_ber:
                break
    return stats


def evaluate_epsilon_probe(code: QCCode, epsilon: float = 1e-2,
                           flips: Sequence[int] = (0,),
                           max_iters: int = 50, return_time: bool = False,
                           device=None, **decoder_kw):
    """Deterministic single-vector probe (ldpcCUDA.py:677-828 equivalent)
    on the torch engine.

    Decodes ``modulate(zeros) + epsilon`` with the given hard sign flips;
    no PRNG involved.  Returns (errors_uncoded, errors_decoded,
    iterations, success), plus the decode wall time in seconds when
    ``return_time=True``.
    """
    probe = epsilon_probe(code.n, flips=flips, epsilon=epsilon,
                          device=device)
    dec = decoder_for_code(code, max_iters, **decoder_kw)
    t0 = time.time()
    res = dec(probe)
    hard = res.hard.cpu()          # the completion barrier
    wall = time.time() - t0
    out = (int((probe > 0).sum()), int(hard.sum()),
           int(res.iterations[0]), bool(res.success[0]))
    return out + (wall,) if return_time else out
