"""The phase-split decoder: two CUDA kernels an iteration, with the
compressed check state in device memory between them.

Port of ``ldpc_tpu.ops.pallas_split``.  ``make_split_sweep_decoder(code,
max_iters, ...)`` returns ``decode_counts(llr[B, n]) -> (errors[B],
iterations[B], success[B])``, the contract of
``ops/cuda_static.make_static_sweep_decoder`` (check BEFORE update), for
min-sum flooding with bfloat16 or float32 state.

On a CUDA tensor the decoder allocates every word's state once, then runs
``split_r`` (phase A and the latches) for ``it = 0..max_iters`` and
``split_c`` (phase B, the totals) after each but the last, from
``csrc/split.cu`` (see the note at its head); it stops once every word has
converged, which it learns from one host read of a count of latched words
an iteration.  The latches freeze a converged word, so the outputs do not
depend on where the loop stops.  The state lives in device memory, not in
a block's shared memory, so this decoder takes codes whose state the fused
kernel (``csrc/decode.cu``) refuses, such as
``codes.synthetic_qc_code(2048, 8, 24)``.

On a CPU tensor it runs ``split_reference``.  ``split_r_reference`` and
``split_c_reference`` are the plain versions of one launch of each kernel,
on the kernels' own state (:class:`SplitState`, one 16-byte record a
check); ``split_tables`` are the kernels' packed edge tables.

Word for word it equals the fused kernel's min-sum flooding decode at the
same store, non-converged words included, for finite LLRs: the fused
kernel sanitises non-finite ones (NaN -> 0, +-inf -> +-1e30) and this
decoder, as the Pallas pair, does not.

``launches`` counts kernel launches per ``(kernel, store)``, kernel
``"split_r"`` or ``"split_c"``; a run clears it and reads it to show which
work went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.device import resolve_device
from .cuda_static import (_ARGMIN_LIMIT, STORES, _ld, _minsum_phase_a,
                          _minsum_phase_b, _MinSumState, _RefTables,
                          _reference, _reference_chunk, _sign_words, _st,
                          _store_name)
from .plan import DecodePlan

__all__ = ["SplitState", "make_split_sweep_decoder", "split_reference",
           "split_r_reference", "split_c_reference", "split_tables",
           "state_bytes", "least_bytes", "launch"]

launches: collections.Counter = collections.Counter()

_FLOAT_STORES = ("bfloat16", "float32")


_RECORD = 16     # bytes of a check's record
_SIGN_BIT = -(1 << 31)   # bit 31 of an int32


@dataclasses.dataclass
class SplitState:
    """The kernels' state of a batch of ``B`` words, word-major: ``chan``
    and ``tot`` [B, n] in the store; ``rec`` [B, m, 4] int32, one record a
    check: sign word 0 (bit d of slot d), m1 and m2 as the float32 bits of
    the store's values with bit 31 set where the sign product is -1, the
    argmin slot; ``xbits`` [B, m, ceil(dc/32) - 1] int32, the sign words
    past the first; the latches ``errors``, ``iters`` and ``success`` [B]
    int32."""

    chan: torch.Tensor
    tot: torch.Tensor
    rec: torch.Tensor
    xbits: torch.Tensor
    errors: torch.Tensor
    iters: torch.Tensor
    success: torch.Tensor

    @classmethod
    def start(cls, llr: torch.Tensor, plan: DecodePlan, max_iters: int,
              store: str) -> "SplitState":
        """The state before iteration 0, on ``llr``'s device: the channel
        rounded to the store, totals = -chan, a zero c2v rebuild (m1 = m2 =
        0, argmin 0, sign product 1, no sign bits: all-zero records),
        iterations ``max_iters``, nothing latched, no errors counted yet
        (split_r counts iteration 0's)."""
        sd, dev, b = STORES[store], llr.device, llr.shape[0]
        chan = _st(llr, sd)
        i32 = dict(dtype=torch.int32, device=dev)
        # -chan in the store is exact: one pass, no widening
        return cls(chan=chan, tot=-chan,
                   rec=torch.zeros(b, plan.m, 4, **i32),
                   xbits=torch.zeros(b, plan.m, _sign_words(plan) - 1, **i32),
                   errors=torch.zeros(b, **i32),
                   iters=torch.full((b,), max_iters, **i32),
                   success=torch.zeros(b, **i32))


def split_tables(plan: DecodePlan, store: str = "bfloat16") -> np.ndarray:
    """The kernels' int32 edge tables (the note in ``csrc/split.cu``):
    ``ctab`` [nb, dv, 4] (per column slot: the byte offset of the record
    of check ``mb*z - s``, the wrap threshold ``s*16``, the row slot ``d``
    and ``31 - d % 32``), ``rtab`` [mb, dc, 2] (per row slot: the byte
    offset of the total of variable ``nb*z + s`` and the wrap threshold
    ``(z - s) * itemsize``), then the row and column degrees."""
    z, dc = plan.z, plan.dmax_cn
    width = STORES[_store_name(store)].itemsize
    col_mb, col_d = plan.vn_slot // dc, plan.vn_slot % dc
    s_c = plan.vn_shift % z
    ctab = np.stack([(col_mb * z - s_c) * _RECORD, s_c * _RECORD, col_d,
                     31 - col_d % 32], -1)
    s_r = plan.cn_shift % z
    rtab = np.stack([(plan.cn_nb * z + s_r) * width, (z - s_r) * width], -1)
    parts = [ctab, rtab, plan.cn_valid.sum(axis=1), plan.vn_valid.sum(axis=1)]
    return np.concatenate([np.asarray(p, np.int64).ravel() for p in parts]
                          ).astype(np.int32)


def state_bytes(plan: DecodePlan, store: str = "bfloat16") -> dict:
    """Device bytes a word: the whole state (``word``), and what a launch
    of each kernel moves for a live word, each input read once and each
    output written once: ``split_r`` reads the totals and the old records
    and writes the new records and the latches, ``split_c`` reads the
    channel and the records and writes the totals and the error count."""
    width = STORES[_store_name(store)].itemsize
    frame = plan.n * width
    state = _RECORD * plan.m + 4 * plan.m * (_sign_words(plan) - 1)
    latches = 3 * 4
    return {"word": 2 * frame + state + latches,
            "split_r": frame + 2 * state + latches,
            "split_c": 2 * frame + state + 4}


def least_bytes(plan: DecodePlan, store: str = "bfloat16") -> dict:
    """The least device bytes of the same work, whatever the layout:
    ``state``, a word's check state packed to the bit (a check of degree
    d holds d sign bits, m1 and m2 as the store's magnitudes, its width
    less the sign bit each, and the argmin, ``(d - 1).bit_length()`` bits;
    the sign product is the sign bits' parity), and ``split_r`` and
    ``split_c``, :func:`state_bytes`' sums with it in the records'
    place."""
    width = STORES[_store_name(store)].itemsize
    frame = plan.n * width
    bits = plan.z * sum(int(d) + 2 * (8 * width - 1) + int(d - 1).bit_length()
                        for d in plan.cn_valid.sum(axis=1))
    state = -(-bits // 8)
    return {"state": state, "split_r": frame + 2 * state + 3 * 4,
            "split_c": 2 * frame + state + 4}


def _unsigned(bits: torch.Tensor) -> torch.Tensor:
    """int32 sign words -> the plain version's int64 words in [0, 2^32)."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def _signed(bits: torch.Tensor) -> torch.Tensor:
    """The plain version's int64 words in [0, 2^32) -> int32, bit for bit."""
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32)


def _keep(live: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``new`` for live words, ``old`` for latched ones."""
    return torch.where(live.view(-1, *[1] * (old.ndim - 1)), new, old)


def _minsum_state(s: SplitState) -> _MinSumState:
    """The records as the plain version's planes, in the store (m1, m2 and
    the argmin are exact there: the refusal of ``_ARGMIN_LIMIT`` keeps the
    argmin in range)."""
    store = s.tot.dtype
    rec = s.rec

    def mag(w: torch.Tensor) -> torch.Tensor:
        return (w & 0x7FFFFFFF).view(torch.float32).to(store)

    sp = torch.where(rec[..., 1] < 0, -1.0, 1.0).to(store)
    bits = torch.cat([rec[..., :1], s.xbits], -1)
    return _MinSumState.from_planes(mag(rec[..., 1]), mag(rec[..., 2]),
                                    rec[..., 3].to(store), sp,
                                    _unsigned(bits), store)


def _records(ms: _MinSumState) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's planes as records and the sign words past the
    first."""
    sign = torch.where(_ld(ms.sp) < 0, _SIGN_BIT, 0).to(torch.int32)
    bits = _signed(ms.bits)
    m1 = _ld(ms.m1).view(torch.int32) | sign
    m2 = _ld(ms.m2).view(torch.int32) | sign
    rec = torch.stack([bits[..., 0], m1, m2, _ld(ms.am).to(torch.int32)], -1)
    return rec, bits[..., 1:].contiguous()


def _negatives(tot: torch.Tensor) -> torch.Tensor:
    return (_ld(tot) < 0).sum(-1, dtype=torch.int32)


def split_r_reference(s: SplitState, t: _RefTables, it: int) -> SplitState:
    """Plain version of one ``split_r`` launch: for every word not yet
    latched, the new records from the totals and the old records, then the
    latches of iteration ``it`` (at ``it`` 0 also the error count of the
    totals, which no ``split_c`` counted); latched words are left as they
    are."""
    live = s.success == 0
    ms = _minsum_state(s)
    ok = _minsum_phase_a(s.tot, ms, t, "min-sum", 0.0, 0.0, False)
    rec, xbits = _records(ms)
    newly = live & ok
    errors = (torch.where(live, _negatives(s.tot), s.errors) if it == 0
              else s.errors)
    return dataclasses.replace(
        s, rec=_keep(live, rec, s.rec), xbits=_keep(live, xbits, s.xbits),
        errors=errors, iters=torch.where(newly, it, s.iters),
        success=(s.success.bool() | newly).to(torch.int32))


def split_c_reference(s: SplitState, t: _RefTables) -> SplitState:
    """Plain version of one ``split_c`` launch: for every word not yet
    latched, totals = -chan + its rebuilt c2v messages in column-edge
    order, rounded to the store, and the error count of those totals."""
    live = s.success == 0
    tot = _minsum_phase_b(s.chan, _minsum_state(s), t, "min-sum", 0.0,
                          0.0, s.tot.dtype)
    return dataclasses.replace(
        s, tot=_keep(live, tot, s.tot),
        errors=torch.where(live, _negatives(tot), s.errors))


def split_reference(llr: torch.Tensor, plan: DecodePlan, max_iters: int,
                    store_dtype="bfloat16", *, chunk: int = 4096,
                    tables: _RefTables | None = None):
    """Plain PyTorch version of the split decoder, on ``llr``'s device: the
    arithmetic of ``cuda_static.flooding_reference`` (min-sum, phase A for
    all checks, then phase B for all variables), without its sanitising of
    non-finite LLRs."""
    store = _store_name(store_dtype)
    if store not in _FLOAT_STORES:
        raise NotImplementedError("the split decoder is float-storage only")
    return _reference(_reference_chunk, llr, plan, max_iters, "min-sum",
                      store, 0.0, 0.0, False, chunk, tables)


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use and bound once."""
    global _LIB
    if _LIB is None:
        from ..csrc import load
        lib = load("split")
        bind(lib)
        _LIB = lib
    return _LIB


def bind(lib: ctypes.CDLL) -> None:
    """Declare ``split_launch``'s C signature on a library that holds it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.split_launch.argtypes = [i, i, i, i, i, i, i, i, i, i, p, p, p, p, p,
                                 p, p, p, p, i, p]
    lib.split_launch.restype = i


def launch_args(phase: str, s: SplitState, plan: DecodePlan,
                tables: torch.Tensor, n_ok: torch.Tensor, it: int,
                stream) -> tuple:
    """``split_launch``'s arguments for one launch on ``s``."""
    store = str(s.tot.dtype).removeprefix("torch.")
    return (0 if phase == "r" else 1, _FLOAT_STORES.index(store),
            s.tot.shape[0], plan.n, plan.m, plan.z, plan.block_rows,
            plan.block_cols, plan.dmax_cn, plan.dmax_vn, tables.data_ptr(),
            s.chan.data_ptr(), s.tot.data_ptr(), s.rec.data_ptr(),
            s.xbits.data_ptr(), s.errors.data_ptr(), s.iters.data_ptr(),
            s.success.data_ptr(), n_ok.data_ptr(), it, stream)


def launch(phase: str, s: SplitState, plan: DecodePlan,
           tables: torch.Tensor, n_ok: torch.Tensor, it: int = 0) -> None:
    """One launch of ``split_r`` (``phase="r"``, iteration ``it``, counting
    the latched words into ``n_ok[it]``) or ``split_c`` (``phase="c"``) on
    the state ``s``, in place, on the current stream; ``tables`` is
    ``split_tables(plan, store)`` on the state's device."""
    store = str(s.tot.dtype).removeprefix("torch.")
    dev = s.tot.device
    b = s.tot.shape[0]
    with torch.cuda.device(dev):
        rc = _lib().split_launch(*launch_args(
            phase, s, plan, tables, n_ok, it,
            torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"split_{phase} launch ({store}) failed: CUDA "
                           f"error {rc}")
    if b:
        launches[(f"split_{phase}", store)] += 1


def make_split_sweep_decoder(code: QCCode, max_iters: int = 50, *,
                             tile_b: int = 128, store_dtype="bfloat16",
                             device=None):
    """Build ``decode_counts(llr[B, n] float32) -> (errors, iterations,
    success)`` of the phase-split decoder for ``code`` on ``device``
    (default: the card).

    ``B`` must be a multiple of ``tile_b``, as in the JAX package; the
    kernels take one word per block, so ``tile_b`` means nothing else here.
    ``store_dtype`` is bfloat16 or float32; an integer store raises
    ``NotImplementedError`` (float-storage only, as the Pallas pair).  The
    decoder takes contiguous float32 LLRs on its own device (positive means
    bit 1).  ``decode_counts.host_reads`` is the number of host reads of the
    latched count that its last call made."""
    store = _store_name(store_dtype)
    if store not in _FLOAT_STORES:
        raise NotImplementedError("the split decoder is float-storage only")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    plan = DecodePlan.from_code(code)
    if plan.dmax_cn > _ARGMIN_LIMIT[store]:
        raise NotImplementedError(
            f"check degree {plan.dmax_cn} exceeds the exact integer range "
            f"of the {store} argmin plane ({_ARGMIN_LIMIT[store]})")
    if dev.type == "cuda":
        tables = torch.as_tensor(split_tables(plan, store), device=dev)
    else:
        ref_tables = _RefTables(plan, dev)

    def decode_counts(llr: torch.Tensor):
        if llr.device != dev:
            raise ValueError(f"llr is on {llr.device}, decoder on {dev}")
        if llr.dtype != torch.float32:
            raise TypeError(f"llr must be float32, got {llr.dtype}")
        if llr.ndim != 2 or llr.shape[1] != plan.n:
            raise ValueError(f"llr must be [B, {plan.n}], got "
                             f"{tuple(llr.shape)}")
        b = llr.shape[0]
        if b % tile_b:
            raise ValueError(f"batch {b} not a multiple of tile_b={tile_b}")
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        if dev.type == "cpu":
            return split_reference(llr, plan, max_iters, store,
                                   tables=ref_tables)
        s = SplitState.start(llr, plan, max_iters, store)
        n_ok = torch.zeros(max_iters + 1, dtype=torch.int32, device=dev)
        if b == 0:
            decode_counts.host_reads = 0
            return s.errors, s.iters, s.success.bool()
        stream = torch.cuda.current_stream(dev)
        # the latched counts, read by the host as each one lands
        seen = torch.empty(max_iters, dtype=torch.int32, pin_memory=True)
        copied = [torch.cuda.Event() for _ in range(max_iters)]

        def enqueue(it: int) -> None:
            # iteration it: split_r, the copy of its latched count to the
            # host, then split_c (none after the last split_r)
            launch("r", s, plan, tables, n_ok, it)
            if it < max_iters:
                seen[it:it + 1].copy_(n_ok[it:it + 1], non_blocking=True)
                copied[it].record(stream)
                launch("c", s, plan, tables, n_ok)

        # Iteration it + 1 is enqueued before iteration it's count is read,
        # so the card has work while the host waits: a latched word is
        # frozen and its blocks return at once, so the one iteration run
        # past convergence changes no output.  (On an H100, a loop that
        # read each count before it enqueued the next iteration left the
        # card idle for 4-11% of a decode under torch.profiler, and
        # decoded 1.7-5% slower.)
        reads = 0
        enqueue(0)
        for it in range(max_iters):
            enqueue(it + 1)
            copied[it].synchronize()
            reads += 1
            if int(seen[it]) == b:
                break
        decode_counts.host_reads = reads
        return s.errors, s.iters, s.success.bool()

    decode_counts.plan = plan
    decode_counts.host_reads = 0
    return decode_counts
