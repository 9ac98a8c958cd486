"""Decode with compressed check state: the CUDA kernel, its plain PyTorch
versions, and the wrapper that chooses between them.

Port of ``ldpc_tpu.ops.pallas_static``: every ``kind`` ("min-sum",
"normalized-min-sum", "offset-min-sum", "sum-product"), the ``store_dtype``s
bfloat16, float32 and int8 (Q4.3 message memory, min-sum family), the
``schedule``s "flooding" and "layered" (min-sum family) and
``popcount_sign`` (the sign product folded from the sign bits), with f32
arithmetic.  ``make_static_sweep_decoder(code, max_iters, ...)`` returns
``decode_counts(llr[B, n]) -> (errors[B], iterations[B], success[B])``, the
contract of the Pallas decoder: bit errors against the all-zero codeword,
the first iteration (sweep) whose syndrome is zero (``max_iters`` if none),
and whether there was one.  The check runs BEFORE each update, so a word
that does not converge reports the state after exactly ``max_iters``
updates.

On a CUDA tensor the wrapper launches ``csrc/decode.cu`` (one thread
block per word; see the note at the head of that file) or raises.  On a CPU
tensor it runs ``flooding_reference`` or ``layered_reference``, the same
arithmetic written as batched tensor operations, with the same rounding
points and the same f32 summation orders.  The two agree word for word.
Against the Pallas kernel the min-sum family agrees word for word too;
sum-product agrees in statistics, since XLA's and torch's CPU
``tanh``/``log`` differ in the last bits.

``barrier_lowers(device)`` is the counterpart of the Pallas kernel's
``_barrier_lowers`` probe (``csrc/barrier_probe.cu``): a nonzero
``dep_stride`` runs it on the card, where the JAX kernel's build does.

``launches`` counts kernel launches made through a wrapper, per
``(kind, store, schedule, popcount_sign)`` and ``"barrier_probe"``; a run
clears it and reads it to show which work went through the kernel.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.device import resolve_device
from .plan import DecodePlan, frame_indices

__all__ = ["KINDS", "STORES", "SCHEDULES", "make_static_sweep_decoder",
           "static_decode_counts", "flooding_reference",
           "layered_reference", "kernel_tables", "smem_bytes",
           "barrier_probe", "barrier_lowers"]

KINDS = ("min-sum", "normalized-min-sum", "offset-min-sum", "sum-product")
STORES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8}
SCHEDULES = ("flooding", "layered")

launches: collections.Counter = collections.Counter()

_BIG = 3.0e38          # two-min fold start, as ops/pallas_static.py _BIG
_LLR_CLIP = 1.0e30     # non-finite LLRs: NaN -> 0, +-inf -> +-1e30
_PHI_MIN = 1e-9        # sum-product phi argument clip (pallas _PHI_MIN)
_PHI_MAX = 38.0        # (pallas _PHI_MAX); phi(38) == 0 in f32
_QUANT = 8.0           # int8 Q4.3: step 1/8 (pallas _QUANT_SCALE)
_QMAX = 127.0          # symmetric int8 clip
_MAX_SMEM = 232_448 - 1024   # per-block shared memory, less static + margin
# The argmin plane stores a slot index as a number in the store type.
_ARGMIN_LIMIT = {"bfloat16": 256, "float32": 1 << 24, "int8": 127}
_SOURCE = "decode"


def _store_name(store_dtype) -> str:
    """``"bfloat16"``, ``"float32"`` or ``"int8"`` for a torch dtype or its
    name."""
    name = str(store_dtype).removeprefix("torch.")
    if name not in STORES:
        raise ValueError(f"unsupported store_dtype: {store_dtype}")
    return name


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unsupported kernel kind: {kind}")


def _sanitize(llr: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(llr, nan=0.0, posinf=_LLR_CLIP,
                            neginf=-_LLR_CLIP).clamp(-_LLR_CLIP, _LLR_CLIP)


def _st(x: torch.Tensor, store: torch.dtype) -> torch.Tensor:
    """Round f32 ``x`` into the store (pallas ``_st``): int8 holds
    clip(round(x * 8), -127, 127), round half to even as ``jnp.round``."""
    if store == torch.int8:
        return torch.round(x * _QUANT).clamp(-_QMAX, _QMAX).to(torch.int8)
    return x.to(store)


def _ld(q: torch.Tensor) -> torch.Tensor:
    """Widen a stored value to f32 (pallas ``_ld``): int8 loads q / 8."""
    if q.dtype == torch.int8:
        return q.float() * (1.0 / _QUANT)
    return q.float()


def _st_raw(x: torch.Tensor, store: torch.dtype) -> torch.Tensor:
    """A small exact integer (the argmin plane), never scaled
    (pallas ``_st_raw``)."""
    return x.to(store)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)) on a clipped argument (pallas ``_phi``)."""
    return -torch.log(torch.tanh(x * 0.5))


def _row_base(plan: DecodePlan) -> np.ndarray:
    """Index of each block row's first block edge (the phi stash's rows)."""
    deg = plan.cn_valid.sum(axis=1)
    return np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int32)


def _n_edges(plan: DecodePlan) -> int:
    return int(plan.cn_valid.sum())


def _sign_words(plan: DecodePlan) -> int:
    return -(-plan.dmax_cn // 32)


def kernel_tables(plan: DecodePlan) -> np.ndarray:
    """The kernel's int32 edge tables, concatenated: row_deg | row_base |
    row_nb | row_shift | col_deg | col_mb | col_d | col_shift.

    Row slots are the plan's CN slots; ``row_base`` is each block row's
    first block edge in the phi stash; column slots follow the plan's VN
    order (ascending block row, then slot), which is the accumulation order
    of the Pallas kernel's phase B."""
    dc = plan.dmax_cn
    col_mb = plan.vn_slot // dc
    col_d = plan.vn_slot % dc
    parts = [plan.cn_valid.sum(axis=1), _row_base(plan), plan.cn_nb,
             plan.cn_shift % plan.z, plan.vn_valid.sum(axis=1), col_mb,
             col_d, plan.vn_shift % plan.z]
    return np.concatenate([np.asarray(p, np.int32).ravel() for p in parts])


def smem_bytes(plan: DecodePlan, kind: str = "min-sum",
               store: str = "bfloat16", schedule: str = "flooding",
               popcount_sign: bool = False) -> int:
    """Dynamic shared memory of one block (as ``csrc/decode.cu`` sizes
    it): the host's edge tables (4 bytes an entry), then, from a 16-byte
    boundary, for the min-sum family the packed column and row tables (16
    and 8 bytes an entry), one 16-byte record per check (the sign product
    is a bit or the sign of its values, so popcount_sign changes nothing)
    and the sign words past the first (4 bytes each).  The layered
    schedule has a (block row, slot) table of 16 bytes an entry in place
    of the column table, and, from a 16-byte boundary after the records,
    the row scratch (one 16-byte record per check of a block row, and its
    sign words past the first), a (block row, block) table of 8 bytes an
    entry and a block count per block row.  Sum-product has a 16-byte
    entry per block edge and per (block column, slot), an 8-byte record,
    the sign words past the first and a parity word per check, and one
    float32 per Tanner edge (z rounded up to a multiple of 4 a block
    edge).  Then the
    channel and total planes in the store."""
    _check_kind(kind)
    sw = _sign_words(plan)
    n_tab = (plan.block_rows * (2 + 2 * plan.dmax_cn) +
             plan.block_cols * (1 + 3 * plan.dmax_vn))
    width = STORES[_store_name(store)].itemsize
    planes = 2 * width * plan.n
    tables = -(-4 * n_tab // 16) * 16
    if kind == "sum-product":
        stride = -(-plan.z // 4) * 4       # z rounded up to a multiple of 4
        return (tables + 16 * (_n_edges(plan) + plan.block_cols *
                               plan.dmax_vn) +
                4 * plan.m * (2 + sw) + 4 * _n_edges(plan) * stride + planes)
    edges = plan.block_rows * plan.dmax_cn          # (block row, slot)
    tables += 8 * edges
    if schedule == "layered":
        return (tables + 16 * edges + 16 * plan.m + 16 * plan.z +
                8 * edges + 4 * plan.block_rows +
                4 * (plan.z + plan.m) * (sw - 1) + planes)
    return (tables + 16 * plan.block_cols * plan.dmax_vn + 16 * plan.m +
            4 * plan.m * (sw - 1) + planes)


class _RefTables:
    """Gather indices of the plain version, built once per (plan, device)."""

    def __init__(self, plan: DecodePlan, device):
        z, dc = plan.z, plan.dmax_cn
        f = frame_indices(plan)
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt,  # noqa: E731
                                             device=device)
        self.z = z
        self.row_deg = [int(x) for x in plan.cn_valid.sum(axis=1)]
        self.var_idx = as_t(f["var_idx"], torch.int64)
        self.cn_valid = as_t(f["cn_valid"], torch.bool)
        self.chk_idx = as_t(f["chk_idx"], torch.int64)
        self.chk_d = as_t(f["chk_d"], torch.int64)
        self.chk_word = self.chk_d >> 5
        self.vn_valid = as_t(f["vn_valid"], torch.bool)
        self.slot = torch.arange(dc, dtype=torch.int64, device=device)
        self.n_sw = _sign_words(plan)
        self.bit_of_word = torch.arange(32, dtype=torch.int64, device=device)
        # sum-product: check c = mb*z + i, slot d -> its phi stash entry
        # (row_base[mb] + d)*z + i, and stash entry -> flat (check, slot)
        base = np.repeat(_row_base(plan), z)[:, None]
        i = np.tile(np.arange(z), plan.block_rows)[:, None]
        stash_idx = (base + np.arange(dc)[None, :]) * z + i
        stash_idx = np.where(f["cn_valid"], stash_idx, 0)
        chk_stash = stash_idx.reshape(-1)[f["chk_idx"] * dc + f["chk_d"]]
        self.stash_idx = as_t(stash_idx, torch.int64)
        self.chk_stash = as_t(np.where(f["vn_valid"], chk_stash, 0),
                              torch.int64)
        flat = np.flatnonzero(f["cn_valid"].reshape(-1))
        order = np.argsort(stash_idx.reshape(-1)[flat])
        self.stash_from_slot = torch.as_tensor(flat[order], device=device)
        self.n_stash = _n_edges(plan) * z


def _slot_bits(bits: torch.Tensor, t: _RefTables) -> torch.Tensor:
    """Sign bit of every (check, slot) from the packed words [b, m, n_sw]."""
    words = bits[..., t.slot >> 5]                          # [b, m, dc]
    return ((words >> (t.slot & 31)) & 1).to(torch.float32)


def _pack_bits(neg: torch.Tensor, t: _RefTables) -> torch.Tensor:
    """Edge signs [b, m, dc] -> ceil(dc/32) words of 32 bits [b, m, n_sw]."""
    b, m, dc = neg.shape
    pad = t.n_sw * 32 - dc
    x = torch.nn.functional.pad(neg.to(torch.int64), (0, pad))
    return (x.view(b, m, t.n_sw, 32) << t.bit_of_word).sum(-1)


def _parity_sign(bits: torch.Tensor) -> torch.Tensor:
    """+-1 from the parity of each check's sign words [..., n_sw]: the xor
    of the words, folded (pallas ``_sign_from_bits``)."""
    x = bits[..., 0]
    for w in range(1, bits.shape[-1]):
        x = x ^ bits[..., w]
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return 1.0 - 2.0 * (x & 1).to(torch.float32)


def _column_bits(bits: torch.Tensor, t: _RefTables) -> torch.Tensor:
    """Sign bit of every (variable, column slot) [b, n, dv]."""
    words = bits[:, t.chk_idx]                              # [b, n, dv, sw]
    idx = t.chk_word.expand(words.shape[:-1])[..., None]
    word = torch.gather(words, -1, idx).squeeze(-1)
    return ((word >> (t.chk_d & 31)) & 1).to(torch.float32)


def _adjust(mag, kind, alpha, beta):
    """The rebuilt magnitude of a min-sum-family message (pallas
    ``_recon``): scaled by alpha, or lowered by beta with a floor at 0."""
    if kind == "normalized-min-sum":
        return mag * alpha
    if kind == "offset-min-sum":
        return (mag - beta).clamp_min(0.0)
    return mag


def _rebuild(m1, m2, am, sign, bits, t, kind, alpha, beta):
    """The c2v message of every (check, slot) [b, r, dc] from a compressed
    state in f32 (pallas ``_recon``): m1, m2, the argmin and the sign
    product [b, r], the sign words [b, r, n_sw]."""
    sgn = sign[..., None] * (1.0 - 2.0 * _slot_bits(bits, t))
    mag = torch.where(am[..., None] == t.slot.float(), m2[..., None],
                      m1[..., None])
    return sgn * _adjust(mag, kind, alpha, beta)


def _sum_in_order(acc, terms, valid):
    """acc + terms[..., 0] + terms[..., 1] + ... in slot order; invalid
    slots add -0.0, which leaves every value as it is."""
    terms = torch.where(valid, terms, -0.0)
    for k in range(terms.shape[-1]):
        acc = acc + terms[..., k]
    return acc


class _MinSumState:
    """The min-sum family's compressed check state of a batch of words, in
    the store: m1, m2, the argmin (a raw slot index), the sign product
    (absent with popcount_sign) and the packed sign words."""

    def __init__(self, b, m, t, store, popcount, dev):
        self.store, self.popcount = store, popcount
        self.m1 = _st(torch.zeros(b, m, device=dev), store)
        self.m2 = self.m1.clone()
        self.am = _st_raw(torch.zeros(b, m, device=dev), store)
        self.sp = None if popcount else _st(torch.ones(b, m, device=dev),
                                            store)
        self.bits = torch.zeros(b, m, t.n_sw, dtype=torch.int64, device=dev)

    @classmethod
    def from_planes(cls, m1, m2, am, sp, bits, store):
        """A stored state [b, m] (sign words [b, m, n_sw]), not copied."""
        self = cls.__new__(cls)
        self.store, self.popcount = store, sp is None
        self.m1, self.m2, self.am, self.sp, self.bits = m1, m2, am, sp, bits
        return self

    def sign(self, rows=slice(None)) -> torch.Tensor:
        """The sign product of the checks ``rows`` [b, r], f32."""
        if self.popcount:
            return _parity_sign(self.bits[:, rows])
        return _ld(self.sp[:, rows])

    def messages(self, rows, t, kind, alpha, beta) -> torch.Tensor:
        """The c2v message of every (check in ``rows``, slot) [b, r, dc]
        rebuilt from the stored state."""
        return _rebuild(_ld(self.m1[:, rows]), _ld(self.m2[:, rows]),
                        self.am[:, rows].float(), self.sign(rows),
                        self.bits[:, rows], t, kind, alpha, beta)

    def write(self, rows, new) -> None:
        n1, n2, amn, nsp, bits = new
        self.m1[:, rows] = _st(n1, self.store)
        self.m2[:, rows] = _st(n2, self.store)
        self.am[:, rows] = _st_raw(amn, self.store)
        if not self.popcount:
            self.sp[:, rows] = _st(nsp, self.store)
        self.bits[:, rows] = bits


def _row_stats(v, valid, t, popcount):
    """The new compressed state (f32, unrounded) from the v2c messages
    ``v`` [b, r, dc] (pallas ``_row_stats``): two minima with multiplicity,
    the argmin (first of equals), the sign product and the sign words."""
    a = torch.where(valid, v.abs(), _BIG)
    n1, amn = a.min(-1)
    # second minimum with multiplicity: mask one argmin slot
    n2 = a.scatter(-1, amn[..., None], float("inf")).min(-1).values
    n2 = n2.clamp(max=_BIG)
    neg = (v < 0) & valid
    bits = _pack_bits(neg, t)
    nsp = (_parity_sign(bits) if popcount
           else (1 - 2 * (neg.sum(-1) % 2)).to(torch.float32))
    return n1, n2, amn.to(torch.float32), nsp, bits


def _syndrome_ok(tt: torch.Tensor, t: _RefTables) -> torch.Tensor:
    """Per word, whether every check of the gathered totals [b, m, dc]
    holds."""
    return (((tt < 0) & t.cn_valid).sum(-1) % 2).sum(-1) == 0


def _minsum_phase_a(tot, state: _MinSumState, t: _RefTables, kind: str,
                    alpha: float, beta: float, popcount: bool):
    """Phase A of the min-sum family over all checks: returns per word
    whether the totals satisfy every check, and writes each check's new
    state, from the totals and its old state, into ``state``."""
    tt = _ld(tot)[:, t.var_idx]                             # [b, m, dc]
    v = tt - state.messages(slice(None), t, kind, alpha, beta)
    state.write(slice(None), _row_stats(v, t.cn_valid, t, popcount))
    return _syndrome_ok(tt, t)


def _minsum_phase_b(chan, state: _MinSumState, t: _RefTables, kind: str,
                    alpha: float, beta: float, store: torch.dtype):
    """Phase B of the min-sum family: totals = -chan + each rebuilt c2v
    message, in column-slot order, rounded to the store."""
    g = t.chk_idx                                           # [n, dv]
    sgn = state.sign()[:, g] * (1.0 - 2.0 * _column_bits(state.bits, t))
    mag = torch.where(state.am[:, g].float() == t.chk_d.to(torch.float32),
                      _ld(state.m2)[:, g], _ld(state.m1)[:, g])
    msg = sgn * _adjust(mag, kind, alpha, beta)
    return _st(_sum_in_order(-_ld(chan), msg, t.vn_valid), store)


def _reference_chunk(llr: torch.Tensor, t: _RefTables, max_iters: int,
                     kind: str, store: torch.dtype, alpha: float,
                     beta: float, popcount: bool):
    f32 = torch.float32
    sum_product = kind == "sum-product"
    b, dev = llr.shape[0], llr.device
    m = t.var_idx.shape[0]
    chan = _st(llr, store)
    tot = _st(-_ld(chan), store)
    if sum_product:
        sp = _st(torch.ones(b, m, device=dev), store)
        bits = torch.zeros(b, m, t.n_sw, dtype=torch.int64, device=dev)
        s_tot = _st(torch.full((b, m), _PHI_MAX, device=dev), store)
        stash = _st(torch.zeros(b, t.n_stash, device=dev), store)
    else:
        state = _MinSumState(b, m, t, store, popcount, dev)
    errors = torch.zeros(b, dtype=torch.int32, device=dev)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    success = torch.zeros(b, dtype=torch.bool, device=dev)
    valid = t.cn_valid
    for it in range(max_iters + 1):
        # ---- phase A: syndrome + new check state, all checks at once ----
        if sum_product:
            tt = _ld(tot)[:, t.var_idx]                     # [b, m, dc]
            ok = _syndrome_ok(tt, t)
            sgn = _ld(sp)[..., None] * (1.0 - 2.0 * _slot_bits(bits, t))
            phi_old = _ld(stash[:, t.stash_idx])
            rest = (_ld(s_tot)[..., None] - phi_old).clamp(_PHI_MIN,
                                                           _PHI_MAX)
            v = tt - sgn * _phi(rest)
            ph = _phi(v.abs().clamp(_PHI_MIN, _PHI_MAX))
            stash = _st(ph.reshape(b, -1)[:, t.stash_from_slot], store)
            s_tot = _st(_sum_in_order(torch.zeros(b, m, dtype=f32,
                                                  device=dev), ph, valid),
                        store)
            neg = (v < 0) & valid
            bits = _pack_bits(neg, t)
            sp = _st((1 - 2 * (neg.sum(-1) % 2)).to(f32), store)
        else:
            ok = _minsum_phase_a(tot, state, t, kind, alpha, beta, popcount)
        # ---- latches (pallas_static.py _latches) ----
        iters = iters.masked_fill(ok & ~success, it)
        errs = (_ld(tot) < 0).sum(-1, dtype=torch.int32)
        errors = torch.where(success, errors, errs)
        success = success | ok
        if it == max_iters or bool(success.all()):
            break
        # ---- phase B: totals = -chan + sum over column slots, in order ----
        if sum_product:
            g = t.chk_idx                                   # [n, dv]
            sgn = _ld(sp)[:, g] * (1.0 - 2.0 * _column_bits(bits, t))
            rest = (_ld(s_tot)[:, g] -
                    _ld(stash[:, t.chk_stash])).clamp(_PHI_MIN, _PHI_MAX)
            tot = _st(_sum_in_order(-_ld(chan), sgn * _phi(rest),
                                    t.vn_valid), store)
        else:
            tot = _minsum_phase_b(chan, state, t, kind, alpha, beta, store)
    return errors, iters, success


def _layered_chunk(llr: torch.Tensor, t: _RefTables, max_iters: int,
                   kind: str, store: torch.dtype, alpha: float, beta: float,
                   popcount: bool):
    z = t.z
    b, dev = llr.shape[0], llr.device
    m = t.var_idx.shape[0]
    chan = _st(llr, store)
    tot = _st(-_ld(chan), store)
    state = _MinSumState(b, m, t, store, popcount, dev)
    errors = torch.zeros(b, dtype=torch.int32, device=dev)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    success = torch.zeros(b, dtype=torch.bool, device=dev)
    for it in range(max_iters + 1):
        # ---- syndrome of the totals at the start of the sweep ----
        ok = _syndrome_ok(_ld(tot)[:, t.var_idx], t)
        iters = iters.masked_fill(ok & ~success, it)
        errs = (_ld(tot) < 0).sum(-1, dtype=torch.int32)
        errors = torch.where(success, errors, errs)
        success = success | ok
        if it == max_iters or bool(success.all()):
            break
        # ---- block row by block row (pallas layered_body) ----
        for mb, deg in enumerate(t.row_deg):
            rows = slice(mb * z, (mb + 1) * z)
            idx, valid = t.var_idx[rows], t.cn_valid[rows]
            old = state.messages(rows, t, kind, alpha, beta)
            new = _row_stats(_ld(tot)[:, idx] - old, valid, t, popcount)
            # Pallas rebuilds the new messages from the unrounded fold
            delta = _rebuild(*new, t, kind, alpha, beta) - old
            # one indexed update per edge, in slot order, rounded each time:
            # two edges of one block reach the same variables
            for d in range(deg):
                tot[:, idx[:, d]] = _st(_ld(tot[:, idx[:, d]]) +
                                        delta[..., d], store)
            state.write(rows, new)
    return errors, iters, success


def _reference(chunk_fn, llr, plan, max_iters, kind, store_dtype, alpha,
               beta, popcount_sign, chunk, tables):
    _check_kind(kind)
    store = STORES[_store_name(store_dtype)]
    t = tables or _RefTables(plan, llr.device)
    popcount = bool(popcount_sign) and kind != "sum-product"
    outs = [chunk_fn(llr[lo:lo + chunk], t, max_iters, kind, store,
                     float(alpha), float(beta), popcount)
            for lo in range(0, llr.shape[0], chunk)]
    if not outs:
        e = torch.zeros(0, dtype=torch.int32, device=llr.device)
        return e, e.clone(), e.bool()
    return tuple(torch.cat(x) for x in zip(*outs))


def flooding_reference(llr: torch.Tensor, plan: DecodePlan, max_iters: int,
                       *, kind: str = "min-sum", store_dtype="bfloat16",
                       alpha: float = 0.75, beta: float = 0.15,
                       popcount_sign: bool = False, chunk: int = 4096,
                       tables: _RefTables | None = None):
    """Plain PyTorch version of the flooding kernel, on ``llr``'s device.

    Decodes ``chunk`` words at a time (the gathered [chunk, m, dmax] state
    is the memory peak) and stops a chunk once all its words converged.
    Non-finite LLRs are sanitised first, as at the kernel's entry."""
    return _reference(_reference_chunk, _sanitize(llr), plan, max_iters, kind,
                      store_dtype, alpha, beta, popcount_sign, chunk, tables)


def layered_reference(llr: torch.Tensor, plan: DecodePlan, max_iters: int,
                      *, kind: str = "min-sum", store_dtype="bfloat16",
                      alpha: float = 0.75, beta: float = 0.15,
                      popcount_sign: bool = False, chunk: int = 4096,
                      tables: _RefTables | None = None):
    """Plain PyTorch version of the layered kernel (min-sum family), on
    ``llr``'s device: a syndrome pass and the latches, then per block row
    the new state from the current totals and each edge's delta added to
    the totals, edge by edge in slot order."""
    if kind == "sum-product":
        raise ValueError("sum-product kernel supports flooding only")
    return _reference(_layered_chunk, _sanitize(llr), plan, max_iters, kind,
                      store_dtype, alpha, beta, popcount_sign, chunk, tables)


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use and bound once."""
    global _LIB
    if _LIB is None:
        from ..csrc import load
        lib = load(_SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_launch.argtypes = [i, i, i, i, p, i, i, i, i, i, i, i,
                                      i, i, p, i, f, f, p, p, p, p]
        lib.decode_launch.restype = i
        _LIB = lib
    return _LIB


def _launch(llr: torch.Tensor, plan: DecodePlan, tables: torch.Tensor,
            max_iters: int, kind: str, store: str, schedule: str,
            popcount: bool, alpha: float, beta: float):
    lib = _lib()
    b = llr.shape[0]
    out = [torch.empty(b, dtype=torch.int32, device=llr.device)
           for _ in range(3)]
    if b:
        with torch.cuda.device(llr.device):
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            rc = lib.decode_launch(
                KINDS.index(kind), list(STORES).index(store),
                SCHEDULES.index(schedule), int(popcount), llr.data_ptr(),
                b, plan.n, plan.m, plan.z, plan.block_rows, plan.block_cols,
                plan.dmax_cn, plan.dmax_vn, _n_edges(plan),
                tables.data_ptr(), max_iters, alpha, beta,
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(
                f"{_SOURCE} launch ({kind}, {store}, {schedule}, popcount "
                f"{popcount}) failed: CUDA error {rc}")
        launches[(kind, store, schedule, popcount)] += 1
    return out[0], out[1], out[2].bool()


_PROBE_LIB: ctypes.CDLL | None = None
_BARRIER_OK: dict[torch.device, bool] = {}


def _probe_lib() -> ctypes.CDLL:
    global _PROBE_LIB
    if _PROBE_LIB is None:
        from ..csrc import load
        lib = load("barrier_probe")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.barrier_probe_launch.argtypes = [p, p, i, p]
        lib.barrier_probe_launch.restype = i
        _PROBE_LIB = lib
    return _PROBE_LIB


def barrier_probe(x: torch.Tensor) -> torch.Tensor:
    """``x + |x|`` with both terms passed through a compiler barrier: the
    kernel ``csrc/barrier_probe.cu`` on a CUDA tensor, the plain
    ``x + x.abs()`` on a CPU one.  ``x`` is contiguous float32."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("barrier_probe takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return x + x.abs()
    lib = _probe_lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.barrier_probe_launch(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"barrier_probe launch failed: CUDA error {rc}")
    launches["barrier_probe"] += 1
    return out


def barrier_lowers(device=None) -> bool:
    """Whether the compiler barrier leaves values as they are: the probe
    of the Pallas kernel's ``_barrier_lowers`` on ``device`` (default: the
    card), ``a + |a|`` over an [8, 128] float32 array of
    ``linspace(-1, 1, 1024)``, compared exactly with numpy.  Probed once a
    process per device; a failure to build or launch raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _BARRIER_OK:
        x = np.linspace(-1.0, 1.0, 8 * 128,
                        dtype=np.float32).reshape(8, 128)
        got = barrier_probe(torch.from_numpy(x).to(dev)).cpu().numpy()
        _BARRIER_OK[dev] = bool(np.array_equal(got, x + np.abs(x)))
    return _BARRIER_OK[dev]


def make_static_sweep_decoder(code: QCCode, max_iters: int = 50, *,
                              kind: str = "min-sum",
                              store_dtype="bfloat16", alpha: float = 0.75,
                              beta: float = 0.15,
                              schedule: str = "flooding",
                              popcount_sign: bool | None = None,
                              dep_stride: int | None = None,
                              device=None):
    """Build ``decode_counts(llr[B, n] float32) -> (errors, iterations,
    success)`` for ``code`` on ``device`` (default: the card).

    The decoder takes contiguous float32 LLRs on its own device (positive
    means bit 1).  The min-sum family is scale-invariant in the float
    stores, so raw BPSK samples will do; int8 quantizes its input, and the
    JAX package feeds it raw samples too; sum-product needs true LLRs
    (2y/sigma^2).  ``alpha`` scales normalized min-sum and ``beta`` offsets
    offset min-sum, as in the JAX package.  ``schedule="layered"`` (min-sum
    family) counts sweeps; ``popcount_sign`` folds the sign product from
    the sign bits (min-sum family; sum-product ignores it), with the same
    trajectories.  On CUDA it launches the kernel; on the CPU it runs the
    plain version.

    ``dep_stride`` gates the Pallas kernel's unrolled rotation window behind
    a barrier, with bit-identical trajectories.  This kernel indexes
    ``(i + s) mod z`` and unrolls no rotations, so it has nothing to gate:
    a nonzero value runs ``barrier_lowers`` on the card, where the Pallas
    kernel's build probes, and decodes exactly as ``dep_stride=0``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule: {schedule}")
    _check_kind(kind)
    if kind == "sum-product" and schedule != "flooding":
        raise ValueError("sum-product kernel supports flooding only")
    store = _store_name(store_dtype)
    if kind == "sum-product" and store == "int8":
        raise ValueError("integer message memory supports the min-sum "
                         "family only (phi spans ~[1e-17, 21]; Q4.3 "
                         "saturation would destroy it)")
    popcount = bool(popcount_sign) and kind != "sum-product"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    plan = DecodePlan.from_code(code)
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if plan.dmax_cn > _ARGMIN_LIMIT[store]:
        raise NotImplementedError(
            f"check degree {plan.dmax_cn} exceeds the exact integer range "
            f"of the {store} argmin plane ({_ARGMIN_LIMIT[store]})")
    alpha = float(alpha) if kind == "normalized-min-sum" else 0.0
    beta = float(beta) if kind == "offset-min-sum" else 0.0
    if dep_stride and dev.type == "cuda":
        barrier_lowers(dev)
    if dev.type == "cuda":
        smem = smem_bytes(plan, kind, store, schedule, popcount)
        if smem > _MAX_SMEM:
            raise NotImplementedError(
                f"one word's {kind} {schedule} state in {store} ({smem} "
                "bytes) exceeds a block's shared memory")
        tables = torch.as_tensor(kernel_tables(plan), device=dev)
    else:
        ref_tables = _RefTables(plan, dev)
    reference = (layered_reference if schedule == "layered"
                 else flooding_reference)

    def decode_counts(llr: torch.Tensor):
        if llr.device != dev:
            raise ValueError(f"llr is on {llr.device}, decoder on {dev}")
        if llr.dtype != torch.float32:
            raise TypeError(f"llr must be float32, got {llr.dtype}")
        if llr.ndim != 2 or llr.shape[1] != plan.n:
            raise ValueError(f"llr must be [B, {plan.n}], got "
                             f"{tuple(llr.shape)}")
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        if dev.type == "cpu":
            return reference(llr, plan, max_iters, kind=kind,
                             store_dtype=store, alpha=alpha, beta=beta,
                             popcount_sign=popcount, tables=ref_tables)
        return _launch(llr, plan, tables, max_iters, kind, store, schedule,
                       popcount, alpha, beta)

    decode_counts.plan = plan
    return decode_counts


def static_decode_counts(code: QCCode, llr: torch.Tensor,
                         max_iters: int = 50, **kw):
    """One-shot convenience wrapper, on ``llr``'s device."""
    return make_static_sweep_decoder(code, max_iters, device=llr.device,
                                     **kw)(llr)
