#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds; any failure exits non-zero with
no result line:

1. card    the card's name and power limit (nvidia-smi) and torch's view.
2. build   nvcc builds ldpc_tpu_torch/csrc/decode.cu, split.cu,
           barrier_probe.cu and microbench.cu, one process each, all
           started together (ptxas report); phi's float32 operations are
           counted from its SASS (ldpc_tpu_torch/scripts/phi_sass.py) for
           the sum-product bounds.
3. kernel  min-sum bf16 (the near-earth main path's variant) against its
           plain PyTorch version on the same LLRs: 2,048 words at 3.0 and
           3.4 dB (50 iterations) and the main path's own shapes (32,768
           words at 12 and at 50 iterations).  Converged words must agree
           exactly; times with CUDA events.  The staged cascade must equal
           a straight 50-iteration decode.
4. main    near-earth (8176, 7154), B = 32,768, 3.0/3.2/3.4/3.6 dB, the
           12 -> 50 staged cascade, one warm and three timed batches a point:
           decoded bit/s, BER, FER, iterations, cascade branch, launches.
5. band    FER at 3.0 and 3.4 dB: the 95% Wilson interval must overlap the
           JAX package's measured one.
6. profile one more batch at 3.0 and 3.4 dB under torch.profiler: device
           time by kernel, device busy share.
7. variants every (kind, store) of the kernel against its plain version on
           the same LLRs, 50 iterations: 802.11n rate 1/2 and 5/6 (2,048
           words each, in each one's waterfall), near-earth (512 words,
           timed: the largest state a block holds) and a code with check
           degree > 32 (1,024 words); then each variant's time at the
           evaluate path's shape (32,768 802.11n rate-5/6 words, 12
           iterations) beside its plain version's and its bound.
8. evaluate the evaluate entry point on the card (ldpc_tpu_torch.cli and
           evaluate_code, engine "cuda", staged 12 -> 50, 32,768 words a
           point in one batch): (a) `bench wifi`; (b) the sum-product
           waterfall with f32 state, FER held against the JAX package's;
           (c) normalized and offset min-sum, bf16 state; (d) the other
           (kind, store) pairs once each.
9. torch   the torch engine: `probe` on near-earth against the kernel with
           f32 state (exact), and a 1,024-word 802.11n rate-1/2 decode on the
           card against the same decode on the CPU (exact) and against the
           kernel (reported).
10. new    the layered schedule (B3), int8 Q4.3 state (B5) and the popcount
           sign (B6): (a) near-earth layered bf16, 6 -> 50, and (b) int8,
           12 -> 50, at the main path's protocol (one warm and three timed
           batches a point), FER at 3.0 and 3.4 dB held to the JAX package's
           intervals; (c) popcount on the main path's own LLRs (its
           generator states replayed), every word equal to the stored-sign
           decode; (d) each of the 30 new variants against its plain version
           (near-earth 2,048 words at 3.0 and 3.4 dB, 802.11n rates 1/2 and
           5/6 2,048 each, the d_c > 32 code 1,024; 50 iterations) and timed
           (the three main-path variants at their near-earth stage-1 shape,
           the rest at 32,768 802.11n rate-5/6 words, 12 iterations);
           (e) `cli evaluate --code wifi --engine cuda --schedule layered
           --store-dtype int8`; (f) every new variant once through
           evaluate_code.
11. split  the phase-split pair (B7, csrc/split.cu) and the barrier probe
           (B8): (a) ldpc_tpu_torch.scripts.split_ab at the JAX package's
           protocol (near-earth, 16,384 words, 10 iterations, 3.4 dB, 4
           trials), bf16 then f32, word-exact to the fused kernel; (b) the
           split kernels against their plain version and the fused kernel,
           near-earth 2,048 words at 3.0 and 3.4 dB, 50 iterations, bf16 and
           f32, every word; (c) the main path's stage-1 shape (32,768 words,
           12 iterations, 3.4 dB): split against fused, median of 7 calls;
           split_r and split_c alone, each held against its plain version on
           the same state; host reads; bounds; global bytes a word; (d) the
           giant path: synthetic_qc_code(2048, 8, 24), refused by the fused
           kernel, 4,096 words at 4.0 dB, 8 iterations, through the split
           pair (bit/s, iterations, FER), and 1,024 words at 1.1 dB, where
           words fail, against the plain version; (e) the main path's 3.4 dB
           batches again through a dep_stride=4 cascade (the barrier probe
           runs as it is built), every word equal, and barrier_lowers().
12. microbench the kernel microbenchmark (B9, csrc/microbench.cu): (a) each
           of the 7 probes against its plain version at K = 1 and 7, on one
           tile and on the card-filling count of tiles: every element of the
           final buffers equal, the sums within SUM_RTOL; the fused
           kernel at each of the script's decoder shapes (128 and 32,768
           near-earth words at 0 dB, 40 iterations, bf16 and f32: the
           script's first trial's words) against its plain version, every
           word; (b) ldpc_tpu_torch.scripts.kernel_microbench --quick (the
           probes' slopes at one tile and at the card-filling count, and
           the fused kernel's per-iteration slopes at 128 and 32,768 words,
           bf16 and f32); (c) each probe timed at the card-filling count,
           K = 1,000, beside its plain version, its bound and its
           shared-memory bound.
13. the kernels line, the card line again, and the result line.

Every driven path (the main path, each evaluate run of phases 8 and 10,
each near-earth path of phase 10, the split A/B, the giant path and the
dep_stride replay of phase 11, and the microbench script of phase 12) clears the launch counts just before it
and reads them just after; a row of the kernels line gives the launches of
the path meant to drive it (`path`, `launches`) and those of every path
that ran it (`launches_by_path`), and the run fails if that path launched
it no time.  Launches that compare a kernel with its plain version, or time
it, are counted on no path.

Imports torch, numpy and ldpc_tpu_torch only; the machine with the card has
no JAX.  Writes nothing but the kernel build (ldpc_tpu_torch/_build/).
"""

from __future__ import annotations

import collections
import json
import re
import sys
import time
import traceback

import numpy as np
import torch

from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import (QCCode, near_earth_code,
                                  synthetic_qc_code, wifi_code)
from ldpc_tpu_torch.ops import cuda_split, cuda_static, microbench
from ldpc_tpu_torch.ops.cuda_split import (SplitState,
                                           make_split_sweep_decoder,
                                           split_c_reference,
                                           split_r_reference,
                                           split_reference, state_bytes)
from ldpc_tpu_torch.ops.plan import DecodePlan
from ldpc_tpu_torch.ops.cuda_static import (KINDS, STORES,
                                            barrier_lowers, barrier_probe,
                                            flooding_reference,
                                            layered_reference,
                                            make_static_sweep_decoder)
from ldpc_tpu_torch.sim.channel import epsilon_probe
from ldpc_tpu_torch.sim.evaluate import (StagedDecoder,
                                         default_redo_capacity,
                                         evaluate_code,
                                         make_staged_decoder_device,
                                         make_staged_sweep_device, transmit)
from ldpc_tpu_torch.scripts import kernel_microbench, phi_sass, split_ab
from ldpc_tpu_torch.sim.stats import BerStatistics, wilson_interval
from ldpc_tpu_torch.utils.device import device_info
from ldpc_tpu_torch.utils.profiling import (F32_OPS_PER_S, HBM_BYTES_PER_S,
                                            smi_query, time_ms, timed_once)

T0 = time.perf_counter()

# The main path: the JAX package's bench protocol (bench.py).
BATCH = 32768
SNR_POINTS = (3.0, 3.2, 3.4, 3.6)
MAX_ITERS = 50
PHASE1_ITERS = 12
REDO_CAP = 3 * BATCH // 16   # the bench protocol's capacity (bench.py)
TIMED_BATCHES = 3
KERNEL_REPS = 7         # timed calls of a kernel (median)
CHECK_WORDS = 2048
CHECK_SNRS = (3.0, 3.4)
PROFILE_SNRS = (3.0, 3.4)
SEED = 20261017
BUDGET_S = 600          # half the 1200 s limit of a chip run

# FER and 95% Wilson interval of the JAX package's Pallas bf16 kernel,
# docs/ber_parity.json (16,384 words per point), points "3.0000", "3.4000".
JAX_FER = {3.0: (0.86767578125, 0.8624009517018465, 0.8727782313822761),
           3.4: (0.02288818359375, 0.02070762656167772, 0.025292427527202416)}

# Phase 7: words and SNR (dB) of each check, in each code's waterfall
# (802.11n: sum-product's waterfall lies lower than the min-sum family's).
VARIANT_WORDS = {"wifi": 2048, "near-earth": 512, "highdeg": 1024}
VARIANT_SNR = {("r1/2", False): -1.5, ("r1/2", True): -2.0,
               ("r5/6", False): 2.5, ("r5/6", True): 2.25,
               ("near-earth", False): 3.0, ("near-earth", True): 2.6,
               ("highdeg", False): 3.0, ("highdeg", True): 3.0}
SP_MISMATCH_LIMIT = 1e-3   # sum-product: mismatched words / words checked
TIMING_SNR = {False: 3.0, True: 2.5}   # the evaluate path's shape, r5/6
TORCH_WORDS = 1024          # phase 9: 802.11n rate-1/2 words

# Phase 8b: FER of the JAX package's Pallas sum-product kernel, f32 state,
# 8,192 words a point, and its 95% Wilson interval: docs/wifi_waterfall.json
# ("rates" -> rate -> point), computed from its "fer" and "words".
JAX_SP_FER = {(2 / 3, 0.0): (0.25806, 0.24870, 0.26764),
              (3 / 4, 1.0): (0.34888, 0.33863, 0.35927),
              (5 / 6, 2.0): (0.64001, 0.62956, 0.65034),
              (5 / 6, 2.5): (0.05334, 0.04868, 0.05842)}
WIFI_SEED = 460101          # wifiCUDA.testWifi's seed (cli bench wifi)

# Phase 10.  The near-earth paths of B3 and B5, at the main path's protocol.
LAYERED_PHASE1 = 6          # scripts/layered_ab.py "layered-p6"
# FER and 95% Wilson interval of the JAX package's Pallas kernel, 32,768
# words a point: layered-p6 bf16 (docs/layered_ab.json, "results" ->
# "layered-p6" -> "fer", "fer_ci95") and int8 12 -> 50
# (docs/quantized_ber.json, "stores" -> "int8", from "fer" and "words").
JAX_LAYERED_FER = {
    3.0: (0.850311279296875, 0.8464073128479274, 0.8541331169581291),
    3.4: (0.018218994140625, 0.016826346850762793, 0.019724592660674365)}
JAX_INT8_FER = {
    3.0: (0.947601318359375, 0.9451357622135991, 0.9499619403936682),
    3.4: (0.067962646484375, 0.06528792550197096, 0.07073865281594793)}
# (code, SNR dB, words) of each kernel check of the new variants
NEW_CHECKS = (("near-earth", 3.0, 2048), ("near-earth", 3.4, 2048),
              ("r1/2", -1.5, 2048), ("r5/6", 2.5, 2048),
              ("highdeg", 3.0, 1024))
MINSUM = KINDS[:3]
FLOAT_STORES = ("bfloat16", "float32")   # phase 7's stores (B1, B2, B4)
# the variants of B3, B5 and B6: (kind, store, schedule, popcount_sign)
NEW_VARIANTS = [(k, s, sched, pc) for k in MINSUM for s in STORES
                for sched in ("flooding", "layered") for pc in (False, True)
                if (sched, pc) != ("flooding", False) or s == "int8"]
# the variant of each near-earth path of phase 10, and its stage-1 budget
NEW_MAIN = {("min-sum", "bfloat16", "layered", False): LAYERED_PHASE1,
            ("min-sum", "int8", "flooding", False): PHASE1_ITERS,
            ("min-sum", "bfloat16", "flooding", True): PHASE1_ITERS}
# The driven paths, and the launches each read just after it ran.
MAIN_PATH = "near-earth main"
NEW_PATHS = {("min-sum", "bfloat16", "layered", False): "near-earth layered",
             ("min-sum", "int8", "flooding", False): "near-earth int8",
             ("min-sum", "bfloat16", "flooding", True):
                 "near-earth popcount replay"}
CLI_PATH = "evaluate (e) cli layered int8"
SPLIT_PATH = "split A/B"
GIANT_PATH = "giant synthetic"
DEP_PATH = "near-earth dep_stride"
PATH_LAUNCHES: dict[str, dict] = {}

# Phase 11.  (a) the JAX package's split A/B protocol (scripts/split_ab.py
# defaults): near-earth, 16,384 words, 10 iterations, 3.4 dB, 4 trials.
SPLIT_AB_ARGS = ["--code", "near-earth", "--batch", "16384", "--mi", "10",
                 "--snr", "3.4", "--trials", "4"]
SPLIT_STORES = ("bfloat16", "float32")
# (d) the giant code and scripts/giant_code.py's --snr-db and --iters;
# 1.1 dB is an SNR where words fail within 8 iterations
GIANT = dict(z=2048, block_rows=8, block_cols=24, col_weight=3, seed=0)
GIANT_WORDS = 4096
GIANT_SNR = 4.0
GIANT_ITERS = 8
GIANT_CHECK_WORDS = 1024
GIANT_FAIL_SNR = 1.1
DEP_STRIDE = 4
PLAIN_CHUNK = 4096       # words per plain launch version (its memory peak)

# Phase 12.  (a) K values of the checks, and the sums' tolerance relative
# to the sum of |values| of a tile, that of the CPU tests against JAX: the
# two sums differ only in order, and a sequential sum of a tile differs
# from a tree's by about 1e-5 of it (JAX's sum against torch's at K = 3:
# 169,457.53 against 169,455.77, tests/test_torch_microbench.py)
MB_CHECK_K = (1, 7)
SUM_RTOL = 1e-4
MB_ROW_K = 1000          # (c) the rows' K: the quick slope's first K
MB_PATH = "microbench"
MB_ARGS = ["--quick"]

# The bounds use the H100's peaks of ldpc_tpu_torch/utils/profiling.py:
# operations over the float32 peak, which counts a fused multiply-add as 2
# and every other float32 operation as 1, as the counts below do.
# float32 operations per Tanner edge and iteration, (phase A, phase B).
# min-sum: phase A 8 (old c2v: select, sign; v = t - c2v; |v|; two-min
# compare, m2 min, m1 min; sign test), phase B 3 (select, sign, add);
# normalized adds one multiply and offset a subtract and a max wherever a
# message is rebuilt.  Sum-product: phase A 14 plus 2 phi (the rebuild:
# sub, 2 clip, mul, neg, sign, mul; v: sub; |v|, 2 clip, mul, neg; S add;
# sign test), phase B 8 plus 1 phi.  One phi is the float32 operations of
# the SASS that csrc/decode.cu's phi compiles to (an FFMA 2; what runs for
# some arguments only left out), counted by ldpc_tpu_torch/scripts/phi_sass.py:
# phase 2 counts them on the card's toolkit, and the bounds use that count.
def sum_product_ops(phi_ops: int) -> tuple[int, int]:
    return (14 + 2 * phi_ops, 8 + phi_ops)


OPS = {"min-sum": (8, 3), "normalized-min-sum": (9, 4),
       "offset-min-sum": (10, 5), "sum-product": None}
# Layered (pallas layered_body), per edge: the syndrome pass 1 (sign test)
# in every sweep; in a sweep that updates, the row update as flooding phase
# A (8) and the delta: two rebuilt messages (select, sign; +1 normalized,
# +2 offset, each), a subtract and an add (6).  popcount_sign and the int8
# store change no per-edge count (the fold is per check; converts are not
# counted, as for bf16).
OPS_LAYERED = {"min-sum": (1, 8 + 6), "normalized-min-sum": (1, 9 + 8),
               "offset-min-sum": (1, 10 + 10)}

SOURCE = "ldpc_tpu_torch/csrc/decode.cu"
SPLIT_SOURCE = "ldpc_tpu_torch/csrc/split.cu"
PROBE_SOURCE = "ldpc_tpu_torch/csrc/barrier_probe.cu"
TPU_SPLIT = {"r": ("ldpc_tpu/ops/pallas_split.py:204",
                   "B7 ldpc_tpu/ops/pallas_split.py:83 kernel_r (phase A + "
                   "latches)"),
             "c": ("ldpc_tpu/ops/pallas_split.py:226",
                   "B7 ldpc_tpu/ops/pallas_split.py:158 kernel_c (phase B)")}
TPU_PROBE = ("ldpc_tpu/ops/pallas_static.py:142",
             "B8 ldpc_tpu/ops/pallas_static.py:128 _barrier_lowers probe")
TPU_CALL = "ldpc_tpu/ops/pallas_static.py:621"
MB_SOURCE = "ldpc_tpu_torch/csrc/microbench.cu"
TPU_MB = ("scripts/kernel_microbench.py:63",
          "B9 scripts/kernel_microbench.py:46 _build_probe")
TPU_NEW = {"layered": "B3 ldpc_tpu/ops/pallas_static.py:566-599 layered_body",
           "int8": "B5 ldpc_tpu/ops/pallas_static.py:195-223 _st/_ld/_st_raw",
           "popcount": "B6 ldpc_tpu/ops/pallas_static.py:364-377 "
                       "_sign_from_bits"}
TPU_KERNEL = {
    "min-sum": "B1 ldpc_tpu/ops/pallas_static.py:170 _build_kernel "
               "(flooding, min-sum)",
    "normalized-min-sum": "B2 ldpc_tpu/ops/pallas_static.py:344-362 _recon "
                          "(normalized)",
    "offset-min-sum": "B2 ldpc_tpu/ops/pallas_static.py:344-362 _recon "
                      "(offset)",
    "sum-product": "B4 ldpc_tpu/ops/pallas_static.py:379-428 _phi, "
                   "_recon_sp, _row_pass_sp"}


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {phase}: {msg}", flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smi_line() -> str:
    return ", ".join(smi_query("name", "power.limit"))


def llr_batch(code: QCCode, b: int, snr: float, gen: torch.Generator, dev,
              scale_llr: bool = False) -> torch.Tensor:
    snr_db = torch.full((b,), snr, dtype=torch.float32, device=dev)
    return transmit(code.n, snr_db, generator=gen, scale_llr=scale_llr)[0]


def key(kind: str, store: str, schedule: str = "flooding",
        popcount: bool = False) -> tuple:
    """The launch counter's key of a kernel variant."""
    return (kind, store, schedule, popcount)


def clear_launches() -> None:
    """Zero every kernel's launch count, just before a path runs."""
    cuda_static.launches.clear()
    cuda_split.launches.clear()
    microbench.launches.clear()


def record_path(path: str) -> dict:
    """The launch counts of the path just run (cleared just before it), kept
    under its name for the kernels line."""
    got = {**cuda_static.launches, **cuda_split.launches,
           **{("microbench", n): c for n, c in microbench.launches.items()}}
    PATH_LAUNCHES[path] = got
    return got


def variant_name(kind, store, schedule="flooding", popcount=False) -> str:
    return f"{schedule}[{kind},{store}{',popcount' if popcount else ''}]"


def bound_ms(b: int, n: int, edges: int, iters, success, max_iters: int,
             kind: str = "min-sum",
             schedule: str = "flooding") -> tuple[float, str]:
    """Least time for this work on an H100: bytes (LLRs in, 12 B a word out)
    over HBM rate vs the f32 operations these words needed over peak."""
    ops_a, ops_b = (OPS_LAYERED if schedule == "layered" else OPS)[kind]
    it = iters.long().cpu()
    phase_a = torch.where(success.cpu(), it + 1,
                          torch.full_like(it, max_iters + 1))
    ops = edges * (ops_a * phase_a.sum().item() +
                   ops_b * (phase_a - 1).sum().item())
    t_bytes = (b * n * 4 + b * 12) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(kern, plain) -> dict:
    """Kernel vs plain outputs: mismatched converged words (either side
    converged), mismatched words overall, max |difference|."""
    (ek, ik, sk), (ep, ip, sp) = kern, plain
    diff = (ek != ep) | (ik != ip) | (sk != sp)
    conv = sk | sp
    err = max(int((ek.long() - ep.long()).abs().max()),
              int((ik.long() - ip.long()).abs().max()),
              int((sk.long() - sp.long()).abs().max()))
    return {"mismatched_converged": int((diff & conv).sum()),
            "mismatched": int(diff.sum()), "max_abs_err": err}


def high_degree_code() -> QCCode:
    """Check degree 40-50 (> 32, two sign words per check): the code of
    tests/test_pallas_static.py::test_static_kernel_high_degree_checks."""
    rng = np.random.default_rng(11)
    z, nb = 9, 20
    row = tuple(tuple(sorted(rng.choice(z, size=int(rng.integers(2, 4)),
                                        replace=False).tolist()))
                for _ in range(nb))
    return QCCode(z=z, shifts=(row,), name="highdeg")


def phase_card(dev) -> str:
    smi = smi_line()
    print(smi, flush=True)
    info = device_info()
    log("card", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; {info['name']} {info['capability']}, "
        f"{info['count']} visible")
    return smi


def phase_build() -> dict:
    from ldpc_tpu_torch.csrc import build, build_report
    sources = ("decode", "split", "barrier_probe", "microbench")
    build(*sources)
    reps = {}
    for name in sources:
        rep = reps[name] = build_report(name)
        ptxas = rep["ptxas"]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill", ptxas)]
        stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame",
                                            ptxas)]
        log("build", f"{name}.cu built in {rep['seconds']:.1f} s (cached: "
            f"{rep['cached']}); ptxas: "
            f"{ptxas.count('Compiling entry function')} kernel instances, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers a "
            f"thread, {sum(spills)} bytes of spills, largest stack frame "
            f"{max(stack, default=0)} bytes")
    phi = phi_sass.count()
    OPS["sum-product"] = sum_product_ops(phi["flops"])
    log("build", f"phi: {phi['flops']} float32 operations for every "
        f"argument ({phi['predicated_flops']} more predicated, for some; "
        f"{phi['instructions']} SASS instructions; {phi['nvcc']}): "
        f"{phi['by_opcode']}")
    return reps


def phase_kernel(dev, code, gen) -> dict:
    plan = make_static_sweep_decoder(code, MAX_ITERS, device=dev).plan
    edges = code.num_edges
    worst = {"mismatched_converged": 0, "mismatched": 0, "max_abs_err": 0}
    cases = [(f"{CHECK_WORDS} words {snr} dB {MAX_ITERS} it", CHECK_WORDS,
              snr, MAX_ITERS) for snr in CHECK_SNRS]
    cases += [(f"{BATCH} words 3.4 dB {PHASE1_ITERS} it (stage 1)", BATCH,
               3.4, PHASE1_ITERS),
              (f"{BATCH} words 3.0 dB {MAX_ITERS} it (stage 2, many)", BATCH,
               3.0, MAX_ITERS)]
    timing = {}
    for label, b, snr, max_iters in cases:
        llr = llr_batch(code, b, snr, gen, dev)
        dec = make_static_sweep_decoder(code, max_iters, device=dev)
        kern = dec(llr)
        plain = flooding_reference(llr, plan, max_iters)
        sync(dev)
        c = compare(kern, plain)
        for k in worst:
            worst[k] = max(worst[k], c[k])
        log("kernel", f"{label}: {c['mismatched_converged']} mismatched "
            f"converged words, {c['mismatched']} mismatched in all, "
            f"converged {int(kern[2].sum())}/{b}")
        if c["mismatched_converged"]:
            raise AssertionError(f"{label}: kernel and plain version differ "
                                 f"on {c['mismatched_converged']} converged "
                                 "words")
        if b == BATCH:
            ms = time_ms(lambda: dec(llr), dev, reps=KERNEL_REPS)
            _, plain_ms = timed_once(lambda: flooding_reference(
                llr, plan, max_iters), dev)
            bnd, by = bound_ms(b, code.n, edges, kern[1], kern[2], max_iters)
            timing[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                             "bound_by": by}
            log("kernel", f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.1f}"
                f" ms, bound {bnd:.3f} ms ({by})")
    # the cascade equals a straight max_iters decode, word for word
    staged = make_staged_decoder_device(code, MAX_ITERS,
                                        phase1_iters=PHASE1_ITERS,
                                        redo_capacity=CHECK_WORDS * 3 // 16,
                                        engine="cuda", device=dev)
    single = make_static_sweep_decoder(code, MAX_ITERS, device=dev)
    for snr in CHECK_SNRS:
        llr = llr_batch(code, CHECK_WORDS, snr, gen, dev)
        got, want = staged(llr), single(llr)
        if any(not torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"staged cascade != single pass at {snr} dB")
        log("kernel", f"staged == single pass at {snr} dB "
            f"(branch {staged.last_branches})")
    stage1 = timing[cases[2][0]]
    return {"worst": worst, "timing": timing, "stage1": stage1,
            "smem": cuda_static.smem_bytes(plan)}


def drive_sweep(dev, code, step, tag: str, path: str) -> dict:
    """One warm and TIMED_BATCHES timed batches of BATCH words a point
    through a staged sweep, with the launch counts cleared just before and
    read just after (kept as ``path``): decoded bit/s, BER, FER,
    iterations, cascade branch, launches, and each batch's outputs and
    generator state (to replay its LLRs)."""
    timed = TIMED_BATCHES
    stats = BerStatistics(code.n)
    points = {}
    clear_launches()
    for snr in SNR_POINTS:
        before = sum(cuda_static.launches.values())
        snr_db = torch.full((BATCH,), snr, dtype=torch.float32, device=dev)
        outs, secs, branches, states = [], [], [], []
        for t in range(1 + timed):
            states.append(step.generator.get_state())
            t0 = time.perf_counter()
            out = step(snr_db)
            sync(dev)
            if t:
                secs.append(time.perf_counter() - t0)
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
            branches.append(step.decoder.last_branches[0])
        for o in outs:
            check_outputs(o, code.n)
            stats.add_batch(np.full(BATCH, snr), o["sigma"], o["sigma_actual"],
                            o["errors_uncoded"], o["errors_decoded"],
                            o["iterations"], MAX_ITERS, o["success"])
        med = float(np.median(secs))
        words = BATCH * len(outs)
        fe = sum(int(((o["errors_decoded"] > 0) | ~o["success"]).sum())
                 for o in outs)
        errs = sum(int(o["errors_decoded"].sum()) for o in outs)
        iters = sum(int(o["iterations"].sum()) for o in outs)
        points[snr] = {"bit_per_s": BATCH * code.n / med, "median_s": med,
                       "ber": errs / (words * code.n), "fer": fe / words,
                       "frame_errors": fe, "words": words,
                       "avg_iterations": iters / words,
                       "branches": branches,
                       "launches": sum(cuda_static.launches.values()) - before,
                       "outs": outs, "states": states}
        p = points[snr]
        log(tag, f"{snr} dB: {p['bit_per_s']:.6g} bit/s (median "
            f"{med * 1e3:.2f} ms of {timed}), BER {p['ber']:.4e}, "
            f"FER {p['fer']:.5f}, avg iters {p['avg_iterations']:.3f}, "
            f"branch {branches}, launches {p['launches']}")
    launches = record_path(path)
    if any(p["launches"] == 0 for p in points.values()):
        raise AssertionError(f"{tag}: a point ran without the kernel "
                             f"({launches})")
    return {"points": points, "launches": launches, "stats": stats}


def phase_main(dev, code, gen) -> dict:
    step = make_staged_sweep_device(code, MAX_ITERS, phase1_iters=PHASE1_ITERS,
                                    redo_capacity=REDO_CAP, engine="cuda",
                                    device=dev, generator=gen)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = drive_sweep(dev, code, step, "main", MAIN_PATH)
    launches = out["launches"]
    if launches.get(key("min-sum", "bfloat16"), 0) == 0:
        raise AssertionError(f"main path launched {launches}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log("main", f"kernel launches {launches}; "
        f"max_memory_allocated {peak} bytes")
    return {**out, "max_memory_allocated": peak, "step": step}


def phase_profile(dev, step, tag: str = "profile") -> None:
    """One more batch at 3.0 and 3.4 dB under torch.profiler: device time
    by kernel and the device's busy share of the batch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for snr in PROFILE_SNRS:
        snr_db = torch.full((BATCH,), snr, dtype=torch.float32, device=dev)
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(snr_db)
            sync(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                row = by_name.setdefault(e.name, [0, 0.0])
                row[0] += 1
                row[1] += e.time_range.elapsed_us()
        if not by_name:
            log(tag, f"{snr} dB: the profiler saw no device events; "
                "device time not measured")
            continue
        busy = sum(t for _, t in by_name.values())
        log(tag, f"{snr} dB: batch {wall_us / 1e3:.2f} ms wall under "
            f"the profiler, device busy {busy / 1e3:.2f} ms "
            f"({100 * busy / wall_us:.1f}%)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (count, t) in top:
            log(tag, f"{snr} dB:   {t / 1e3:9.3f} ms  {count:3d}x  "
                f"{name[:90]}")


def check_outputs(o: dict, n: int) -> None:
    for k, v in o.items():
        if v.shape != (BATCH,):
            raise AssertionError(f"{k}: shape {v.shape}")
    if not (np.isfinite(o["sigma"]).all() and np.isfinite(o["sigma_actual"]).all()):
        raise AssertionError("non-finite sigma")
    if not ((0 <= o["iterations"]).all() and (o["iterations"] <= MAX_ITERS).all()):
        raise AssertionError("iterations out of range")
    if not ((0 <= o["errors_decoded"]).all() and (o["errors_decoded"] <= n).all()):
        raise AssertionError("errors out of range")


def phase_band(points: dict, jax_fer: dict = JAX_FER,
               tag: str = "band") -> None:
    for snr, (fer, lo, hi) in jax_fer.items():
        p = points[snr]
        q, qlo, qhi = wilson_interval(p["frame_errors"], p["words"])
        overlap = qlo <= hi and lo <= qhi
        log(tag, f"{snr} dB: port FER {q:.5f} [{qlo:.5f}, {qhi:.5f}] "
            f"({p['words']} words) vs JAX {fer:.5f} [{lo:.5f}, {hi:.5f}]: "
            f"{'overlap' if overlap else 'NO OVERLAP'}")
        if not overlap:
            raise AssertionError(f"{tag}: FER at {snr} dB outside the JAX "
                                 "band")


def phase_variants(dev, gen) -> dict:
    """Every (kind, store) against its plain version; then each one's time
    at the evaluate path's shape."""
    codes = {"r1/2": wifi_code(1944, 1 / 2), "r5/6": wifi_code(1944, 5 / 6),
             "near-earth": near_earth_code(), "highdeg": high_degree_code()}
    out = {}
    for kind in KINDS:
        sp = kind == "sum-product"
        for store in FLOAT_STORES:
            row = {"checked": 0, "mismatched": 0, "mismatched_converged": 0,
                   "max_abs_err": 0}
            for cname, code in codes.items():
                b = VARIANT_WORDS["wifi" if cname[0] == "r" else cname]
                snr = VARIANT_SNR[(cname, sp)]
                llr = llr_batch(code, b, snr, gen, dev, scale_llr=sp)
                dec = make_static_sweep_decoder(code, MAX_ITERS, kind=kind,
                                                store_dtype=store,
                                                device=dev)
                kern = dec(llr)
                plain = flooding_reference(llr, dec.plan, MAX_ITERS,
                                           kind=kind, store_dtype=store)
                sync(dev)
                c = compare(kern, plain)
                row["checked"] += b
                for k in ("mismatched", "mismatched_converged"):
                    row[k] += c[k]
                row["max_abs_err"] = max(row["max_abs_err"], c["max_abs_err"])
                extra = ""
                if cname == "near-earth":   # the largest state per block
                    row["near_earth_ms"] = time_ms(lambda: dec(llr), dev)
                    extra = (f"; kernel {row['near_earth_ms']:.3f} ms, "
                             f"{cuda_static.smem_bytes(dec.plan, kind, store)}"
                             " bytes of shared memory a block")
                log("variants", f"{kind}/{store} {cname} {b} words {snr} dB: "
                    f"{c['mismatched']} mismatched words, "
                    f"{c['mismatched_converged']} converged, converged "
                    f"{int(kern[2].sum())}/{b}{extra}")
            # time at the evaluate path's first stage: 32,768 rate-5/6 words
            code = codes["r5/6"]
            llr = llr_batch(code, BATCH, TIMING_SNR[sp], gen, dev,
                            scale_llr=sp)
            dec = make_static_sweep_decoder(code, PHASE1_ITERS, kind=kind,
                                            store_dtype=store, device=dev)
            ms = time_ms(lambda: dec(llr), dev, reps=KERNEL_REPS)
            kern = dec(llr)
            plain, plain_ms = timed_once(
                lambda: flooding_reference(llr, dec.plan, PHASE1_ITERS,
                                           kind=kind, store_dtype=store), dev)
            c = compare(kern, plain)
            row["checked"] += BATCH
            for k in ("mismatched", "mismatched_converged"):
                row[k] += c[k]
            row["max_abs_err"] = max(row["max_abs_err"], c["max_abs_err"])
            bnd, by = bound_ms(BATCH, code.n, code.num_edges, kern[1],
                               kern[2], PHASE1_ITERS, kind)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                       smem=cuda_static.smem_bytes(dec.plan, kind, store),
                       shape=f"{BATCH} words x {code.n} (802.11n r5/6), "
                             f"{PHASE1_ITERS} iterations, "
                             f"{TIMING_SNR[sp]} dB")
            log("variants", f"{kind}/{store}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.1f} ms, bound {bnd:.4f} ms ({by}) at "
                f"{row['shape']}; {row['mismatched']} mismatched of "
                f"{row['checked']} words checked")
            limit = SP_MISMATCH_LIMIT * row["checked"] if sp else 0
            if row["mismatched_converged"] > limit or (
                    sp and row["mismatched"] > limit):
                raise AssertionError(
                    f"{kind}/{store}: {row['mismatched']} words differ "
                    f"({row['mismatched_converged']} converged) of "
                    f"{row['checked']}")
            out[(kind, store)] = row
    return out


def _point_report(stats: BerStatistics, code: QCCode, snr: float,
                  seconds: float) -> dict:
    """bit/s, BER, FER and its Wilson interval, average iterations, and
    the cascade branch of the point's batch (from its per-word counts)."""
    sel = stats.column("snr") == snr
    words = int(stats.column("weight")[sel].sum())
    errs = int(stats.column("errors_decoded")[sel].sum())
    fe = int(stats.column("frame_errors")[sel].sum())
    it = stats.column("iterations")[sel]
    ok = stats.column("success")[sel].astype(bool)
    nfail = int((~(ok & (it <= PHASE1_ITERS))).sum())
    cap = default_redo_capacity(words)
    branch = "none" if nfail == 0 else "few" if nfail <= cap else "many"
    fer, lo, hi = wilson_interval(fe, words)
    return {"bit_per_s": words * code.n / seconds, "seconds": seconds,
            "ber": errs / (words * code.n), "fer": fer, "fer_lo": lo,
            "fer_hi": hi, "words": words,
            "avg_iterations": float(it.mean()), "branch": branch,
            "stage1_failures": nfail}


def _log_point(tag: str, snr: float, p: dict) -> None:
    log("evaluate", f"{tag} {snr} dB: {p['bit_per_s']:.6g} bit/s "
        f"({p['seconds'] * 1e3:.1f} ms), BER {p['ber']:.4e}, FER "
        f"{p['fer']:.5f} [{p['fer_lo']:.5f}, {p['fer_hi']:.5f}], avg iters "
        f"{p['avg_iterations']:.3f}, branch {p['branch']} "
        f"({p['stage1_failures']} stage-1 failures)")


def _sweep(dev, code, snrs, **kw):
    """One evaluate_code call per point (so each point is timed alone);
    returns the statistics and the per-point reports."""
    stats = BerStatistics(code.n)
    reports = {}
    for snr in snrs:
        sync(dev)
        t0 = time.perf_counter()
        evaluate_code(code, [snr], BATCH, MAX_ITERS, batch_size=BATCH,
                      staged=True, phase1_iters=PHASE1_ITERS, engine="cuda",
                      stats=stats, device=dev, **kw)
        sync(dev)
        reports[snr] = _point_report(stats, code, snr,
                                     time.perf_counter() - t0)
    return stats, reports


def phase_evaluate(dev) -> dict:
    out = {}
    # (a) the reference's wifi preset through the CLI's own function
    clear_launches()
    bench = run_cli(dev, ["bench", "wifi", "--transmissions", str(BATCH),
                          "--batch-size", str(BATCH), "--engine", "cuda"])
    got = record_path("evaluate (a) bench wifi")
    log("evaluate", f"(a) bench wifi: status {bench['status']!r}, "
        f"{bench['throughput_bit_per_s']:.6g} bit/s over {bench['seconds']:.2f}"
        f" s, BER {bench['ber']}; launches {got}")
    if got.get(key("min-sum", "bfloat16"), 0) == 0:
        raise AssertionError("bench wifi ran without the kernel")
    out["bench_wifi"] = bench
    # (b) the sum-product waterfall, f32 state, true LLRs
    clear_launches()
    by_rate = collections.defaultdict(list)
    for rate, snr in JAX_SP_FER:
        by_rate[rate].append(snr)
    sp_points = {}
    for rate, snrs in by_rate.items():
        code = wifi_code(1944, rate)
        _, reps = _sweep(dev, code, snrs, kind="sum-product", scale_llr=True,
                         store_dtype="float32", seed=WIFI_SEED)
        for snr, p in reps.items():
            _log_point(f"(b) sum-product f32 r{rate:.4f}", snr, p)
            jfer, jlo, jhi = JAX_SP_FER[(rate, snr)]
            overlap = p["fer_lo"] <= jhi and jlo <= p["fer_hi"]
            log("evaluate", f"(b) r{rate:.4f} {snr} dB: port FER "
                f"[{p['fer_lo']:.5f}, {p['fer_hi']:.5f}] vs JAX {jfer:.5f} "
                f"[{jlo:.5f}, {jhi:.5f}]: "
                f"{'overlap' if overlap else 'NO OVERLAP'}")
            if not overlap:
                raise AssertionError(f"sum-product FER at rate {rate:.4f}, "
                                     f"{snr} dB outside the JAX band")
            sp_points[f"{rate:.4f}@{snr}"] = p
    got = record_path("evaluate (b) sum-product waterfall")
    log("evaluate", f"(b) launches {got}")
    if got.get(key("sum-product", "float32"), 0) == 0:
        raise AssertionError("the sum-product sweep ran without the kernel")
    out["sum_product"] = sp_points
    # (c) normalized and offset min-sum, bf16 state, rate 5/6 at 3.0 dB
    code = wifi_code(1944, 5 / 6)
    for kind in ("normalized-min-sum", "offset-min-sum"):
        clear_launches()
        _, reps = _sweep(dev, code, [3.0], kind=kind,
                         store_dtype="bfloat16", seed=WIFI_SEED)
        got = record_path(f"evaluate (c) {kind}/bfloat16")
        _log_point(f"(c) {kind} bf16 r5/6", 3.0, reps[3.0])
        log("evaluate", f"(c) {kind}: launches {got}")
        if got.get(key(kind, "bfloat16"), 0) == 0:
            raise AssertionError(f"{kind} sweep ran without the kernel")
        out[kind] = reps[3.0]
    # (d) the other (kind, store) pairs once each through the same path
    for kind, store, snr in (("min-sum", "float32", 3.0),
                             ("normalized-min-sum", "float32", 3.0),
                             ("offset-min-sum", "float32", 3.0),
                             ("sum-product", "bfloat16", 2.5)):
        sp = kind == "sum-product"
        clear_launches()
        _, reps = _sweep(dev, code, [snr], kind=kind, scale_llr=sp,
                         store_dtype=store, seed=WIFI_SEED)
        got = record_path(f"evaluate (d) {kind}/{store}")
        _log_point(f"(d) {kind} {store} r5/6", snr, reps[snr])
        if got.get(key(kind, store), 0) == 0:
            raise AssertionError(f"{kind}/{store} sweep ran without the "
                                 "kernel")
        out[f"{kind}/{store}"] = reps[snr]
    return out


def run_cli(dev, argv):
    """One command of ``python -m ldpc_tpu_torch.cli``, in this process.
    The CLI runs on the card; a rehearsal on the CPU sets
    LDPC_TPU_PLATFORM=cpu for the call, as a user would."""
    import os
    args = cli.build_parser().parse_args(argv)
    if dev.type == "cuda":
        return args.fn(args)
    os.environ["LDPC_TPU_PLATFORM"] = dev.type
    try:
        return args.fn(args)
    finally:
        del os.environ["LDPC_TPU_PLATFORM"]


def phase_torch(dev, gen) -> dict:
    """The torch engine against the kernel, kind min-sum, f32 state."""
    probe = run_cli(dev, ["probe"])
    code = near_earth_code()
    vec = epsilon_probe(code.n, flips=(0,), epsilon=1e-2, device=dev)
    e, it, ok = make_static_sweep_decoder(code, MAX_ITERS, store_dtype="float32",
                                          device=dev)(vec)
    kern = {"errors_decoded": int(e[0]), "iterations": int(it[0]),
            "success": bool(ok[0])}
    log("torch", f"probe (near-earth, eps 1e-2, flip 0): torch engine "
        f"{probe}, kernel f32 {kern}")
    if any(probe[k] != kern[k] for k in kern):
        raise AssertionError("probe: torch engine and kernel differ")
    # 1,024 words in the rate-1/2 waterfall: the torch engine on the card
    # must equal itself on the CPU word for word (and, by the CPU tests, the
    # JAX XLA engine).  Against the kernel it differs as the JAX package's
    # XLA engine differs from its Pallas kernel: the variable sums round in
    # another order (XLA: chan + (0 + sum); Pallas: -chan + each message),
    # so a word on the edge of convergence may go either way.  Reported.
    code = wifi_code(1944, 1 / 2)
    llr = llr_batch(code, TORCH_WORDS, VARIANT_SNR[("r1/2", False)], gen,
                    dev)
    torch_dec = make_staged_decoder_device(code, MAX_ITERS, phase1_iters=[],
                                           engine="torch", device=dev)
    kern_dec = make_static_sweep_decoder(code, MAX_ITERS,
                                         store_dtype="float32", device=dev)
    got, torch_ms = timed_once(lambda: torch_dec(llr), dev)
    want = kern_dec(llr)
    kern_ms = time_ms(lambda: kern_dec(llr), dev, reps=3)
    on_cpu = make_staged_decoder_device(code, MAX_ITERS, phase1_iters=[],
                                        engine="torch", device="cpu")(
                                            llr.cpu())
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, on_cpu))
    c = compare(got, want)
    both = int(((got[0] != want[0]) | (got[1] != want[1]))[
        got[2] & want[2]].sum())
    log("torch", f"802.11n r1/2, {TORCH_WORDS} words, min-sum: torch engine "
        f"{torch_ms:.1f} ms on the card, kernel f32 {kern_ms:.3f} ms; torch "
        f"engine card == CPU on every word: {same}; against the kernel "
        f"{c['mismatched_converged']} mismatched words converged on either "
        f"side ({both} on both, {c['mismatched']} in all), converged "
        f"{int(got[2].sum())} (torch) and {int(want[2].sum())} (kernel) of "
        f"{TORCH_WORDS}")
    if not same:
        raise AssertionError("the torch engine differs on the card and on "
                             "the CPU")
    return {"probe": probe, "torch_ms": torch_ms, "kernel_ms": kern_ms,
            "both_converged_mismatch": both, **c}


def phase_new_paths(dev, code, gen, main: dict) -> None:
    """(a) layered 6 -> 50 and (b) int8 12 -> 50 on near-earth at the main
    path's protocol, FER held to the JAX intervals; (c) popcount on the
    main path's own LLRs, every word equal to the stored-sign decode."""
    for tag, phase1, kw, band in (
            ("layered", LAYERED_PHASE1, dict(schedule="layered"),
             JAX_LAYERED_FER),
            ("int8", PHASE1_ITERS, dict(store_dtype="int8"), JAX_INT8_FER)):
        step = make_staged_sweep_device(code, MAX_ITERS, phase1_iters=[phase1],
                                        redo_capacity=REDO_CAP, engine="cuda",
                                        device=dev, generator=gen, **kw)
        k = key("min-sum", kw.get("store_dtype", "bfloat16"),
                kw.get("schedule", "flooding"))
        res = drive_sweep(dev, code, step, f"10{tag}", NEW_PATHS[k])
        if res["launches"].get(k, 0) == 0:
            raise AssertionError(f"the {tag} path launched {res['launches']}")
        phase_band(res["points"], band, f"10{tag}")
        phase_profile(dev, step, f"10{tag}")
    # (c) replay each batch of the main path: same generator state, same
    # LLRs; the popcount decode must give every word's outputs again
    pop = StagedDecoder(code, MAX_ITERS, phase1_iters=PHASE1_ITERS,
                        redo_capacity=REDO_CAP, engine="cuda",
                        popcount_sign=True, device=dev)
    g = torch.Generator(device=dev)
    clear_launches()
    words = 0
    for snr, p in main["points"].items():
        snr_db = torch.full((BATCH,), snr, dtype=torch.float32, device=dev)
        for state, o in zip(p["states"], p["outs"]):
            g.set_state(state)
            llr, _, _, unc = transmit(code.n, snr_db, generator=g)
            if not np.array_equal(unc.cpu().numpy(), o["errors_uncoded"]):
                raise AssertionError("popcount: the replayed LLRs differ")
            got = [x.cpu().numpy() for x in pop(llr)]
            want = (o["errors_decoded"], o["iterations"], o["success"])
            bad = sum(int((a != b).sum()) for a, b in zip(got, want))
            if bad:
                raise AssertionError(f"popcount at {snr} dB: {bad} outputs "
                                     "differ from the stored-sign decode")
            words += BATCH
    launches = record_path(NEW_PATHS[key("min-sum", "bfloat16", "flooding",
                                         True)])
    log("10popcount", f"{words} words of the main path decoded again with "
        f"popcount_sign: all equal to the stored-sign decode; launches "
        f"{launches}")
    if launches.get(key("min-sum", "bfloat16", "flooding", True), 0) == 0:
        raise AssertionError(f"the popcount path launched {launches}")


def phase_new_variants(dev, gen) -> dict:
    """Each new variant against its plain version on the same LLRs (50
    iterations), then timed beside its plain version and its bound."""
    codes = {"r1/2": wifi_code(1944, 1 / 2), "r5/6": wifi_code(1944, 5 / 6),
             "near-earth": near_earth_code(), "highdeg": high_degree_code()}
    checks = [(cname, snr, llr_batch(codes[cname], b, snr, gen, dev))
              for cname, snr, b in NEW_CHECKS]
    out = {}
    for kind, store, sched, pc in NEW_VARIANTS:
        name = variant_name(kind, store, sched, pc)
        ref = layered_reference if sched == "layered" else flooding_reference
        opts = dict(kind=kind, store_dtype=store, popcount_sign=pc)
        row = {"checked": 0, "mismatched": 0, "mismatched_converged": 0,
               "max_abs_err": 0}

        def check(code, llr, max_iters, kern=None):
            dec = make_static_sweep_decoder(code, max_iters, schedule=sched,
                                            device=dev, **opts)
            kern = dec(llr) if kern is None else kern
            plain = ref(llr, dec.plan, max_iters, **opts)
            sync(dev)
            c = compare(kern, plain)
            row["checked"] += llr.shape[0]
            for k in ("mismatched", "mismatched_converged"):
                row[k] += c[k]
            row["max_abs_err"] = max(row["max_abs_err"], c["max_abs_err"])
            return dec, kern

        for cname, snr, llr in checks:
            check(codes[cname], llr, MAX_ITERS)
        # time: a near-earth path's own stage-1 shape, else the evaluate
        # path's (32,768 802.11n rate-5/6 words, 12 iterations, 3.0 dB)
        main_it = NEW_MAIN.get((kind, store, sched, pc))
        cname, it, snr = (("near-earth", main_it, 3.4) if main_it
                          else ("r5/6", PHASE1_ITERS, 3.0))
        code = codes[cname]
        llr = llr_batch(code, BATCH, snr, gen, dev)
        dec = make_static_sweep_decoder(code, it, schedule=sched, device=dev,
                                        **opts)
        ms = time_ms(lambda: dec(llr), dev, reps=KERNEL_REPS)
        kern = dec(llr)
        _, plain_ms = timed_once(lambda: ref(llr, dec.plan, it, **opts), dev)
        check(code, llr, it, kern)
        bnd, by = bound_ms(BATCH, code.n, code.num_edges, kern[1], kern[2],
                           it, kind, sched)
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                   smem=cuda_static.smem_bytes(dec.plan, kind, store, sched,
                                               pc),
                   shape=f"{BATCH} words x {code.n} ({cname}), {it} "
                         f"iterations, {snr} dB")
        log("10variants", f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.1f} "
            f"ms, bound {bnd:.4f} ms ({by}) at {row['shape']}, {row['smem']} "
            f"bytes of shared memory; {row['mismatched']} mismatched "
            f"({row['mismatched_converged']} converged) of {row['checked']} "
            "words checked")
        if row["mismatched_converged"]:
            raise AssertionError(f"{name}: {row['mismatched_converged']} "
                                 "converged words differ from the plain "
                                 "version")
        out[(kind, store, sched, pc)] = row
    return out


def phase_new_evaluate(dev) -> None:
    """(e) the CLI's evaluate with layered + int8 on 802.11n; (f) every new
    variant once through evaluate_code (rate 5/6, 3.0 dB, 12 -> 50)."""
    clear_launches()
    st = run_cli(dev, ["evaluate", "--code", "wifi", "--engine", "cuda",
                       "--schedule", "layered", "--store-dtype", "int8",
                       "--transmissions", str(BATCH), "--batch-size",
                       str(BATCH)])
    got = record_path(CLI_PATH)
    log("10evaluate", f"(e) cli evaluate wifi layered int8: "
        f"{json.dumps(st.summary())}; launches {got}")
    if got.get(key("min-sum", "int8", "layered"), 0) == 0:
        raise AssertionError("cli evaluate layered int8 ran without the "
                             "kernel")
    code = wifi_code(1944, 5 / 6)
    for kind, store, sched, pc in NEW_VARIANTS:
        clear_launches()
        _, reps = _sweep(dev, code, [3.0], kind=kind, store_dtype=store,
                         schedule=sched, popcount_sign=pc, seed=WIFI_SEED)
        got = record_path(f"evaluate (f) {variant_name(kind, store, sched, pc)}")
        _log_point(f"(f) {variant_name(kind, store, sched, pc)} r5/6", 3.0,
                   reps[3.0])
        if got.get(key(kind, store, sched, pc), 0) == 0:
            raise AssertionError(f"{variant_name(kind, store, sched, pc)} "
                                 "sweep ran without the kernel")


def _slice_state(s: SplitState, lo: int, hi: int) -> SplitState:
    return SplitState(**{f: getattr(s, f)[lo:hi]
                         for f in SplitState.__dataclass_fields__})


def _plain_launch(fn, s: SplitState, *args) -> SplitState:
    """A plain launch version over PLAIN_CHUNK words at a time (its
    gathered [words, m, dc] temporaries are the memory peak)."""
    parts = [fn(_slice_state(s, lo, lo + PLAIN_CHUNK), *args)
             for lo in range(0, s.tot.shape[0], PLAIN_CHUNK)]
    return SplitState(**{f: torch.cat([getattr(x, f) for x in parts])
                         for f in SplitState.__dataclass_fields__})


def _state_err(got: SplitState, want: SplitState, names) -> float:
    """Max |kernel - plain| over the named planes (0 when all equal)."""
    return max(float((getattr(got, n).double() -
                      getattr(want, n).double()).abs().max())
               for n in names)


def split_bound(plan, store: str, live_r: int, live_c: int,
                batch: int) -> tuple[float, str]:
    """Least time on an H100 for ``live_r`` words' split_r work and
    ``live_c`` words' split_c work of ``batch`` words: the bytes each moves
    (state_bytes; each launch reads every word's success flag) over the HBM
    rate vs 8 (phase A) and 3 (phase B) f32 operations per edge and live
    word over peak."""
    sb = state_bytes(plan, store)
    edges = int(plan.cn_valid.sum()) * plan.z
    n_launch = (live_r > 0) + (live_c > 0)
    t_bytes = ((live_r * sb["split_r"] + live_c * sb["split_c"] +
                4 * batch * n_launch) / HBM_BYTES_PER_S * 1e3)
    t_ops = edges * (OPS["min-sum"][0] * live_r +
                     OPS["min-sum"][1] * live_c) / F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_split(dev, code, gen) -> dict:
    """(a) the split A/B; (b) split vs plain vs fused, every word; (c) the
    stage-1 shape: times, launches alone against their plain versions,
    bounds.  Returns the kernels line's split rows and the numbers."""
    out = {"rows": {}}
    # (a) the A/B script at the JAX protocol, bf16 then f32
    clear_launches()
    for store in SPLIT_STORES:
        summ = split_ab.main(SPLIT_AB_ARGS + ["--store", store])
        log("11split", f"(a) split_ab {store}: word_exact "
            f"{summ['word_exact']}, best ms {summ['best_ms']}, median ms "
            f"{summ['median_ms']}, split/mono "
            f"{1 / summ['speedup_split_vs_mono']:.3f}x, host reads "
            f"{summ['split_host_reads']}")
        if not summ["word_exact"]:
            raise AssertionError(f"split_ab {store}: not word-exact")
        out[f"ab_{store}"] = summ
    got = record_path(SPLIT_PATH)
    for store in SPLIT_STORES:
        if any(got.get((k, store), 0) == 0 for k in ("split_r", "split_c")):
            raise AssertionError(f"split A/B {store} launched {got}")
    plan = DecodePlan.from_code(code)
    for store in SPLIT_STORES:
        row = {"checked": 0, "mismatched": 0, "max_abs_err": 0}
        # (b) every word equal to the plain version and the fused kernel
        for snr in CHECK_SNRS:
            llr = llr_batch(code, CHECK_WORDS, snr, gen, dev)
            split = make_split_sweep_decoder(code, MAX_ITERS,
                                             store_dtype=store, device=dev)
            kern = split(llr)
            plain = split_reference(llr, plan, MAX_ITERS, store)
            mono = make_static_sweep_decoder(code, MAX_ITERS,
                                             store_dtype=store,
                                             device=dev)(llr)
            sync(dev)
            c, cm = compare(kern, plain), compare(kern, mono)
            row["checked"] += CHECK_WORDS
            row["mismatched"] += c["mismatched"] + cm["mismatched"]
            row["max_abs_err"] = max(row["max_abs_err"], c["max_abs_err"],
                                     cm["max_abs_err"])
            log("11split", f"(b) {store} {CHECK_WORDS} words {snr} dB "
                f"{MAX_ITERS} it: {c['mismatched']} words differ from the "
                f"plain version, {cm['mismatched']} from the fused kernel; "
                f"converged {int(kern[2].sum())}/{CHECK_WORDS}, host reads "
                f"{split.host_reads}")
            if c["mismatched"] or cm["mismatched"]:
                raise AssertionError(f"split {store} at {snr} dB differs")
        # (c) the main path's stage-1 shape
        llr = llr_batch(code, BATCH, 3.4, gen, dev)
        split = make_split_sweep_decoder(code, PHASE1_ITERS,
                                         store_dtype=store, device=dev)
        mono = make_static_sweep_decoder(code, PHASE1_ITERS,
                                         store_dtype=store, device=dev)
        kern, want = split(llr), mono(llr)
        reads = split.host_reads
        sync(dev)
        cm = compare(kern, want)
        row["checked"] += BATCH
        row["mismatched"] += cm["mismatched"]
        if cm["mismatched"]:
            raise AssertionError(f"split {store} stage 1 differs from the "
                                 f"fused kernel on {cm['mismatched']} words")
        split_ms = time_ms(lambda: split(llr), dev, reps=KERNEL_REPS)
        mono_ms = time_ms(lambda: mono(llr), dev, reps=KERNEL_REPS)
        it = kern[1].long()
        ok = kern[2]
        live_r = int(torch.where(ok, it + 1, PHASE1_ITERS + 1).sum())
        live_c = int(torch.where(ok, it, PHASE1_ITERS).sum())
        dec_bnd, dec_by = split_bound(plan, store, live_r, live_c, BATCH)
        sb = state_bytes(plan, store)
        log("11split", f"(c) {store} stage 1 ({BATCH} words, "
            f"{PHASE1_ITERS} it, 3.4 dB): split {split_ms:.3f} ms vs fused "
            f"{mono_ms:.3f} ms ({split_ms / mono_ms:.3f}x), {reads} host "
            f"reads; bound {dec_bnd:.4f} ms ({dec_by}; {live_r} split_r and "
            f"{live_c} split_c word-launches); {sb['word']} global bytes a "
            "word")
        # each kernel alone, against its plain version on the same state
        t = cuda_static._RefTables(plan, dev)
        tables = torch.as_tensor(cuda_static.kernel_tables(plan), device=dev)
        n_ok = torch.zeros(PHASE1_ITERS + 1, dtype=torch.int32, device=dev)
        st = SplitState.start(llr, plan, PHASE1_ITERS, store)
        errs = {}
        plain_r, plain_ms_r = timed_once(
            lambda: _plain_launch(split_r_reference, st, t, 0), dev)
        cuda_split.launch("r", st, plan, tables, n_ok, 0)
        sync(dev)
        errs["r"] = _state_err(st, plain_r, ("m1", "m2", "am", "sp", "bits",
                                             "errors", "iters", "success"))
        plain_c, plain_ms_c = timed_once(
            lambda: _plain_launch(split_c_reference, st, t), dev)
        cuda_split.launch("c", st, plan, tables, n_ok)
        sync(dev)
        errs["c"] = _state_err(st, plain_c, ("tot",))
        ms = {"r": time_ms(lambda: cuda_split.launch("r", st, plan, tables,
                                                     n_ok, 0),
                           dev, reps=KERNEL_REPS),
              "c": time_ms(lambda: cuda_split.launch("c", st, plan, tables,
                                                     n_ok),
                           dev, reps=KERNEL_REPS)}
        live = int((st.success == 0).sum())
        for k, plain_ms in (("r", plain_ms_r), ("c", plain_ms_c)):
            bnd, by = split_bound(plan, store, live if k == "r" else 0,
                                  live if k == "c" else 0, BATCH)
            log("11split", f"(c) split_{k} {store} alone: {ms[k]:.4f} ms, "
                f"plain {plain_ms:.1f} ms, bound {bnd:.4f} ms ({by}; {live} "
                f"live words, {sb['split_' + k]} bytes each), max |kernel - "
                f"plain| {errs[k]}")
            if errs[k]:
                raise AssertionError(f"split_{k} {store} differs from its "
                                     "plain version")
            out["rows"][(k, store)] = {
                "ms": ms[k], "plain_ms": plain_ms, "bound_ms": bnd,
                "bound_by": by, "max_abs_err": max(errs[k],
                                                   row["max_abs_err"]),
                "mismatched_words": row["mismatched"],
                "words_checked": row["checked"],
                "global_bytes_per_word": sb["word"],
                "bytes_per_live_word": sb["split_" + k],
                "shape": f"{BATCH} words x {code.n} (near-earth), one launch,"
                         f" {live} live words, 3.4 dB"}
        out[f"stage1_{store}"] = {
            "split_ms": split_ms, "mono_ms": mono_ms, "host_reads": reads,
            "bound_ms": dec_bnd, "bound_by": dec_by}
    return out


def phase_giant(dev, gen) -> dict:
    """(d) a code the fused kernel refuses, through the split pair: bit/s,
    iterations, FER; and held against the plain version where words
    fail."""
    giant = synthetic_qc_code(GIANT["z"], GIANT["block_rows"],
                              GIANT["block_cols"],
                              col_weight=GIANT["col_weight"],
                              seed=GIANT["seed"])
    if dev.type == "cuda":
        try:
            make_static_sweep_decoder(giant, GIANT_ITERS, device=dev)
        except NotImplementedError as e:
            log("11giant", f"the fused kernel refuses {giant.name}: {e}")
        else:
            raise AssertionError(f"the fused kernel took {giant.name}")
    clear_launches()
    dec = make_split_sweep_decoder(giant, GIANT_ITERS, device=dev)
    secs, outs = [], []
    for k in range(1 + TIMED_BATCHES):
        llr = llr_batch(giant, GIANT_WORDS, GIANT_SNR, gen, dev)
        sync(dev)
        t0 = time.perf_counter()
        res = dec(llr)
        sync(dev)
        if k:
            secs.append(time.perf_counter() - t0)
            outs.append(res)
    got = record_path(GIANT_PATH)
    if got.get(("split_r", "bfloat16"), 0) == 0:
        raise AssertionError(f"the giant path launched {got}")
    del llr
    words = GIANT_WORDS * len(outs)
    med = float(np.median(secs))
    fe = sum(int(((e > 0) | ~ok).sum()) for e, _, ok in outs)
    avg_it = sum(int(i.sum()) for _, i, _ in outs) / words
    g = {"name": giant.name, "n": giant.n,
         "bit_per_s": GIANT_WORDS * giant.n / med, "median_s": med,
         "fer": fe / words, "avg_iterations": avg_it,
         "global_bytes_per_word": state_bytes(dec.plan)["word"],
         "host_reads": dec.host_reads}
    log("11giant", f"{giant.name} (n {giant.n}), {GIANT_WORDS} words, "
        f"{GIANT_SNR} dB, {GIANT_ITERS} it: {g['bit_per_s']:.6g} bit/s "
        f"(median {med * 1e3:.2f} ms of {TIMED_BATCHES}), avg iters "
        f"{avg_it:.3f}, FER {g['fer']:.5f}, {g['global_bytes_per_word']} "
        f"global bytes a word, {g['host_reads']} host reads; launches {got}")
    llr = llr_batch(giant, GIANT_CHECK_WORDS, GIANT_FAIL_SNR, gen, dev)
    kern = dec(llr)
    plain = split_reference(llr, dec.plan, GIANT_ITERS, chunk=128)
    sync(dev)
    c = compare(kern, plain)
    failed = int((~kern[2]).sum())
    log("11giant", f"{GIANT_CHECK_WORDS} words at {GIANT_FAIL_SNR} dB: "
        f"{c['mismatched']} differ from the plain version; {failed} failed "
        "words")
    if c["mismatched"] or failed == 0:
        raise AssertionError(f"giant check: {c['mismatched']} mismatched, "
                             f"{failed} failed words")
    g["check_failed_words"] = failed
    g["check_words"] = GIANT_CHECK_WORDS
    return g


def phase_dep_stride(dev, code, main: dict) -> dict:
    """(e) the main path's 3.4 dB batches (generator states replayed)
    through a dep_stride cascade, every word equal; the barrier probe, run
    as the cascade is built, against its plain version.  Returns the
    probe's row."""
    clear_launches()
    dep = StagedDecoder(code, MAX_ITERS, phase1_iters=PHASE1_ITERS,
                        redo_capacity=REDO_CAP, engine="cuda",
                        dep_stride=DEP_STRIDE, device=dev)
    gen_replay = torch.Generator(device=dev)
    p = main["points"][3.4]
    snr_db = torch.full((BATCH,), 3.4, dtype=torch.float32, device=dev)
    for state, o in zip(p["states"], p["outs"]):
        gen_replay.set_state(state)
        llr, _, _, unc = transmit(code.n, snr_db, generator=gen_replay)
        if not np.array_equal(unc.cpu().numpy(), o["errors_uncoded"]):
            raise AssertionError("dep_stride: the replayed LLRs differ")
        got = [x.cpu().numpy() for x in dep(llr)]
        want = (o["errors_decoded"], o["iterations"], o["success"])
        bad = sum(int((a != b).sum()) for a, b in zip(got, want))
        if bad:
            raise AssertionError(f"dep_stride={DEP_STRIDE}: {bad} outputs "
                                 "differ from the main path's")
    got = record_path(DEP_PATH)
    lowers = barrier_lowers(dev)
    log("11dep", f"{BATCH * len(p['outs'])} words of the main path at 3.4 "
        f"dB decoded again with dep_stride={DEP_STRIDE}: all equal; "
        f"barrier_lowers() {lowers}; launches {got}")
    if got.get("barrier_probe", 0) == 0 or not lowers:
        raise AssertionError(f"dep_stride path: probe launches {got}, "
                             f"barrier_lowers {lowers}")
    x = torch.from_numpy(np.linspace(-1.0, 1.0, 8 * 128, dtype=np.float32)
                         .reshape(8, 128)).to(dev)
    err = float((barrier_probe(x) - (x + x.abs())).abs().max())
    ms = time_ms(lambda: barrier_probe(x), dev, reps=KERNEL_REPS)
    plain_ms = time_ms(lambda: x + x.abs(), dev, reps=KERNEL_REPS)
    t_bytes = 2 * 4 * x.numel() / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * x.numel() / F32_OPS_PER_S * 1e3
    probe = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "shape": "[8, 128] float32"}
    log("11dep", f"barrier_probe [8, 128]: {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {max(t_bytes, t_ops):.3g} ms, max |kernel - plain| "
        f"{err}")
    if err:
        raise AssertionError("barrier_probe differs from x + |x|")
    return probe


def phase_microbench(dev) -> dict:
    """(a) each probe against its plain version; (b) the probe script's
    quick run, the driving path; (c) each probe timed beside its plain
    version and its bounds.  Returns the kernels line's rows' numbers."""
    rows = {}
    for name in microbench.NAMES:
        _, n_bufs, r, dtype = microbench.PROBES[name]
        fill = microbench.fill_tiles(name, dev)
        row = rows[name] = {"tiles": fill, "max_abs_err": 0.0,
                            "sum_rel_err": 0.0}
        for tiles in (1, fill):
            for k in MB_CHECK_K:
                x = microbench.input_tile(n_bufs, r, dtype, k, tiles, dev)
                ks, kb = microbench.probe(name, x, k)
                ps, pb = microbench.probe_reference(name, x, k)
                sync(dev)
                err = float((kb.float() - pb.float()).abs().max())
                scale = pb[:, 0].float().abs().sum(dim=(-2, -1))
                rel = float(((ks - ps).abs() / scale).max())
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["sum_rel_err"] = max(row["sum_rel_err"], rel)
                if not torch.equal(kb, pb) or rel > SUM_RTOL:
                    raise AssertionError(
                        f"microbench {name}, {tiles} tiles, K {k}: buffers "
                        f"differ by {err}, sums by {rel:.3g} of the sum of "
                        "|values|")
        log("12microbench", f"(a) {name}: buffers equal to the plain "
            f"version at K {MB_CHECK_K} on 1 and {fill} tiles; sums within "
            f"{row['sum_rel_err']:.3g} of the sum of |values|")
    # the fused kernel at the script's decoder shapes, every word
    code = near_earth_code()
    plan = DecodePlan.from_code(code)
    mi = max(kernel_microbench.DECODER_ITERS)
    for store in kernel_microbench.DECODER_STORES:
        for words in kernel_microbench.DECODER_WORDS:
            llr = kernel_microbench.decoder_input(words, mi, 0, dev)
            kern = make_static_sweep_decoder(code, mi, store_dtype=store,
                                             device=dev)(llr)
            plain = flooding_reference(llr, plan, mi, store_dtype=store)
            sync(dev)
            c = compare(kern, plain)
            log("12microbench", f"(a) fused {store}, {words} words 0 dB {mi} "
                f"it: {c['mismatched']} words differ from the plain "
                f"version, converged {int(kern[2].sum())}/{words}")
            if c["mismatched"]:
                raise AssertionError(f"fused {store} at {words} words, 0 dB: "
                                     f"{c['mismatched']} words differ from "
                                     "the plain version")
    clear_launches()
    res = kernel_microbench.main(MB_ARGS)
    got = record_path(MB_PATH)
    missing = [n for n in microbench.NAMES if not got.get(("microbench", n))]
    missing += [s for s in ("bfloat16", "float32")
                if not got.get(key("min-sum", s))]
    if missing:
        raise AssertionError(f"the microbench script did not launch "
                             f"{missing}: {got}")
    for n in microbench.NAMES:
        log("12microbench", f"(b) {n}: {res[n]:.3f} ns a run on 1 tile, "
            f"{res['fill'][n]['ns']:.3f} ns on {res['fill'][n]['tiles']} "
            f"({res['fill'][n]['ps_per_element']:.4f} ps an element)")
    for k, us in res.items():
        if k.startswith("decoder_us_per_iter_"):
            log("12microbench", f"(b) {k}: {us:.3f} us an iteration")
    log("12microbench", f"(b) op-count model: {json.dumps(res['model'])}; "
        f"launches {got}")
    smem_rate = res.get("smem_bytes_per_s")
    for name in microbench.NAMES:
        _, n_bufs, r, dtype = microbench.PROBES[name]
        row = rows[name]
        tiles = row["tiles"]
        x = microbench.input_tile(n_bufs, r, dtype, 0, tiles, dev)
        ms = time_ms(lambda: microbench.probe(name, x, MB_ROW_K), dev,
                     reps=KERNEL_REPS)
        _, plain_ms = timed_once(
            lambda: microbench.probe_reference(name, x, MB_ROW_K), dev)
        elems = tiles * r * microbench.LANES
        t_bytes = (2 * x.numel() * x.element_size() + 4 * tiles) / \
            HBM_BYTES_PER_S * 1e3
        t_ops = (microbench.OPS_PER_ELEMENT[name] * MB_ROW_K * elems /
                 F32_OPS_PER_S * 1e3)
        smem = microbench.SMEM_BYTES_PER_ELEMENT[name] * MB_ROW_K * elems
        row.update(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            smem_bytes_moved=smem,
            smem_bound_ms=smem / smem_rate * 1e3 if smem_rate else None,
            slope_ns_one_tile=res[name], slope_ns_fill=res["fill"][name]["ns"],
            ps_per_element_fill=res["fill"][name]["ps_per_element"],
            shape=f"[{tiles}, {n_bufs}, {r}, 128] {str(dtype)[6:]}, K "
                  f"{MB_ROW_K}")
        log("12microbench", f"(c) {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), shared-memory bound "
            f"{row['smem_bound_ms']} ms at {row['shape']}")
    return {"rows": rows, "script": res}


def launch_row(path: str, k) -> dict:
    """A row's launches: on the path meant to drive it, and on every path
    that ran it."""
    return {"path": path, "launches": PATH_LAUNCHES.get(path, {}).get(k, 0),
            "launches_by_path": {p: c[k] for p, c in PATH_LAUNCHES.items()
                                 if c.get(k)}}


def driving_path(kind, store, schedule="flooding", popcount=False) -> str:
    """The path of this run that is meant to drive a variant."""
    k = key(kind, store, schedule, popcount)
    if k == key("min-sum", "bfloat16"):
        return MAIN_PATH
    if k in NEW_PATHS:
        return NEW_PATHS[k]
    if k == key("min-sum", "int8", "layered"):
        return CLI_PATH
    if schedule != "flooding" or popcount or store == "int8":
        return f"evaluate (f) {variant_name(*k)}"
    if kind == "sum-product" and store == "float32":
        return "evaluate (b) sum-product waterfall"
    if store == "bfloat16" and kind != "sum-product":
        return f"evaluate (c) {kind}/bfloat16"
    return f"evaluate (d) {kind}/{store}"


def path_launches(kind, store, schedule="flooding", popcount=False) -> dict:
    """The launches of a variant of the fused kernel (launch_row)."""
    k = key(kind, store, schedule, popcount)
    return launch_row(driving_path(*k), k)


def run(dev: torch.device) -> dict:
    PATH_LAUNCHES.clear()
    code = near_earth_code()
    smi = phase_card(dev) if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        phase_build()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kern = phase_kernel(dev, code, gen)
    main = phase_main(dev, code, gen)
    phase_band(main["points"])
    phase_profile(dev, main["step"])
    variants = phase_variants(dev, gen)
    phase_evaluate(dev)
    phase_torch(dev, gen)
    phase_new_paths(dev, code, gen, main)
    new_variants = phase_new_variants(dev, gen)
    phase_new_evaluate(dev)
    split = phase_split(dev, code, gen)
    split["giant"] = phase_giant(dev, gen)
    split["probe"] = phase_dep_stride(dev, code, main)
    mb = phase_microbench(dev)
    st = kern["stage1"]
    rows = []
    for (kind, store), v in variants.items():
        main_shape = (kind, store) == ("min-sum", "bfloat16")
        t = st if main_shape else v
        rows.append({
            "name": f"flooding[{kind},{store}]", "route": "cuda",
            "source": SOURCE, "replaces": TPU_CALL,
            "tpu_kernel": TPU_KERNEL[kind] + f", {store} store",
            **path_launches(kind, store),
            "max_abs_err": max(v["max_abs_err"],
                               kern["worst"]["max_abs_err"] if main_shape
                               else 0),
            "mismatched_words": v["mismatched"],
            "words_checked": v["checked"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "smem_bytes": kern["smem"] if main_shape else v["smem"],
            "near_earth_ms": v["near_earth_ms"],
            "shape": (f"{BATCH} words x {code.n} (near-earth), "
                      f"{PHASE1_ITERS} iterations, 3.4 dB") if main_shape
            else v["shape"],
        })
    for (kind, store, sched, pc), v in new_variants.items():
        parts = [TPU_KERNEL[kind]] + [TPU_NEW[x] for x, on in (
            ("layered", sched == "layered"), ("int8", store == "int8"),
            ("popcount", pc)) if on]
        rows.append({
            "name": variant_name(kind, store, sched, pc), "route": "cuda",
            "source": SOURCE, "replaces": TPU_CALL,
            "tpu_kernel": "; ".join(parts) + f", {store} store",
            **path_launches(kind, store, sched, pc),
            "max_abs_err": v["max_abs_err"],
            "mismatched_words": v["mismatched"],
            "words_checked": v["checked"],
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "smem_bytes": v["smem"], "shape": v["shape"],
        })
    for (k, store), v in split["rows"].items():
        replaces, tpu = TPU_SPLIT[k]
        rows.append({
            "name": f"split_{k}[min-sum,{store}]", "route": "cuda",
            "source": SPLIT_SOURCE, "replaces": replaces,
            "tpu_kernel": f"{tpu}, {store} store",
            **launch_row(SPLIT_PATH, (f"split_{k}", store)),
            "library_ms": None, **v})
    rows.append({
        "name": "barrier_probe", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": TPU_PROBE[0], "tpu_kernel": TPU_PROBE[1],
        **launch_row(DEP_PATH, "barrier_probe"), "library_ms": None,
        **split["probe"]})
    for name, v in mb["rows"].items():
        rows.append({
            "name": f"microbench[{name}]", "route": "cuda",
            "source": MB_SOURCE, "replaces": TPU_MB[0],
            "tpu_kernel": f"{TPU_MB[1]}, body {name}",
            **launch_row(MB_PATH, ("microbench", name)), "library_ms": None,
            **v})
    missing = [(r["name"], r["path"]) for r in rows if r["launches"] == 0]
    if missing:
        raise AssertionError(f"no launch on the driving path: {missing}")
    kernels = {"kernels": rows}
    print(json.dumps(kernels), flush=True)
    return {"smi": smi, "kernels": kernels, "main": main, "split": split,
            "microbench": mb}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and does not run on the CPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        run(dev)
        elapsed = time.perf_counter() - T0
        log("done", f"{elapsed:.1f} s in all (budget {BUDGET_S} s)")
        if elapsed > BUDGET_S:
            raise AssertionError(f"took {elapsed:.0f} s, over {BUDGET_S} s")
        print(smi_line(), flush=True)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
