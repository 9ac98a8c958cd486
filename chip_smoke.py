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
           the sum-product bounds; the flooding edge loops of B1 and the
           layered ones of B3 (bf16 and f32) are counted from theirs
           (ldpc_tpu_torch/scripts/edge_sass.py, compiled beside the
           build): shared-memory instructions an edge (B3: an edge-sweep);
           those of the int8 instance (B5) and the sum-product ones (B4,
           per phase: instructions, shared-memory instructions and phi an
           edge), beside the recorded counts of decode.cu before their
           redesign (DECODE_PARENT_SASS, not measured in the run);
           and the edge loops of the split pair, B7 (edge_sass.py --split:
           instructions, shared and global loads an edge of split_r's fold
           and split_c's sum, bf16 and f32), beside the recorded counts of
           split.cu before its redesign (SPLIT_PARENT_SASS, not measured in
           the run).
3. kernel  min-sum bf16 (the near-earth main path's variant) against its
           plain PyTorch version on the same LLRs: 2,048 words at 3.0 and
           3.4 dB (50 iterations) and the main path's own shapes (32,768
           words at 12 and at 50 iterations).  Every word must agree
           exactly, converged or not; times with CUDA events.  The staged
           cascade must equal a straight 50-iteration decode.
4. main    near-earth (8176, 7154), B = 32,768, 3.0/3.2/3.4/3.6 dB, the
           12 -> 50 staged cascade, one warm and three timed batches a point:
           decoded bit/s, BER, FER, iterations, cascade branch, launches.
5. band    FER at 3.0 and 3.4 dB: the 95% Wilson interval must overlap the
           JAX package's measured one.
6. profile one more batch at 3.0 and 3.4 dB under torch.profiler: device
           time by kernel, device busy share; the kernel launches in the
           trace are held against the launch counters, and where they
           differ no busy share is reported as measured (profile_call).
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
           waterfall with f32 state, FER held against the JAX package's,
           then once more under torch.profiler (profile_call: busy share,
           B4's share of the device time);
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
           trials), bf16 then f32, word-exact to the fused kernel, each
           summary stamped with kernel_hash and split_kernel_hash, the
           latter over csrc/split.cu and ops/cuda_split.py; (b) the
           split kernels against their plain version and the fused kernel,
           near-earth 2,048 words at 3.0 and 3.4 dB, 50 iterations, bf16 and
           f32, every word; (c) the main path's stage-1 shape (32,768 words,
           12 iterations, 3.4 dB): split against fused, median of 7 calls;
           split_r and split_c alone, each held against its plain version on
           the same state; host reads; bounds; global bytes a word; one
           split decode under torch.profiler (profile_call: busy share,
           time by kernel); (d) the giant path:
           synthetic_qc_code(2048, 8, 24), refused by the fused kernel,
           4,096 words at 4.0 dB, 8 iterations, through the split pair
           (bit/s, iterations, FER), one such decode under the profiler,
           and 1,024 words at 1.1 dB, where words fail, against the plain
           version; (e) the main path's 3.4 dB
           batches again through a dep_stride=4 cascade (the barrier probe
           runs as it is built), every word equal, and barrier_lowers().
12. microbench the kernel microbenchmark (B9, csrc/microbench.cu): (a) each
           of the 7 probes against its plain version at K = 1 and 7, on one
           tile and on the card-filling count of tiles: every element of the
           final buffers equal, the sums within SUM_RTOL; the fused
           kernel at each of the script's decoder shapes (128 and 32,768
           near-earth words at 0 dB, 40 iterations, flooding bf16 and f32
           and layered bf16: the script's first trial's words) against its
           plain version, every word; (b)
           ldpc_tpu_torch.scripts.kernel_microbench --quick (the probes'
           slopes at one tile and at the card-filling count, the fused
           kernel's per-iteration slopes at 128 and 32,768 words, bf16 and
           f32, against the probes' op-count model, and its layered bf16
           per-sweep slopes, B3's cost a sweep apart from convergence);
           (c) each probe timed at the card-filling count,
           K = 1,000, beside its plain version, its bound and its
           shared-memory bound.
13. env   the code search at the JAX env's defaults (near-earth, 3.0/3.2/
           3.4 dB, 10 transmissions, 50 iterations, caps 48/18), each
           candidate decoded by the fused kernel (flooding min-sum, float32
           state, its tables uploaded, no build): (a) `random-agent --steps
           10` through the CLI, the codec checked every step, the rewards
           and steps/s; (b) the same 10 codes and LLRs through the kernel,
           its plain version and ops/dynamic.py on the card: the kernel
           equal to its plain version on every word and to ops/dynamic.py
           on converged words; (c) EnvironmentVector of 8 envs, batched
           against sequential, 14 steps: identical rewards, states and
           iterations, env steps/s of each from the median vector step;
           (d) one step at
           num_transmissions (256, 1024, 4096) under torch.profiler
           (profile_call: busy share, the kernel's ms); (e) a step of (a)
           piece by piece: plan and tables, upload, kernel (CUDA events,
           beside its bound), host read, reward fit.
14. trainer the PPO trainer at full width (ActorCriticConfig's defaults:
           2,048 observation bytes, 2 x 16 blocks, z = 511, 15 hot bits) on
           the env's defaults, each candidate decoded by the fused kernel
           (flooding min-sum, float32 state): (a) `cli train --num_envs 2
           --steps 16 --epochs 3` (80/80 update iterations), then 2 epochs
           and a `--resume` to 3: steps.tsv equal byte for byte, and B1
           launched once a legal env step, in the uninterrupted run and
           in the resumed one; (b) every legal candidate of (a)'s run, the
           first epoch's among them, their codes and LLRs, through the
           kernel and its plain version: every word equal; (c) the
           trained policy on the card against the same weights on the
           CPU: evaluate_actions within the CPU tests' tolerance, mode
           equal, one update step's extras, gradients and parameters
           within tolerance; (d) the same training with batched vector
           steps (steps.tsv equal to (a)'s): env steps/s of each, sampling
           ms a step, env step ms, update ms an epoch; one sampling step
           and one iteration of each update under torch.profiler
           (profile_call: device events, busy share).
15. validation the Monte-Carlo validation path, each study at its
           script's defaults (ldpc_tpu_torch/scripts/): (a) the encoder:
           4,096 random messages each for near-earth (the generator),
           802.11n rate 1/2 (the parity part from H) and near-earth with
           block (0, 0) zeroed (rank 1,020 of 1,022: the column-pivoted
           path), every syndrome zero on the card from the plan's sparse
           tables and every codeword equal to the CPU's, and the encoder's
           time at 32,768 near-earth messages; (b) random_codeword_check
           (near-earth 3.0/3.4 dB, 802.11n 2.5/3.5 dB, 4,096 words, the
           torch engine): zero and random agree at every point, each
           all-zero point in the band of the JAX package's
           docs/random_codeword.json; (c) the main path's cascade (32,768
           words, 12 -> 50, capacity 6,144) at 3.0 dB ("many") and 3.4 dB
           ("few"), with and without sort_words from the same generator
           state, every output equal; then sort_ab, its speedups logged;
           (d) staged_decode_counts(pad_to=256) on the cuda engine against
           the cascade on the same LLRs, a batch above 25% stage-1
           failures and one below, every output equal; (e) ber_parity
           (8 points, 16,384 words, torch f32 against cuda bf16 on the
           same LLRs): the engines' FER intervals overlap and each
           engine's BER lies in the band of docs/ber_parity.json at every
           point; the native engine's BER within its CI of the torch
           engine's on the same 384 words, both agreements logged beside
           the JAX artifact's; (f) error_floor at full size (1,048,576
           words a point, 3.6-4.2 dB) and wifi_waterfall on the torch and
           cuda engines, every FER interval overlapping the JAX package's
           (docs/error_floor.json, docs/wifi_waterfall.json); (g) `cli
           getting-started`: the probe OK and the native engine available.
16. parallel parallel/ (torch.distributed): (a) each point of the main
           path's protocol (one batch of 32,768 near-earth words, 12 -> 50,
           capacity 6,144, the fused kernel) through evaluate_code_sharded
           on a one-rank NCCL group and through evaluate_code, in turns:
           counters equal, bit/s of each beside phase 4's; (b)
           dryrun_multichip(2) at its FULL sizes on a gloo group whose two
           ranks share the card: 2 x 16,384 near-earth words at 3.4 dB
           through the sharded cascade (each rank's counters equal to ONE
           rank's on the same batch, and to (a)'s one-rank sharded step),
           the hierarchical mesh, the row-sharded decoder on 802.11n rate
           1/2 with integer LLRs (equal to the unsharded decoder), an
           8-candidate vector step with the candidates sharded (equal to
           the unsharded step) and dryrun_train_step; (c) `cli evaluate
           --sharded` on near-earth, `cli post-mortem --best --heatmaps`
           and topk_select(reeval_kw={"engine": "cuda", "staged": True})
           on phase 14's steps.tsv (no candidate skipped), `cli
           reward-surface`.  Every process group is destroyed at its end.
17. continuous and studies: (a) the continuous-control suite
           (ldpc_tpu_torch/rl/{ddpg,sac,trpo}.py; no kernel): ddpg, td3, sac
           and trpo, 2 epochs of 256 steps each on PointMassEnv on the
           card, seconds and the last epoch's log; then one update of each
           from the same weights and batch on the card and on the CPU (TF32
           off): losses, gradients and parameters within tolerance, and
           for TRPO the surrogate's gradient, a Fisher-vector product, the
           natural-gradient step, its KL, surrogate and acceptance; (b) the
           kernel studies at their defaults (ldpc_tpu_torch/scripts/):
           layered_ab (B1 flooding against B3 layered cascades, near-earth
           32,768 words, 3.0-3.6 dB), quantized_ber (B5 int8 against B1
           bf16 and f32), sched_ab (dep_stride 0/4/8 x popcount_sign 0/1:
           B8's probe, B6; every variant word-exact) and perturbation_fer
           (the 33 near-earth codes, 8,192 words a point, 3.2-3.8 dB, the
           fused kernel with each code's tables as data) and giant_code
           (synthetic codes, z 2,048-32,768, row-sharded over 8 gloo ranks
           sharing the card, plain torch; the cross-check with the
           unsharded decoder exact): each study's seconds and launches, and every FER point in the band of the JAX
           package's artifact (the two Wilson intervals overlap at the z
           that holds the study's points at 95% together).
18. search the code-search scripts (ldpc_tpu_torch/scripts/), each into a
           temporary directory: chain_scoreboard at its defaults (near-earth
           and the five carried chain codes: 512 transmissions x 5 points x
           5 seeds of reward, 262,144 floor words at 3.8 dB), each code's
           FER in the band of docs/chain_scoreboard.json (phase 17's
           family z) and its reward within Student's t of the two 5-seed
           spreads (CHAIN_REWARD_T); discovered_code_waterfall (the carried
           s47 against near-earth, 16,384 words a point, 3.0-4.0 dB), every
           FER point in the band of docs/discovered_code.json;
           staging_grid (4 cascades, 32,768 words at 3.4 dB), every call
           word-exact to a straight decode; rollout_throughput (1, 4, 8
           envs, sequential and fused), env steps/s; reward_investigation
           (802.11n, 2 x 24 sweeps), its reward noise against
           docs/reward_investigation.json's; rl_search_wide on near-earth at
           full width for 2 epochs of 8 steps with one floor term, then on
           its steps.tsv floor_topk_select and rl_search_wide --select-only
           at top-K 2 (the rerun's selection equal) and floor_search_analysis;
           reward_floor_frontier and chain_figure on those artifacts.  Each
           script's seconds and launches by store.
19. the kernels line, the card line again, and the result line.

Every driven path (the main path, each evaluate run of phases 8 and 10,
each near-earth path of phase 10, the split A/B, the giant path and the
dep_stride replay of phase 11, the microbench script of phase 12, the
env paths (a), (c) and (d) of phase 13, the trainer's runs (a) and (d)
of phase 14, the validation paths (c)-(f) of phase 15 that launch a
kernel, the sharded paths (a), (b) (the two ranks' sharded parts,
summed) and (c) of phase 16, each study of phase 17 (b) and each script
of phase 18) clears the launch counts just before it and reads them just
after; a row of the kernels line gives the launches of
the path meant to drive it (`path`, `launches`) and those of every path
that ran it (`launches_by_path`), and the run fails if that path launched
it no time.  Launches that compare a kernel with its plain version, or time
it, are counted on no path.

Imports torch, numpy and ldpc_tpu_torch only; the machine with the card has
no JAX.  Writes nothing but the kernel builds (ldpc_tpu_torch/_build/)
and, in phases 14-18, the trainers' logs and checkpoints, the studies'
and the scripts' artifacts and the post-mortem's plots under temporary
directories that it removes; phase 16's two ranks are processes it starts
and waits for.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import re
import sys
import time
import traceback

import numpy as np
import torch

from ldpc_tpu_torch import cli, dryrun
from ldpc_tpu_torch.codes import (QCCode, near_earth_code,
                                  synthetic_qc_code, wifi_code)
from ldpc_tpu_torch.ops import cuda_split, cuda_static, microbench
from ldpc_tpu_torch.ops.cuda_split import (SplitState, least_bytes,
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
from ldpc_tpu_torch.scripts import (edge_sass, kernel_microbench, phi_sass,
                                    split_ab)
from ldpc_tpu_torch.sim.stats import BerStatistics, wilson_interval
from ldpc_tpu_torch.utils.device import device_info
from ldpc_tpu_torch.utils.profiling import (F32_OPS_PER_S, HBM_BYTES_PER_S,
                                            smi_query, time_ms, timed_once)
from ldpc_tpu_torch.utils.provenance import SPLIT_SOURCES, kernel_source_hash

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

# Phase 13, the code search at the JAX env's defaults (near-earth, SNR
# 3.0/3.2/3.4 dB, 10 transmissions, 50 iterations, caps 48/18): (a) the
# random agent's steps, (c) a vector env's size and steps, (d) one deep
# step's words a point.  Each candidate decodes through the fused kernel,
# flooding min-sum with float32 state.
ENV_STEPS = 10
ENV_VECTOR = 8
ENV_VECTOR_STEPS = 2          # (c) steps, then ENV_VECTOR_TIMED more, all
ENV_VECTOR_TIMED = 12         # held equal; env steps/s from the median step
ENV_DEEP_TX = (256, 1024, 4096)
ENV_TRACES = 3                # (d) traces at most, until one holds the kernel
ENV_KEY = ("min-sum", "float32", "flooding", False)
ENV_PATHS = {"a": "env (a) random-agent", "c": "env (c) vector batched",
             "c_seq": "env (c) vector sequential",
             "d": "env (d) deep step"}

# Phase 14, the PPO trainer at full width (ActorCriticConfig's defaults:
# 2,048 observation bytes, 64 hidden, 2 x 16 blocks, z = 511, 15 hot bits)
# on the env's defaults, through `cli train`: 2 envs, 16 steps an epoch, 3
# epochs, the default 80/80 update iterations; then 2 epochs resumed to 3.
TRAIN_ENVS = 2
TRAIN_STEPS = 16
TRAIN_EPOCHS = 3
TRAIN_SPLIT = 2
TRAIN_PATHS = {"a": "trainer (a) cli train", "a_resume":
               "trainer (a) split and resumed", "d": "trainer (d) batched"}
# (c) the card against the CPU.  Log-probs and entropies: the CPU tests'
# rtol 1e-5, atol 1e-4 (tests/test_torch_rl_model.py).  An update's
# extras: within EXTRAS_ATOL of max(1, |the CPU's value|), so absolute for
# the O(1) ones, as in tests/test_torch_ppo.py, and relative for the value
# loss, O(100) on raw observation bytes, where float32 rounds a mean of
# O(1e4) squares at about 1e-7 of the value but 1e-5 absolute is 3e-8 of
# it.  The step's gradients: each element within GRAD_RTOL of its CPU
# value plus GRAD_ATOL of its tensor's largest |gradient|, so a backward
# pass with wrong magnitudes fails (a fresh Adam's first step moves each
# element by about lr whatever its gradient's size, so the parameters
# after it see only the signs).  The two devices' float32 sums differ
# by up to 1e-4 of a tensor's largest gradient in its smallest elements,
# up to 0.75 of this tolerance on fresh full-width weights
# (ldpc_tpu_torch/scripts/grad_parity.py on the H100), far below a wrong
# magnitude.  The parameters
# after the step: 1e-5, but for the rows of a first-layer unit tanh holds
# in its flat tail on every row (|a| >= 7.5, < 9.1 on some), which may
# step by up to lr either side.
POLICY_RTOL, POLICY_ATOL = 1e-5, 1e-4
EXTRAS_ATOL = PARAM_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 3e-5

# Phase 15, the Monte-Carlo validation path, each study at its script's
# defaults unless cut here (words only, logged).  (a) encoder words a code;
# (c) the sorted main path's points and their cascade branch; (d) the
# staged_decode_counts chunk.
VAL_ENCODE_WORDS = 4096
VAL_ENCODE_TIMED = 32768      # the encoder's time at the main path's batch
VAL_SORT_SNRS = {3.0: "many", 3.4: "few"}
VAL_PAD_TO = 256
VAL_RC_ARGS: list[str] = []          # random_codeword_check's defaults
VAL_PARITY_ARGS: list[str] = []      # ber_parity's defaults
VAL_FLOOR_ARGS: list[str] = []       # error_floor's defaults (full size)
VAL_WIFI_ARGS: list[str] = []        # wifi_waterfall's defaults
VAL_SORT_AB_ARGS: list[str] = []     # sort_ab's defaults
VAL_PATHS = {"c": "validation (c) sorted main path",
             "c_ab": "validation (c) sort_ab",
             "d": "validation (d) staged_decode_counts",
             "e": "validation (e) ber_parity",
             "f_floor": "validation (f) error floor",
             "f_wifi": "validation (f) waterfall --engine cuda"}
# The JAX package's artifacts (docs/, not copied to the card's machine),
# each point's band.  (b) docs/random_codeword.json, the all-zero points:
# (BER, 95% CI half-width).
JAX_RANDOM_ZERO = {("near-earth", 3.0): (0.01872844658719117,
                                         0.0002536454659205407),
                   ("near-earth", 3.4): (0.0003080125424260029,
                                         6.878955420307008e-05),
                   ("wifi", 2.5): (0.0055562086066100825,
                                   0.00033759844204378866),
                   ("wifi", 3.5): (0.0, 0.0)}
# (e) docs/ber_parity.json, each point's (BER, 95% CI half-width) of the
# XLA f32 engine and of the Pallas bf16 kernel, the torch and cuda
# engines' counterparts (16,384 words a point)
JAX_PARITY = {
    2.9914: ((0.019163411657404292, 0.0001233971799675323),
             (0.01912733999950312, 0.00012319964699367781)),
    3.0: ((0.01872270587839026, 0.00012647383275367002),
          (0.01864463522476226, 0.0001262469491676604)),
    3.1541: ((0.008435057100717801, 0.00014667729657957877),
             (0.008459744388110016, 0.00014680422170446184)),
    3.2: ((0.005748651732204011, 0.00013230716994677282),
          (0.005719567464988992, 0.00013212238682756803)),
    3.3076: ((0.0015336799994840082, 7.52872880327035e-05),
             (0.0015598005977862034, 7.592534843414756e-05)),
    3.4: ((0.00034427829451290365, 3.612893912643886e-05),
          (0.00033996343146098335, 3.572257017021419e-05)),
    3.4404: ((0.0001393745556736179, 2.2941779216773292e-05),
             (0.00013935962535163894, 2.26565864355124e-05)),
    3.6: ((5.972128791585127e-07, 1.170537243150685e-06),
          (1.022727055558953e-06, 1.6466126903127342e-06))}
JAX_NATIVE_AGREEMENT = (0.6536458333333334, 0.9401041666666666)
# (f) docs/error_floor.json, each point's FER Wilson 95% interval
# (8,388,608 words a point), and docs/wifi_waterfall.json, each point's
# frame errors of 8,192 words (its FER x 8,192)
JAX_FLOOR_FER = {3.6: (0.00017626745995686936, 0.0001946927964908129),
                 3.8: (2.104282580424869e-08, 6.753298411286634e-07),
                 4.0: (0.0, 4.5795419701613854e-07),
                 4.2: (0.0, 4.5795419701613854e-07)}
JAX_WIFI_WORDS = 8192
JAX_WIFI_FRAMES = {
    "0.5000": {-1.0: 2, -0.5: 0, 0.0: 0, 0.5: 0, 1.0: 0},
    "0.6667": {0.0: 2114, 0.5: 43, 1.0: 0, 1.5: 0},
    "0.7500": {1.0: 2858, 1.5: 78, 2.0: 1, 2.5: 0},
    "0.8333": {2.0: 5243, 2.5: 437, 3.0: 7, 3.5: 1, 4.0: 0}}

# Phase 17.  (a) the continuous-control suite (ldpc_tpu_torch/rl/): each
# algorithm 2 epochs of 256 steps on PointMassEnv, its config's defaults
# otherwise (updates from step 256); then one update from the same weights
# and batch on the card and on the CPU, TF32 off: the losses within
# CONT_RTOL of max(1, |the CPU's|), the gradients within GRAD_RTOL +
# GRAD_ATOL of each tensor's largest, the parameters after within
# PARAM_ATOL but where the CPU's gradient is within its own tolerance of 0
# (Adam's first step moves such an element by up to lr either way).  TRPO:
# the surrogate's gradient and a Fisher-vector product within FVP_RTOL of
# their norm; the conjugate-gradient step amplifies float32 rounding (from
# a gradient and products that agree to 7e-7, the JAX package's and the
# port's ten-iteration solutions differ by 1.4e-3 of their norm on the CPU,
# tests/test_torch_trpo.py), so the step, its KL and its surrogate within
# TRPO_STEP_RTOL, the line search's acceptance equal.
CONT_EPOCHS = 2
CONT_STEPS = 256
CONT_RTOL = 1e-4
FVP_RTOL = 1e-5
TRPO_STEP_RTOL = 5e-2
CONT_ALGOS = ("ddpg", "td3", "sac", "trpo")
# (b) the kernel studies at their defaults, each a driven path, and the
# kernel variants each must launch
STUDY_ARGS: dict[str, list[str]] = {
    "layered_ab": [], "quantized_ber": [], "sched_ab": [],
    "perturbation_fer": [], "giant_code": []}
STUDY_PATHS = {name: f"study {name}" for name in STUDY_ARGS}
STUDY_KEYS = {
    "layered_ab": [("min-sum", "bfloat16", "flooding", False),
                   ("min-sum", "bfloat16", "layered", False)],
    "quantized_ber": [("min-sum", s, "flooding", False)
                      for s in ("bfloat16", "float32", "int8")],
    "sched_ab": [("min-sum", "bfloat16", "flooding", False),
                 ("min-sum", "bfloat16", "flooding", True),
                 "barrier_probe"],
    "perturbation_fer": [("min-sum", "float32", "flooding", False)],
    "giant_code": []}           # parallel/rowshard.py: plain torch
# Each study's FER points against the JAX package's artifacts (docs/, not
# copied to the card's machine), as frame errors of its words: a point
# passes where the two Wilson intervals overlap, each at the confidence
# that holds the study's family of points at 95% (Bonferroni: z of 1 -
# 0.025 / points); whether each point's 95% intervals overlap is logged.
# docs/layered_ab.json ("results" -> variant -> point "fer" x 32,768)
JAX_LAYERED_AB_WORDS = 32768
JAX_LAYERED_AB_FRAMES = {
    "flooding-p12": {3.0: 28401, 3.2: 10632, 3.4: 769, 3.6: 3},
    "layered-p6": {3.0: 27863, 3.2: 9609, 3.4: 597, 3.6: 2},
    "layered-p4-12": {3.0: 27863, 3.2: 9609, 3.4: 597, 3.6: 2}}
# docs/quantized_ber.json ("stores" -> store -> point "fer" x 32,768; it
# has no float32 store)
JAX_QUANT_WORDS = 32768
JAX_QUANT_FRAMES = {
    "bfloat16": {3.0: 28416, 3.2: 10634, 3.4: 721, 3.6: 2},
    "int8": {3.0: 31051, 3.2: 17157, 3.4: 2227, 3.6: 34}}
# docs/sched_ab.json ("entries" -> s<stride>_t128_p<popcount>_bfloat16 ->
# "nfail", one count a trial of 16,384 words, duplicates dropped)
JAX_SCHED_WORDS = 16384
JAX_SCHED_NFAIL = {(0, False): [3230, 3237, 3242],
                   (0, True): [3222, 3261, 3278, 3289],
                   (4, False): [3260, 3266, 3281],
                   (8, False): [3255, 3286, 3312]}
# docs/perturbation_fer.json ("variants" -> name -> 3.2/3.4/3.6/3.8 dB
# "fer" x 8,192)
JAX_PERTURB_WORDS = 8192
JAX_PERTURB_FRAMES = {
    "intact": (2724, 197, 1, 0), "zero_0_0": (1606, 71, 0, 0),
    "zero_0_1": (1586, 64, 1, 0), "zero_0_2": (1656, 52, 0, 0),
    "zero_0_3": (1643, 75, 0, 0), "zero_0_4": (1607, 69, 0, 0),
    "zero_0_5": (1600, 50, 0, 0), "zero_0_6": (1623, 60, 0, 0),
    "zero_0_7": (1607, 74, 1, 0), "zero_0_8": (1628, 73, 0, 0),
    "zero_0_9": (1634, 54, 0, 0), "zero_0_10": (1645, 66, 0, 0),
    "zero_0_11": (1584, 66, 0, 0), "zero_0_12": (1558, 66, 0, 0),
    "zero_0_13": (1587, 65, 1, 0), "zero_0_14": (1632, 64, 0, 0),
    "zero_0_15": (1645, 52, 0, 0), "zero_1_0": (1616, 67, 0, 0),
    "zero_1_1": (1587, 55, 0, 0), "zero_1_2": (1566, 81, 0, 0),
    "zero_1_3": (1682, 74, 1, 0), "zero_1_4": (1616, 68, 1, 0),
    "zero_1_5": (1635, 68, 0, 0), "zero_1_6": (1607, 63, 0, 0),
    "zero_1_7": (1656, 63, 2, 0), "zero_1_8": (1650, 64, 0, 0),
    "zero_1_9": (1633, 70, 0, 0), "zero_1_10": (1609, 59, 0, 0),
    "zero_1_11": (1581, 76, 0, 0), "zero_1_12": (1726, 75, 0, 0),
    "zero_1_13": (1636, 56, 0, 0), "zero_1_14": (1652, 82, 0, 0),
    "zero_1_15": (1605, 72, 0, 0)}
JAX_PERTURB_SNRS = ("3.2", "3.4", "3.6", "3.8")
# docs/giant_code.json ("runs" -> (z, layout) -> frame errors of its words;
# it ran z = 2,048, 8,192, 32,768 and 131,072, 8 virtual CPU devices)
JAX_GIANT_FRAMES = {(z, layout): (0, 2 if layout == "1x8" else 4)
                    for z in (2048, 8192, 32768, 131072)
                    for layout in ("1x8", "2x4")}

# Phase 18, the code-search scripts (ldpc_tpu_torch/scripts/), each at its
# defaults but rl_search_wide: near-earth at the JAX defaults' width (5 SNR
# points x 64 transmissions, 50 iterations) for 2 epochs of 8 steps with one
# floor term, then the selection scripts at top-K 2 on its own steps.tsv.
SEARCH_TOPK = 2
SEARCH_RL_ARGS = ["--epochs", "2", "--steps", "8", "--floor-penalty", "30",
                  "--floor-snr-index", "-1", "--floor-words", "16384",
                  "--topk", str(SEARCH_TOPK)]
B1_BF16 = ("min-sum", "bfloat16", "flooding", False)
B1_F32 = ("min-sum", "float32", "flooding", False)
# each script's driven path and the kernel variants it must launch (the
# re-evaluations and the floors bf16; the code-search env f32)
SEARCH_KEYS = {
    "chain_scoreboard": [B1_BF16], "discovered_code_waterfall": [B1_BF16],
    "staging_grid": [B1_BF16], "rollout_throughput": [B1_F32],
    "reward_investigation": [B1_BF16], "rl_search_wide": [B1_F32, B1_BF16],
    "floor_topk_select": [B1_BF16], "floor_search_analysis": [B1_BF16],
    "rl_search_wide --select-only": [B1_BF16],
    "reward_floor_frontier": [], "chain_figure": []}      # no decode
SEARCH_PATHS = {name: f"search {name}" for name in SEARCH_KEYS}
# docs/chain_scoreboard.json ("codes" -> name): reward_mean, reward_std
# (np.std of 5 seeds' rewards), frame errors at 3.8 dB of 262,144 words.
JAX_CHAIN_WORDS = 262144
JAX_CHAIN = {
    "near_earth": (0.805924898950624, 0.00042046674239947895, 0),
    "s47": (0.8159607561817982, 0.001189194065690012, 0),
    "boot_s52": (0.8201119782973837, 0.002378021857689831, 73),
    "topk_r4": (0.8190032575126602, 0.005004156101827582, 65),
    "floor2": (0.8178999812946678, 0.0024522341951844786, 26),
    "floor2_late": (0.8091532835511419, 0.0006674427089558099, 7)}
# A code's reward passes where |port - JAX| <= T * sqrt((s_port^2 + s_jax^2)
# / (n - 1)), s the np.std (ddof 0) of n = 5 seeds' rewards each: the
# standard error of the difference of the two means, and T Student's t of
# 2 (n - 1) = 8 degrees of freedom at 1 - 0.025 / 6 (the 6 codes together
# at 95%, Bonferroni), computed once with scipy.stats.t.ppf.
CHAIN_REWARD_T = 3.4788791899651743
# docs/discovered_code.json ("codes" -> code -> point "fer" x 16,384)
JAX_WATERFALL_WORDS = 16384
JAX_WATERFALL_FRAMES = {
    "near_earth": {3.0: 14279, 3.2: 5445, 3.4: 369, 3.6: 2, 3.8: 0, 4.0: 0},
    "discovered": {3.0: 6078, 3.2: 510, 3.4: 5, 3.6: 1, 3.8: 0, 4.0: 0}}
# docs/reward_investigation.json ("mc_noise" -> transmissions): the mean and
# np.std of 24 seeds' 802.11n rewards; the same test as the chain's, with
# 2 (24 - 1) = 46 degrees of freedom and the 2 counts together at 95%.
JAX_REWARD_NOISE = {"10": (0.7922879641249718, 0.0033297752640666987),
                    "40": (0.7919894240598833, 0.001439110499195286)}
REWARD_NOISE_SEEDS = 24
REWARD_NOISE_T = 2.317152172150019
# The bounds use the H100's peaks of ldpc_tpu_torch/utils/profiling.py:
# operations over the float32 peak, which counts a fused multiply-add as 2
# and every other float32 operation as 1, as the counts below do.
# float32 operations per Tanner edge and iteration, (phase A, phase B).
# min-sum: phase A 8 (old c2v: select, sign; v = t - c2v; |v|; two-min
# compare, m2 min, m1 min; sign test), phase B 3 (select, sign, add);
# normalized adds one multiply and offset a subtract and a max wherever a
# message is rebuilt.  Sum-product, the least work an edge: phase A 7 plus
# 1 phi (v = t - c2v, with c2v the message phase B computed from the same
# stored S, sign and stash; |v|, 2 clip, mul, neg; S add; sign test),
# phase B 8 plus 1 phi (sub, 2 clip, mul, neg, sign, mul, add).  Phase A
# does not rebuild the old message (7 operations and a phi): that only
# recomputes a value the previous phase B computed.  One phi is the
# float32 operations of the SASS that csrc/decode.cu's phi compiles to (an
# FFMA 2; what runs for some arguments only left out), counted by
# ldpc_tpu_torch/scripts/phi_sass.py: phase 2 counts them on the card's
# toolkit, and the bounds use that count.
# Phase 16, parallel/: (a) the main path's sweep through
# evaluate_code_sharded on a one-rank NCCL group, against evaluate_code;
# (b) dryrun_multichip(2) at FULL (2 x 16,384 near-earth words at 3.4 dB)
# on a gloo group whose two ranks share the card; (c) the CLI and the
# post-training analysis on phase 14's steps.tsv.
PAR_RANKS = 2
PAR_TIMEOUT_S = 240
PAR_CLI_WORDS = 4096          # (c) cli evaluate --sharded, a point
PAR_PATHS = {"a": "parallel (a) sharded sweep, one rank",
             "b": "parallel (b) two ranks on the card",
             "c_cli": "parallel (c) cli evaluate --sharded",
             "c_topk": "parallel (c) topk_select"}
# (b) the parts of a rank that decode sharded; the others are the
# unsharded references they are held to
PAR_SHARDED_PARTS = ("straight cuda", "staged", "staged hierarchical",
                     "vector step sharded")
PAR_TOPK_KW = {"engine": "cuda", "staged": True}
PAR_TOPK_ARGS: dict = {}      # topk_select's defaults (a rehearsal: fewer)
PAR_DRYRUN = dryrun.FULL      # (b)'s sizes


def sum_product_ops(phi_ops: int) -> tuple[int, int]:
    return (7 + phi_ops, 8 + phi_ops)


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

# B7's edge loops in split.cu before its redesign, as recorded once from
# split.cu at commit 6764371 (edge_sass.py --split --source, nvcc 12.9 on
# an H100 machine; PERF.md), not measured in a run: instructions, shared
# loads and global loads an edge
SPLIT_PARENT_SASS = {"B7 split_r bfloat16": (39.75, 2, 1),
                     "B7 split_r float32": (38.75, 2, 1),
                     "B7 split_c bfloat16": (47, 3, 5),
                     "B7 split_c float32": (40.75, 3, 4)}
# The fused kernel's int8 (B5) and sum-product (B4) edge loops in decode.cu
# before their redesign, as recorded once from decode.cu at commit b1d578c
# (edge_sass.py's analysis of its cuobjdump listing, nvcc 12.9 on an H100
# machine; PERF.md), not measured in a run.  B5: per phase, instructions,
# shared-memory instructions and conversions an edge; B4: per phase,
# instructions, shared-memory instructions and phi an edge.
DECODE_PARENT_SASS = {"B5 int8": {"A": (23.5, 1.5, 1), "B": (18.0, 1.25, 1)},
                      "B4 bfloat16": {"A": (129, 5, 2), "B": (90, 8, 1)},
                      "B4 float32": {"A": (125, 5, 2), "B": (87, 8, 1)}}
# the port's kernels among the profiler's device events
OUR_KERNELS = re.compile(r"decode_kernel|split_[rc]<")
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
    # the edge loops' cubins compile beside the build, in threads of their
    # own
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        edges = pool.submit(edge_sass.count)
        split_edges = pool.submit(edge_sass.count_split)
        build(*sources)
    res = edges.result()
    split_res = split_edges.result()
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
    log("build", f"edge loops: {edge_sass.summary(res)}; shared "
        "instructions by opcode (A, B; B3 syndrome, fold, delta): " +
        "; ".join([f"{k} {res[k]['A']['shared_by_opcode']}, "
                   f"{res[k]['B']['shared_by_opcode']}"
                   for k in edge_sass.INSTANCES] +
                  [f"{k} " + ", ".join(str(r[c]['shared_by_opcode'])
                                       for c in edge_sass.LAYERED_EDGES)
                   for k, r in res["layered"].items()]))
    reps["edge_sass"] = res
    log("build", "B5 int8 edge loops, per phase (instructions, shared, "
        "conversions an edge): " + "; ".join(
            f"{ph} {res['B5 int8'][ph]['instructions_per_edge']:.4g}, "
            f"{res['B5 int8'][ph]['shared_per_edge']:.4g}, "
            f"{res['B5 int8'][ph]['conversions'] / res['B5 int8'][ph]['edges']:.4g}"
            for ph in "AB") + "; B4 sum-product, per phase (instructions, "
        "shared, phi an edge; loops): " + "; ".join(
            f"{k} {ph} {r[ph]['instructions_per_edge']:.4g}, "
            f"{r[ph]['shared_per_edge']:.4g}, {r[ph]['phi_per_edge']:.4g} "
            f"({r[ph]['loops']})"
            for k, r in res["sum_product"].items() for ph in "AB") +
        "; decode.cu at b1d578c, before the redesign, as recorded (not "
        "measured in this run): " + "; ".join(
            f"{k} " + ", ".join(f"{ph} {v}" for ph, v in d.items())
            for k, d in DECODE_PARENT_SASS.items()))
    log("build", f"B7 edge loops: {edge_sass.split_summary(split_res)}; "
        "split.cu at 6764371, before the redesign, as recorded (not "
        "measured in this run; instructions, shared and global loads an "
        "edge): " + "; ".join(f"{k} {v}" for k, v in
                              SPLIT_PARENT_SASS.items()))
    reps["split_sass"] = split_res
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
        if c["mismatched"]:
            raise AssertionError(f"{label}: kernel and plain version differ "
                                 f"on {c['mismatched']} words "
                                 f"({c['mismatched_converged']} converged)")
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


def launch_total() -> int:
    """Every launch the kernels' wrappers have counted so far."""
    return (sum(cuda_static.launches.values()) +
            sum(cuda_split.launches.values()))


def profile_call(dev, fn, tag: str, label: str) -> dict:
    """Run ``fn()`` under torch.profiler, once to warm the tracer up and
    once recorded: device time by kernel and the device's busy share of
    the wall time.  (On the H100 a trace started cold has dropped the first
    launches of a call, all of a one-launch call.)  The launches of the
    port's kernels that the trace holds are held against the launches the
    wrappers counted in the recorded call: where they differ, the line says
    so and no busy share is reported as measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        sync(dev)
        prof.step()
        before = launch_total()
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
        counted = launch_total() - before
        prof.step()
    by_name: dict[str, list] = {}
    for e in prof.events():
        # annotations (the step's, the optimiser's) span their kernels on
        # the device's timeline too: count kernels and copies only
        if (e.device_type == DeviceType.CUDA and
                not getattr(e, "is_user_annotation", False) and
                not e.name.startswith(("ProfilerStep", "Optimizer."))):
            row = by_name.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
    seen = sum(c for name, (c, _) in by_name.items()
               if OUR_KERNELS.search(name))
    busy = sum(t for _, t in by_name.values())
    res = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "device_events": sum(c for c, _ in by_name.values()),
           "kernel_ms": sum(t for name, (_, t) in by_name.items()
                            if OUR_KERNELS.search(name)) / 1e3,
           "launches_seen": seen, "launches_counted": counted,
           "measured": bool(by_name) and seen == counted}
    if res["measured"]:
        res["busy_share"] = busy / wall_us
        log(tag, f"{label}: {wall_us / 1e3:.2f} ms wall under the "
            f"profiler, device busy {busy / 1e3:.2f} ms "
            f"({100 * busy / wall_us:.1f}%); the trace holds all {seen} "
            "kernel launches counted")
    else:
        log(tag, f"{label}: the trace holds {seen} of the {counted} kernel "
            f"launches counted ({busy / 1e3:.2f} ms of device time in "
            f"{wall_us / 1e3:.2f} ms wall): busy share not measured")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (count, t) in top:
        log(tag, f"{label}:   {t / 1e3:9.3f} ms  {count:3d}x  {name[:90]}")
    return res


def phase_profile(dev, step, tag: str = "profile") -> None:
    """One more batch at 3.0 and 3.4 dB under torch.profiler
    (profile_call)."""
    for snr in PROFILE_SNRS:
        snr_db = torch.full((BATCH,), snr, dtype=torch.float32, device=dev)
        profile_call(dev, lambda: step(snr_db), tag, f"{snr} dB")


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

    # the waterfall once more under the profiler: the device's busy share
    # and B4's share of the device time
    def waterfall():
        for rate, snrs in by_rate.items():
            _sweep(dev, wifi_code(1944, rate), snrs, kind="sum-product",
                   scale_llr=True, store_dtype="float32", seed=WIFI_SEED)

    prof = profile_call(dev, waterfall, "evaluate",
                        "(b) sum-product waterfall")
    if prof["busy_ms"] > 0:
        log("evaluate", f"(b) under the profiler: B4 {prof['kernel_ms']:.3f}"
            f" ms of {prof['busy_ms']:.3f} ms of device time "
            f"({100 * prof['kernel_ms'] / prof['busy_ms']:.1f}%)")
    out["sum_product_profile"] = prof
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
    """Max |kernel - plain| over the named arrays (0 when all equal; the
    records' words compared as integers)."""
    return max(float((getattr(got, n).double() -
                      getattr(want, n).double()).abs().max())
               for n in names if getattr(got, n).numel())


def split_bound(plan, store: str, live_r: int, live_c: int,
                batch: int) -> tuple[float, str]:
    """Least time on an H100 for ``live_r`` words' split_r work and
    ``live_c`` words' split_c work of ``batch`` words: the least bytes the
    work moves, whatever the layout (least_bytes; each launch reads every
    word's success flag), over the HBM rate vs 8 (phase A) and 3 (phase B)
    f32 operations per edge and live word over peak."""
    sb = least_bytes(plan, store)
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
    stamp = (kernel_source_hash(), kernel_source_hash(sources=SPLIT_SOURCES))
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
        if (summ.get("kernel_hash"), summ.get("split_kernel_hash")) != stamp:
            raise AssertionError(f"split_ab {store}: stamp is not the "
                                 f"sources' {stamp}")
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
        prof = profile_call(dev, lambda: split(llr), "11split",
                            f"(c) {store} stage-1 split decode")
        log("11split", f"(c) {store} stage-1 split decode under the "
            f"profiler: {split.host_reads} host reads")
        it = kern[1].long()
        ok = kern[2]
        live_r = int(torch.where(ok, it + 1, PHASE1_ITERS + 1).sum())
        live_c = int(torch.where(ok, it, PHASE1_ITERS).sum())
        dec_bnd, dec_by = split_bound(plan, store, live_r, live_c, BATCH)
        sb, lb = state_bytes(plan, store), least_bytes(plan, store)
        log("11split", f"(c) {store} stage 1 ({BATCH} words, "
            f"{PHASE1_ITERS} it, 3.4 dB): split {split_ms:.3f} ms vs fused "
            f"{mono_ms:.3f} ms ({split_ms / mono_ms:.3f}x), {reads} host "
            f"reads; bound {dec_bnd:.4f} ms ({dec_by}; {live_r} split_r and "
            f"{live_c} split_c word-launches); {sb['word']} global bytes a "
            "word")
        # each kernel alone, against its plain version on the same state
        t = cuda_static._RefTables(plan, dev)
        tables = torch.as_tensor(cuda_split.split_tables(plan, store),
                                 device=dev)
        n_ok = torch.zeros(PHASE1_ITERS + 1, dtype=torch.int32, device=dev)
        st = SplitState.start(llr, plan, PHASE1_ITERS, store)
        errs = {}
        plain_r, plain_ms_r = timed_once(
            lambda: _plain_launch(split_r_reference, st, t, 0), dev)
        cuda_split.launch("r", st, plan, tables, n_ok, 0)
        sync(dev)
        errs["r"] = _state_err(st, plain_r, ("rec", "xbits", "errors",
                                             "iters", "success"))
        plain_c, plain_ms_c = timed_once(
            lambda: _plain_launch(split_c_reference, st, t), dev)
        cuda_split.launch("c", st, plan, tables, n_ok)
        sync(dev)
        errs["c"] = _state_err(st, plain_c, ("tot", "errors"))
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
                f"live words, at least {lb['split_' + k]} bytes each; the "
                f"records move {sb['split_' + k]}), max |kernel - plain| "
                f"{errs[k]}")
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
                "least_bytes_per_live_word": lb["split_" + k],
                "shape": f"{BATCH} words x {code.n} (near-earth), one launch,"
                         f" {live} live words, 3.4 dB"}
        out[f"stage1_{store}"] = {
            "split_ms": split_ms, "mono_ms": mono_ms, "host_reads": reads,
            "bound_ms": dec_bnd, "bound_by": dec_by, "profile": prof}
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
    llr = llr_batch(giant, GIANT_WORDS, GIANT_SNR, gen, dev)
    g["profile"] = profile_call(dev, lambda: dec(llr), "11giant",
                                f"{GIANT_WORDS} words at {GIANT_SNR} dB")
    log("11giant", f"{GIANT_WORDS} words at {GIANT_SNR} dB under the "
        f"profiler: {dec.host_reads} host reads")
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
    runs = ([(s, "flooding") for s in kernel_microbench.DECODER_STORES] +
            [(s, "layered") for s in kernel_microbench.LAYERED_STORES])
    for store, schedule in runs:
        reference = (layered_reference if schedule == "layered"
                     else flooding_reference)
        for words in kernel_microbench.DECODER_WORDS:
            llr = kernel_microbench.decoder_input(words, mi, 0, dev)
            kern = make_static_sweep_decoder(code, mi, store_dtype=store,
                                             schedule=schedule,
                                             device=dev)(llr)
            plain = reference(llr, plan, mi, store_dtype=store)
            sync(dev)
            c = compare(kern, plain)
            log("12microbench", f"(a) fused {schedule} {store}, {words} words "
                f"0 dB {mi} it: {c['mismatched']} words differ from the "
                f"plain version, converged {int(kern[2].sum())}/{words}")
            if c["mismatched"]:
                raise AssertionError(f"fused {schedule} {store} at {words} "
                                     f"words, 0 dB: {c['mismatched']} words "
                                     "differ from the plain version")
    clear_launches()
    res = kernel_microbench.main(MB_ARGS)
    got = record_path(MB_PATH)
    missing = [n for n in microbench.NAMES if not got.get(("microbench", n))]
    missing += [s for s in kernel_microbench.DECODER_STORES
                if not got.get(key("min-sum", s))]
    missing += [s for s in kernel_microbench.LAYERED_STORES
                if not got.get(key("min-sum", s, "layered"))]
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
    lo, words = kernel_microbench.DECODER_WORDS[0], res["model"]["words"]
    log("12microbench", f"(b) fused kernel (B1), us an iteration at {lo} "
        f"and {words} words, measured / model: " + "; ".join(
            f"{s} {res[kernel_microbench.decoder_key(s, lo)]:.3f}, "
            f"{res[kernel_microbench.decoder_key(s, words)]:.3f}, "
            f"{res['model'][f'measured_over_model_{s}']:.3f}"
            for s in kernel_microbench.DECODER_STORES))
    log("12microbench", f"(b) fused kernel, layered (B3), us a sweep at {lo} "
        f"and {words} words: " + "; ".join(
            f"{s} {res[kernel_microbench.decoder_key(s, lo, 'layered')]:.3f}, "
            f"{res[kernel_microbench.decoder_key(s, words, 'layered')]:.3f}"
            for s in kernel_microbench.LAYERED_STORES))
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


def _agent_actions(env, steps: int, seed: int) -> list:
    """The random agent's actions (rl/random_agent.py) for ``steps`` steps
    of ``env``'s shape."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        x = rng.randint(0, env.state.block_rows)
        y = rng.randint(0, env.state.block_cols)
        k = int(rng.choice(tuple(range(3, 8))))
        row = np.zeros(env.z, np.int32)
        row[rng.choice(env.z, k, replace=False)] = 1
        out.append(np.concatenate([
            [int(b) for b in np.binary_repr(x, env.x_bits)],
            [int(b) for b in np.binary_repr(y, env.y_bits)], row]).astype(
                np.int32))
    return out


def phase_env(dev) -> dict:
    """The code search: (a) `random-agent`, (b) its codes and LLRs through
    the kernel, its plain version and ops/dynamic.py, (c) a vector env
    batched against sequential, (d) a deep step under the profiler, (e)
    the split of a step's time."""
    from ldpc_tpu_torch.envs import EnvironmentVector, LdpcCodeSearchEnv
    from ldpc_tpu_torch.envs.code_search import DecodeCounts, _to_host
    from ldpc_tpu_torch.ops.dynamic import dynamic_plan, make_dynamic_decoder
    from ldpc_tpu_torch.sim.reward import BAD_CANDIDATE_REWARD, calc_reward
    tag = "13env"
    # (a) the CLI's random agent; each decoded batch is recorded, and each
    # step's wall time (the step returns after its host read)
    seen, step_s = [], []
    decode_batched = LdpcCodeSearchEnv._decode_batched
    env_step = LdpcCodeSearchEnv.step

    def recording(self, code, llr):
        seen.append((code, llr.clone()))
        return decode_batched(self, code, llr)

    def timed(self, action):
        t0 = time.perf_counter()
        out = env_step(self, action)
        step_s.append(time.perf_counter() - t0)
        return out

    LdpcCodeSearchEnv._decode_batched = recording
    LdpcCodeSearchEnv.step = timed
    clear_launches()
    try:
        t0 = time.perf_counter()
        rewards = run_cli(dev, ["random-agent", "--steps", str(ENV_STEPS)])
        sync(dev)
        wall_a = time.perf_counter() - t0
    finally:
        LdpcCodeSearchEnv._decode_batched = decode_batched
        LdpcCodeSearchEnv.step = env_step
    got = record_path(ENV_PATHS["a"])
    legal = sum(r != BAD_CANDIDATE_REWARD for r in rewards)
    step_ms = float(np.median(step_s)) * 1e3
    log(tag, f"(a) random-agent --steps {ENV_STEPS}: rewards {rewards}; "
        f"{legal} legal steps, codec checked every step; {wall_a:.3f} s "
        f"with the CLI's set-up, {ENV_STEPS / wall_a:.4g} steps/s; a step "
        f"{step_ms:.3f} ms (median; first {step_s[0] * 1e3:.3f} ms), "
        f"{1e3 / step_ms:.4g} steps/s; launches {got}")
    if got.get(ENV_KEY, 0) != legal or len(seen) != legal:
        raise AssertionError(f"(a) {legal} legal steps, {len(seen)} "
                             f"decodes, launches {got}")
    if not all(np.isfinite(r) for r in rewards):
        raise AssertionError(f"(a) rewards {rewards}")
    # (b) the same codes and LLRs: kernel == plain on every word, kernel ==
    # ops/dynamic.py on converged words; (e) a step's time, piece by piece
    scratch = LdpcCodeSearchEnv(device=dev)
    snr_per_word = np.repeat(scratch.snr_points, scratch.tx_counts)
    sigma = torch.as_tensor(np.sqrt(0.5 / 10 ** (snr_per_word / 10)),
                            dtype=torch.float32, device=dev)
    split = collections.defaultdict(list)
    bounds = []
    worst = {"mismatched": 0, "mismatched_converged_dynamic": 0,
             "mismatched_dynamic": 0, "max_abs_err": 0, "words": 0,
             "converged": 0, "max_check_degree": 0}
    for code, llr in seen:
        t0 = time.perf_counter()
        plan = DecodePlan.from_code(code)
        tables = cuda_static.kernel_tables(plan)
        t1 = time.perf_counter()
        dev_tables = torch.as_tensor(tables, device=dev)
        sync(dev)
        t2 = time.perf_counter()
        split["plan_and_tables_ms"].append((t1 - t0) * 1e3)
        split["upload_ms"].append((t2 - t1) * 1e3)
        del dev_tables
        dec = make_static_sweep_decoder(code, MAX_ITERS,
                                        store_dtype="float32", device=dev)
        kern = dec(llr)
        split["kernel_ms"].append(time_ms(lambda: dec(llr), dev, reps=5))
        bounds.append(bound_ms(llr.shape[0], code.n, code.num_edges,
                               kern[1], kern[2], MAX_ITERS))
        plain = flooding_reference(llr, plan, MAX_ITERS,
                                   store_dtype="float32")
        res = make_dynamic_decoder(code.z, code.block_rows, code.block_cols,
                                   48, 18, MAX_ITERS)(
            dynamic_plan(code, 48, 18, device=dev), llr)
        dyn = (res.hard.sum(-1, dtype=torch.int32), res.iterations,
               res.success)
        c = compare(kern, plain)
        d = compare(kern, dyn)
        worst["mismatched"] += c["mismatched"]
        worst["mismatched_converged_dynamic"] += d["mismatched_converged"]
        worst["mismatched_dynamic"] += d["mismatched"]
        worst["max_abs_err"] = max(worst["max_abs_err"], c["max_abs_err"])
        worst["words"] += llr.shape[0]
        worst["converged"] += int(kern[2].sum())
        worst["max_check_degree"] = max(worst["max_check_degree"],
                                        plan.dmax_cn)
        sync(dev)
        t0 = time.perf_counter()
        sigma_actual = torch.sqrt(torch.mean((llr + 1.0) ** 2, dim=-1))
        host = _to_host(scratch._device_columns(llr, sigma, sigma_actual,
                                                DecodeCounts(*kern)))
        t1 = time.perf_counter()
        stats = scratch._stats_from_host(snr_per_word, host)
        scatter_snr, scatter_ber = stats.get_stats_v2()[:2]
        calc_reward(scatter_snr, scatter_ber, scratch.snr_points)
        t2 = time.perf_counter()
        split["read_ms"].append((t1 - t0) * 1e3)
        split["reward_fit_ms"].append((t2 - t1) * 1e3)
    log(tag, f"(b) {len(seen)} codes, {worst['words']} words (check degree "
        f"up to {worst['max_check_degree']}, {worst['converged']} "
        f"converged): kernel vs plain {worst['mismatched']} mismatched "
        "words; kernel vs ops/dynamic.py "
        f"{worst['mismatched_converged_dynamic']} mismatched words "
        "converged on either side, "
        f"{worst['mismatched_dynamic']} in all")
    if worst["mismatched"] or worst["mismatched_converged_dynamic"]:
        raise AssertionError(f"(b) the env's route disagrees: {worst}")
    med = {k: float(np.median(v)) for k, v in split.items()}
    kernel_bound = float(np.median([b for b, _ in bounds]))
    log(tag, "(e) a step of (a), median of its codes: " + ", ".join(
        f"{k} {v:.4f}" for k, v in med.items()) +
        f"; the step's wall time {step_ms:.3f} ms (a's median), of which "
        f"these sum to {sum(med.values()):.3f} ms; the kernel's bound "
        f"{kernel_bound:.5f} ms ({bounds[0][1]}; {seen[0][1].shape[0]} "
        "words a launch, one block a word)")
    # (c) a vector env, batched against sequential, the same actions; each
    # vector step ends in its host read, so the host clock times it
    vec = {}
    n_steps = ENV_VECTOR_STEPS + ENV_VECTOR_TIMED
    for mode, batched in (("c", True), ("c_seq", False)):
        env_fns = [(lambda s=s: LdpcCodeSearchEnv(seed=s, device=dev))
                   for s in range(ENV_VECTOR)]
        v = EnvironmentVector(env_fns, batched=batched)
        v.reset()
        acts = [_agent_actions(e, n_steps, 100 + k)
                for k, e in enumerate(v.envs)]
        clear_launches()
        steps, secs = [], []
        for t in range(n_steps):
            t0 = time.perf_counter()
            steps.append(v.step([a[t] for a in acts]))
            secs.append(time.perf_counter() - t0)
        launches = record_path(ENV_PATHS[mode])
        med_s = float(np.median(secs))
        vec[mode] = {"steps": steps, "step_s": secs, "launches": launches,
                     "envs": v.envs, "env_steps_per_s": ENV_VECTOR / med_s}
        log(tag, f"(c) {ENV_VECTOR} envs x {n_steps} steps, "
            f"batched={batched}: a vector step {med_s * 1e3:.3f} ms "
            f"(median; quartiles {np.percentile(secs, 25) * 1e3:.3f}, "
            f"{np.percentile(secs, 75) * 1e3:.3f}), "
            f"{vec[mode]['env_steps_per_s']:.4g} env steps/s; launches "
            f"{launches}")
    for (o1, r1, d1, i1), (o2, r2, d2, i2) in zip(vec["c"]["steps"],
                                                   vec["c_seq"]["steps"]):
        if not (np.array_equal(o1, o2) and np.array_equal(r1, r2) and
                list(d1) == list(d2)):
            raise AssertionError("(c) batched and sequential steps differ")
    if any(a.state != b.state or
           a.accumulated_iterations != b.accumulated_iterations
           for a, b in zip(vec["c"]["envs"], vec["c_seq"]["envs"])):
        raise AssertionError("(c) batched and sequential states differ")
    if vec["c"]["launches"].get(ENV_KEY, 0) == 0:
        raise AssertionError("(c) the batched vector step ran no kernel")
    log(tag, f"(c) batched == sequential on all {n_steps} steps: rewards "
        f"of the first {ENV_VECTOR_STEPS} "
        f"{[s[1].tolist() for s in vec['c']['steps'][:ENV_VECTOR_STEPS]]}")
    # (d) one deep step under the profiler
    deep = LdpcCodeSearchEnv(num_transmissions=ENV_DEEP_TX, device=dev)
    # profile_call steps twice (the first warms the tracer up): a new code
    # each time, so the recorded step builds its plan and tables too.  A
    # warmed-up trace has dropped this step's kernel launch on the H100:
    # then the step is traced again, up to ENV_TRACES times in all
    clear_launches()
    for attempt in range(1, ENV_TRACES + 1):
        actions = iter(_agent_actions(deep, 2, 6 + attempt))
        prof = profile_call(dev, lambda: deep.step(next(actions)), tag,
                            f"(d) one step of {sum(ENV_DEEP_TX)} words, "
                            f"trace {attempt}")
        if prof["measured"]:
            break
    launches = record_path(ENV_PATHS["d"])
    if launches.get(ENV_KEY, 0) == 0:
        raise AssertionError("(d) the deep step ran no kernel")
    stats = deep.ber_stats
    fer = {float(snr): float(stats.column("frame_errors")[
        stats.column("snr") == snr].sum() / n)
        for snr, n in zip(deep.snr_points, ENV_DEEP_TX)}
    log(tag, f"(d) FER by point {fer}; iterations "
        f"{int(stats.column('iterations').sum())}; launches {launches}")
    return {"rewards": rewards, "steps_per_s": 1e3 / step_ms,
            "cli_steps_per_s": ENV_STEPS / wall_a, "step_ms": step_ms,
            "split_ms": med, "kernel_bound_ms": kernel_bound,
            "check": worst,
            "vector_env_steps_per_s": {
                m: vec[m]["env_steps_per_s"] for m in vec},
            "deep": {**prof, "fer": fer, "traces": attempt}}


def _train_run(dev, data_dir, epochs: int, resume: bool = False):
    """``cli train`` with phase 14's arguments; returns (actor, critic,
    logger) and its steps.tsv."""
    import pathlib
    argv = ["train", "--num_envs", str(TRAIN_ENVS), "--steps",
            str(TRAIN_STEPS), "--seed", "30", "--epochs", str(epochs),
            "--data_dir", str(data_dir)] + (["--resume"] if resume else [])
    out = run_cli(dev, argv)
    steps = pathlib.Path(data_dir) / "ppo" / "ppo_s30" / "steps.tsv"
    return out, steps.read_bytes()


def _saturated_rows(weight: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """A first layer's units whose gradient sits at rounding level: |a| >=
    7.5 on every row and < 9.1 on some (tests/test_torch_ppo.py)."""
    a = (obs @ weight.t()).abs()
    return (a >= 7.5).all(0) & (a.min(0).values < 9.1)


def _grad_excess(got: dict, want: dict) -> tuple:
    """(the largest |card - CPU| over its tolerance, GRAD_RTOL x |CPU| +
    GRAD_ATOL x the tensor's largest |CPU|, and the largest |card - CPU|
    over the tensor's largest |CPU|), over every parameter's gradient; a
    parameter with a gradient on one side only is infinitely apart."""
    worst, rel = 0.0, 0.0
    for k, w in want.items():
        g = got[k]
        if g is None or w is None:
            if (g is None) != (w is None):
                return float("inf"), float("inf")
            continue
        scale = float(w.abs().max())
        diff = (g - w).abs()
        tol = GRAD_RTOL * w.abs() + GRAD_ATOL * scale
        worst = max(worst, float((diff / tol.clamp_min(1e-30)).max()))
        rel = max(rel, float(diff.max()) / max(scale, 1e-30))
    return worst, rel


def _policy_check(dev, actor, critic, obs_np) -> dict:
    """The trained policy on the card against the same weights on the CPU:
    evaluate_actions, mode, and one update step: its extras, its
    gradients and the parameters after it."""
    from ldpc_tpu_torch.rl import (Actor, Critic, PPOConfig, env_generators,
                                   evaluate_actions, make_update_fns,
                                   sample_step)
    cfg = actor.cfg
    nets = {"cuda": (actor, critic)}
    cpu_a, cpu_c = Actor(cfg), Critic(cfg)
    cpu_a.load_state_dict({k: v.cpu() for k, v in actor.state_dict().items()})
    cpu_c.load_state_dict({k: v.cpu()
                           for k, v in critic.state_dict().items()})
    nets["cpu"] = (cpu_a, cpu_c)
    b = obs_np.shape[0]
    obs = torch.tensor(obs_np)
    loose = {}
    for name, lr, layer in (("actor.encoder.dense.0", 3e-4,
                             cpu_a.encoder.dense[0]),
                            ("critic.mlp.dense.0", 1e-3,
                             cpu_c.mlp.dense[0])):
        rows = _saturated_rows(layer.weight.detach(), obs)
        loose[name + ".weight"] = loose[name + ".bias"] = (rows, lr)
    rng = np.random.default_rng(SEED)
    act = sample_step(cfg, actor, critic, obs.to(dev),
                      env_generators(SEED, b, dev))[0].cpu()
    adv = torch.tensor(rng.standard_normal(b).astype(np.float32))
    ret = torch.tensor(rng.standard_normal(b).astype(np.float32))
    res = {}
    for side, (a, c) in nets.items():
        d = torch.device(dev if side == "cuda" else "cpu")
        o, ac = obs.to(d), act.to(d)
        ev = evaluate_actions(cfg, a, o, ac)
        mode = sample_step(cfg, a, c, o, deterministic=True)[0].cpu()
        logp_old = ev["logp"].detach()
        pi_opt, vf_opt, pi_up, v_up = make_update_fns(cfg, PPOConfig())
        ex = pi_up(a, pi_opt(a.parameters()), o, ac, adv.to(d), logp_old)
        ex["loss_v"] = v_up(c, vf_opt(c.parameters()), o, ret.to(d))
        # the step's gradients: the updates leave them in .grad
        grads = {f"{net}.{k}": None if p.grad is None else p.grad.cpu()
                 for net, m in (("actor", a), ("critic", c))
                 for k, p in m.named_parameters()}
        res[side] = {"ev": {k: v.detach().cpu() for k, v in ev.items()},
                     "mode": mode, "grads": grads,
                     "extras": {k: float(v) for k, v in ex.items()},
                     "params": {**{"actor." + k: v.detach().cpu()
                                   for k, v in a.state_dict().items()},
                                **{"critic." + k: v.detach().cpu()
                                   for k, v in c.state_dict().items()}}}
    g, w = res["cuda"], res["cpu"]
    ev_err = max(float(((g["ev"][k] - w["ev"][k]).abs() - POLICY_RTOL *
                        w["ev"][k].abs()).max()) for k in w["ev"])
    mode_equal = torch.equal(g["mode"], w["mode"])
    # relative above 1 (EXTRAS_ATOL's comment)
    ex_err = {k: abs(g["extras"][k] - w["extras"][k]) / max(
        1.0, abs(w["extras"][k])) for k in w["extras"]}
    grad_excess, grad_rel = _grad_excess(g["grads"], w["grads"])
    param_err, wide = 0.0, 0
    for k, v in w["params"].items():
        diff = (g["params"][k] - v).abs()
        tol = torch.full(diff.shape[:1], PARAM_ATOL)
        if k in loose:
            rows, lr = loose[k]
            tol[rows] = lr
            wide += int(rows.sum())
        tol = tol.reshape((-1,) + (1,) * (diff.ndim - 1))
        param_err = max(param_err, float((diff - tol).max()))
    out = {"words": b, "evaluate_excess": ev_err, "mode_equal": mode_equal,
           "extras_err": ex_err, "extras": w["extras"],
           "grad_excess": grad_excess, "grad_rel_err": grad_rel,
           "param_excess": param_err, "saturated_units": wide // 2}
    if not (ev_err <= POLICY_ATOL and mode_equal and param_err <= 0.0
            and max(ex_err.values()) <= EXTRAS_ATOL
            and grad_excess <= 1.0):
        raise AssertionError(f"(c) the policy on the card and on the CPU "
                             f"differ: {out}")
    return out


def phase_trainer(dev) -> dict:
    """The PPO trainer: (a) `cli train` at full width, and 2 epochs resumed
    to 3, byte for byte; (b) the run's legal candidates through the
    kernel and its plain version; (c) the policy on the card against the
    CPU; (d) env steps/s batched and sequential, and their split."""
    import copy
    import functools
    import importlib
    import tempfile
    from ldpc_tpu_torch.envs import EnvironmentVector, LdpcCodeSearchEnv
    from ldpc_tpu_torch.rl import (PPOConfig, env_generators,
                                   evaluate_actions, make_update_fns,
                                   sample_step)
    from ldpc_tpu_torch.sim.reward import BAD_CANDIDATE_REWARD
    ppo_mod = importlib.import_module("ldpc_tpu_torch.rl.ppo")
    train_mod = importlib.import_module("ldpc_tpu_torch.rl.train")
    tag = "14train"
    seen, times = [], collections.defaultdict(list)
    orig = {"decode": LdpcCodeSearchEnv._decode_batched,
            "vstep": EnvironmentVector.step,
            "sample": ppo_mod.sample_step,
            "fns": ppo_mod.make_update_fns,
            "dump": ppo_mod.EpochLogger.dump_tabular,
            "ppo": train_mod.ppo}

    def recording(self, code, llr):
        seen.append((code, llr.clone()))
        return orig["decode"](self, code, llr)

    def timed(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(dev)
            times[name].append((t0, time.perf_counter() - t0))
            return out
        return wrapped

    def timed_loop(name, fn, n):
        """``fn`` called ``n`` times in a row, timed as one span and
        synchronised after the last call only: the trainer queues its
        value steps and reads their loss once, after the loop."""
        span = {"calls": 0, "t0": 0.0}

        def wrapped(*a, **k):
            if span["calls"] % n == 0:
                span["t0"] = time.perf_counter()
            out = fn(*a, **k)
            span["calls"] += 1
            if span["calls"] % n == 0:
                sync(dev)
                times[name].append((span["t0"],
                                    time.perf_counter() - span["t0"]))
            return out
        return wrapped

    def update_fns(ac_cfg, ppo_cfg, *a, **k):
        pi_opt, vf_opt, pi_up, v_up = orig["fns"](ac_cfg, ppo_cfg, *a, **k)
        return (pi_opt, vf_opt, timed("pi_update", pi_up),
                timed_loop("v_update", v_up, ppo_cfg.train_v_iters))

    def dump_times(self):
        times["epoch_end"].append(time.perf_counter())
        times["epoch_decodes"].append(len(seen))
        return orig["dump"](self)

    def instrumented(run):
        """``run()`` with the env step, the sampling, the updates and each
        epoch's end timed.  Each call is synchronised where the host reads
        its result right after anyway (the sampled actions, the env's
        rewards, the policy step's KL), and the value loop once, at its
        end, so the run makes no wait that the trainer alone does not."""
        times.clear()
        seen.clear()
        LdpcCodeSearchEnv._decode_batched = recording
        EnvironmentVector.step = timed("env_step", orig["vstep"])
        ppo_mod.sample_step = timed("sample", orig["sample"])
        ppo_mod.make_update_fns = update_fns
        ppo_mod.EpochLogger.dump_tabular = dump_times
        try:
            t0 = time.perf_counter()
            out = run()
            wall = time.perf_counter() - t0
        finally:
            LdpcCodeSearchEnv._decode_batched = orig["decode"]
            EnvironmentVector.step = orig["vstep"]
            ppo_mod.sample_step = orig["sample"]
            ppo_mod.make_update_fns = orig["fns"]
            ppo_mod.EpochLogger.dump_tabular = orig["dump"]
        return out, wall, {k: list(v) for k, v in times.items()}

    envs, steps = TRAIN_ENVS, TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        # (a) cli train, sequential vector steps (the CLI's default)
        clear_launches()
        ((actor, critic, _), tsv), wall, t_seq = instrumented(
            lambda: _train_run(dev, f"{tmp}/full", TRAIN_EPOCHS))
        got = record_path(TRAIN_PATHS["a"])
        rows = [r.split(b"\t") for r in tsv.splitlines()[1:]]
        legal = sum(float(r[3]) != BAD_CANDIDATE_REWARD for r in rows)
        log(tag, f"(a) cli train --num_envs {envs} --steps {steps} "
            f"--epochs {TRAIN_EPOCHS}: {len(rows)} env steps ({legal} legal), "
            f"{wall:.3f} s with set-up; rewards of epoch 0 "
            f"{[round(float(r[3]), 4) for r in rows[:4]]}...; launches {got}")
        if len(rows) != envs * steps * TRAIN_EPOCHS:
            raise AssertionError(f"(a) {len(rows)} rows in steps.tsv")
        if got.get(ENV_KEY, 0) == 0 or got.get(ENV_KEY, 0) != legal:
            raise AssertionError(f"(a) {legal} legal steps, launches {got}")
        cands, in_epoch0 = list(seen), t_seq["epoch_decodes"][0]
        if len(cands) != legal:
            raise AssertionError(f"(a) {len(cands)} decodes recorded for "
                                 f"{legal} legal steps")
        # the same run in two pieces, the second resumed from a checkpoint;
        # the first piece hooked at each epoch's end only, for an epoch
        # time with no timing hook inside the epoch
        clear_launches()
        plain_ends = []

        def dump_only(self):
            plain_ends.append(time.perf_counter())
            return orig["dump"](self)
        ppo_mod.EpochLogger.dump_tabular = dump_only
        try:
            _train_run(dev, f"{tmp}/split", TRAIN_SPLIT)
        finally:
            ppo_mod.EpochLogger.dump_tabular = orig["dump"]
        _, split = _train_run(dev, f"{tmp}/split", TRAIN_EPOCHS, resume=True)
        got_r = record_path(TRAIN_PATHS["a_resume"])
        if split != tsv:
            raise AssertionError("(a) the resumed run's steps.tsv differs "
                                 "from the uninterrupted run's")
        if got_r.get(ENV_KEY, 0) != legal:
            raise AssertionError(f"(a) split and resumed: {legal} legal "
                                 f"steps, launches {got_r}")
        log(tag, f"(a) {TRAIN_SPLIT} epochs resumed to {TRAIN_EPOCHS}: "
            f"steps.tsv equal byte for byte ({len(tsv)} bytes)")
        # (d) the same run with batched vector steps
        train_mod.ppo = functools.partial(orig["ppo"], env_batched=True)
        clear_launches()
        try:
            (_, tsv_b), wall_b, t_bat = instrumented(
                lambda: _train_run(dev, f"{tmp}/batched", TRAIN_EPOCHS))
        finally:
            train_mod.ppo = orig["ppo"]
        got_b = record_path(TRAIN_PATHS["d"])
        if tsv_b != tsv or got_b.get(ENV_KEY, 0) != legal:
            raise AssertionError(f"(d) batched steps.tsv equal: "
                                 f"{tsv_b == tsv}; launches {got_b}")
        obs_np = np.stack([np.frombuffer(bytes.fromhex(r[-1].decode()),
                                         np.uint8) for r in rows[:envs * steps]
                           ]).astype(np.float32)
    # (b) every legal candidate of (a)'s run, those of the first epoch
    # among them, kernel against its plain version
    worst = {"mismatched": 0, "max_abs_err": 0, "words": 0, "converged": 0,
             "max_check_degree": 0, "candidates": len(cands),
             "in_epoch_0": in_epoch0}
    for code, llr in cands:
        dec = make_static_sweep_decoder(code, MAX_ITERS,
                                        store_dtype="float32", device=dev)
        kern = dec(llr)
        plan = DecodePlan.from_code(code)
        c = compare(kern, flooding_reference(llr, plan, MAX_ITERS,
                                             store_dtype="float32"))
        worst["mismatched"] += c["mismatched"]
        worst["max_abs_err"] = max(worst["max_abs_err"], c["max_abs_err"])
        worst["words"] += llr.shape[0]
        worst["converged"] += int(kern[2].sum())
        worst["max_check_degree"] = max(worst["max_check_degree"],
                                        plan.dmax_cn)
    log(tag, f"(b) the run's {len(cands)} legal candidates ({in_epoch0} of "
        f"them in epoch 0), {worst['words']} words (check degree up to "
        f"{worst['max_check_degree']}, {worst['converged']} converged): "
        f"kernel vs plain {worst['mismatched']} mismatched words")
    if worst["mismatched"] or not in_epoch0:
        raise AssertionError(f"(b) the trainer's decodes disagree: {worst}")
    # (c) the trained policy, card against CPU
    pol = _policy_check(dev, actor, critic, obs_np)
    ex_err = {k: float(f"{v:.3g}") for k, v in pol["extras_err"].items()}
    log(tag, f"(c) {pol['words']} observations of epoch 0: evaluate_actions "
        f"within rtol {POLICY_RTOL} + {pol['evaluate_excess']:.3g} (atol "
        f"{POLICY_ATOL}), mode equal {pol['mode_equal']}; one update: "
        f"extras (CPU) {pol['extras']}, apart by {ex_err} (over max(1, "
        f"|CPU|); tolerance {EXTRAS_ATOL}); gradients at "
        f"{pol['grad_excess']:.3g} of their tolerance (rtol {GRAD_RTOL} + "
        f"{GRAD_ATOL} x each tensor's largest), apart by up to "
        f"{pol['grad_rel_err']:.3g} of the tensor's largest; parameters "
        f"within their tolerance, largest excess {pol['param_excess']:.3g} "
        f"({pol['saturated_units']} saturated first-layer units at lr)")
    # (d) one sampling step and one iteration of each update of the
    # trained nets under the profiler: device events and busy share
    cfg = actor.cfg
    obs_t = torch.tensor(obs_np, device=dev)
    gens = env_generators(SEED, envs, dev)
    a2, c2 = copy.deepcopy(actor), copy.deepcopy(critic)
    act_t = sample_step(cfg, a2, c2, obs_t, env_generators(
        SEED, obs_t.shape[0], dev))[0]
    logp_t = evaluate_actions(cfg, a2, obs_t, act_t)["logp"].detach()
    adv_t = torch.linspace(-1, 1, obs_t.shape[0], device=dev)
    pi_opt, vf_opt, pi_up, v_up = make_update_fns(cfg, PPOConfig())
    pi_opt, vf_opt = pi_opt(a2.parameters()), vf_opt(c2.parameters())
    profiled = {
        "sample": profile_call(
            dev, lambda: sample_step(cfg, actor, critic, obs_t[:envs], gens),
            tag, f"(d) one sampling step, {envs} envs"),
        "pi_update": profile_call(
            dev, lambda: float(pi_up(a2, pi_opt, obs_t, act_t, adv_t,
                                     logp_t)["kl"]), tag,
            f"(d) one policy update iteration, {obs_t.shape[0]} steps"),
        "v_update": profile_call(
            dev, lambda: float(v_up(c2, vf_opt, obs_t, adv_t)), tag,
            f"(d) one value update iteration, {obs_t.shape[0]} steps")}
    for name, p in profiled.items():
        log(tag, f"(d) {name}: {p['device_events']} device events, "
            f"{p['wall_ms']:.3f} ms wall, device busy {p['busy_ms']:.3f} ms")
    # (d) the measurements: each epoch after the first (which warms up)
    # from the end of the one before to its own end, split by the timed
    # calls that started in it; medians over those epochs
    meas, v_iters = {}, PPOConfig().train_v_iters
    for mode, t, w in (("sequential", t_seq, wall), ("batched", t_bat,
                                                      wall_b)):
        ends = t["epoch_end"]
        split = collections.defaultdict(list)
        for lo, hi in zip(ends[:-1], ends[1:]):
            split["epoch"].append(hi - lo)
            for name in ("sample", "env_step", "pi_update", "v_update"):
                calls = [d for t0, d in t[name] if lo < t0 <= hi]
                split[name].append(sum(calls))
                split[name + "_calls"].append(len(calls))
        m = {k: float(np.median(v)) for k, v in split.items()}
        roll = m["sample"] + m["env_step"]
        meas[mode] = {
            "env_steps_per_s": envs * steps / m["epoch"],
            "rollout_env_steps_per_s": envs * steps / roll,
            "sample_ms_per_step": m["sample"] / steps * 1e3,
            "env_step_ms_per_step": m["env_step"] / steps * 1e3,
            "pi_update_ms_per_epoch": m["pi_update"] * 1e3,
            "pi_iterations": m["pi_update_calls"],
            "v_update_ms_per_epoch": m["v_update"] * 1e3,
            "rest_ms_per_epoch": (m["epoch"] - roll - m["pi_update"] -
                                  m["v_update"]) * 1e3,
            "epoch_s": m["epoch"], "wall_s": w}
        r = meas[mode]
        if mode == "sequential":
            # epoch 1 of the split run's first piece, hooked at dump only
            r["unhooked_epoch_s"] = plain_ends[1] - plain_ends[0]
            r["unhooked_env_steps_per_s"] = rate = (
                envs * steps / r["unhooked_epoch_s"])
            log(tag, f"(d) sequential, hooked only at each epoch's end "
                f"(the split run's epoch 1): {rate:.4g} env steps/s "
                f"({r['unhooked_epoch_s']:.4f} s)")
        log(tag, f"(d) {mode}: {r['env_steps_per_s']:.4g} env steps/s "
            f"(an epoch of {envs} x {steps} env steps and its update: "
            f"{m['epoch']:.4f} s, median of epochs 1-{TRAIN_EPOCHS - 1}); "
            f"the rollout alone {r['rollout_env_steps_per_s']:.4g} env "
            f"steps/s; a step: sampling {r['sample_ms_per_step']:.3f} ms, "
            f"the vector env step {r['env_step_ms_per_step']:.3f} ms; an "
            f"epoch: policy update {r['pi_update_ms_per_epoch']:.1f} ms "
            f"({r['pi_iterations']:.0f} iterations), value update "
            f"{r['v_update_ms_per_epoch']:.1f} ms ({v_iters} iterations, "
            f"one span), the rest {r['rest_ms_per_epoch']:.1f} ms; "
            f"{w:.3f} s in all")
    return {"launches": {p: PATH_LAUNCHES[p].get(ENV_KEY, 0)
                         for p in TRAIN_PATHS.values()},
            "check": worst, "policy": pol, "measured": meas,
            "profiled": profiled, "steps_tsv": tsv}


def _overlap(a, b) -> bool:
    """Whether the intervals a = (lo, hi) and b = (lo, hi) overlap."""
    return a[0] <= b[1] and b[0] <= a[1]


def _in_band(ber: float, half: float, ref) -> bool:
    """Whether a BER and its 95% CI lie within a reference point's band
    (the two CIs overlap; two zero points agree)."""
    return abs(ber - ref[0]) <= half + ref[1] or ber == ref[0] == 0.0


def _val_record(path: str, keys) -> dict:
    """The launches of a validation path just run; fails unless each kernel
    variant of ``keys`` was launched."""
    got = record_path(path)
    missing = [k for k in keys if got.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{path}: no launch of {missing} ({got})")
    return got


def _val_encoder(dev, tag: str) -> dict:
    """(a) 4,096 random messages each for near-earth (the generator),
    802.11n rate 1/2 (parity_part_from_h) and a rank-deficient code (the
    column-pivoted path): every syndrome zero on the card, from the plan's
    sparse tables, and every codeword equal to the CPU's."""
    from ldpc_tpu_torch.codes.encode import encoder_for_code
    from ldpc_tpu_torch.codes.perturb import zero_circulant
    from ldpc_tpu_torch.ops.plan import frame_indices
    codes = {"near-earth (generator)": near_earth_code(),
             "802.11n r1/2 (parity part)": wifi_code(1944, 1 / 2),
             "near-earth, block (0, 0) zeroed (column-pivoted)":
                 zero_circulant(near_earth_code(), 0, 0)}
    out = {}
    for i, (name, code) in enumerate(codes.items()):
        enc = encoder_for_code(code)
        prefix = np.array_equal(enc.info_positions, np.arange(enc.k_eff))
        path = ("generator" if code.shifts == near_earth_code().shifts
                else "prefix" if prefix else "column-pivoted")
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        msgs = torch.randint(0, 2, (VAL_ENCODE_WORDS, enc.k_eff),
                             generator=gen, dtype=torch.int8, device=dev)
        cw = enc(msgs)
        f = frame_indices(DecodePlan.from_code(code))
        var = torch.as_tensor(f["var_idx"], device=dev)
        valid = torch.as_tensor(f["cn_valid"], device=dev)
        parity = ((cw[:, var].long() * valid).sum(-1) % 2)
        bad_syn = int(parity.any(-1).sum())
        info = torch.as_tensor(enc.info_positions, device=dev)
        bad_msg = int((cw[:, info] != msgs).any(-1).sum())
        cpu = enc(msgs.cpu())
        bad_cpu = int((cw.cpu() != cpu).sum())
        out[name] = {"k_eff": enc.k_eff, "path": path,
                     "nonzero_syndromes": bad_syn,
                     "message_mismatches": bad_msg,
                     "bits_differing_from_cpu": bad_cpu}
        log(tag, f"(a) {name}: k_eff {enc.k_eff} ({path}), "
            f"{VAL_ENCODE_WORDS} words: {bad_syn} nonzero syndromes (plan "
            f"tables), {bad_msg} messages altered, {bad_cpu} bits differing "
            f"from the CPU's")
        if path != ("generator", "prefix", "column-pivoted")[i]:
            raise AssertionError(f"{name}: encoded by the {path} path")
        if bad_syn or bad_msg or bad_cpu:
            raise AssertionError(f"encoder {name}: {out[name]}")
    enc = encoder_for_code(near_earth_code())
    msgs = torch.randint(0, 2, (VAL_ENCODE_TIMED, enc.k_eff),
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED), dtype=torch.int8, device=dev)
    ms = time_ms(lambda: enc(msgs), dev, reps=KERNEL_REPS)
    out["near_earth_ms"] = ms
    log(tag, f"(a) near-earth encoder, {VAL_ENCODE_TIMED} messages: {ms:.3f} "
        f"ms (a [{VAL_ENCODE_TIMED}, {enc.k_eff}] x [{enc.k_eff}, 1022] "
        "float32 product, % 2, two scatters)")
    return out


def _val_sorted(dev, code, tag: str) -> dict:
    """(c) the main path's cascade with and without sort_words from the
    same generator state: every output equal, each point's branch."""
    kw = dict(phase1_iters=PHASE1_ITERS, redo_capacity=REDO_CAP,
              engine="cuda", device=dev)
    plain = make_staged_sweep_device(code, MAX_ITERS, **kw)
    sort = make_staged_sweep_device(code, MAX_ITERS, sort_words=True, **kw)
    out = {}
    clear_launches()
    for snr, branch in VAL_SORT_SNRS.items():
        snr_db = torch.full((BATCH,), snr, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + int(snr * 10))
        state = gen.get_state()
        want = plain(snr_db, generator=gen)
        got_branch = plain.decoder.last_branches
        gen.set_state(state)
        got = sort(snr_db, generator=gen)
        bad = {k: int((want[k] != got[k]).sum()) for k in want}
        out[snr] = {"branch": got_branch, "differing": bad,
                    "failures": int((~want["success"]).sum())}
        log(tag, f"(c) {snr} dB, {BATCH} words: branch {got_branch} (sorted "
            f"{sort.decoder.last_branches}), outputs differing {bad}")
        if any(bad.values()) or got_branch != [branch] or \
                sort.decoder.last_branches != [branch]:
            raise AssertionError(f"sort_words at {snr} dB: {out[snr]}")
    out["launches"] = _val_record(VAL_PATHS["c"],
                                  [key("min-sum", "bfloat16")])
    return out


def _val_staged_counts(dev, code, tag: str) -> dict:
    """(d) staged_decode_counts(pad_to=256) on the cuda engine against the
    cascade on the same LLRs, above and below 25% stage-1 failures."""
    from ldpc_tpu_torch.sim.evaluate import staged_decode_counts
    # capacity B/4: the cascade's branch is "many" exactly where
    # staged_decode_counts decodes the whole batch again (> 25% failures)
    cascade = StagedDecoder(code, MAX_ITERS, phase1_iters=PHASE1_ITERS,
                            redo_capacity=BATCH // 4, engine="cuda",
                            device=dev)
    out = {}
    clear_launches()
    for snr in VAL_SORT_SNRS:
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + int(snr))
        llr = llr_batch(code, BATCH, snr, gen, dev)
        want = [x.cpu().numpy() for x in cascade(llr)]
        got = staged_decode_counts(code, llr, MAX_ITERS,
                                   phase1_iters=PHASE1_ITERS,
                                   pad_to=VAL_PAD_TO, engine="cuda")
        bad = sum(int((np.asarray(a) != b).sum()) for a, b in zip(got, want))
        out[snr] = {"branch": cascade.last_branches, "differing": bad}
        log(tag, f"(d) {snr} dB, {BATCH} words: cascade branch "
            f"{cascade.last_branches}; staged_decode_counts(pad_to="
            f"{VAL_PAD_TO}) differs on {bad} outputs")
        if bad:
            raise AssertionError(f"staged_decode_counts at {snr} dB: {bad}")
    if [out[s]["branch"] for s in VAL_SORT_SNRS] != [["many"], ["few"]]:
        raise AssertionError(f"(d) wants a batch above and one below 25% "
                             f"failures: {out}")
    out["launches"] = _val_record(VAL_PATHS["d"],
                                  [key("min-sum", "bfloat16")])
    return out


def phase_validation(dev) -> dict:
    """The Monte-Carlo validation path: (a) the encoder; (b) random
    codewords; (c) the sorted main path and sort_ab; (d)
    staged_decode_counts; (e) ber_parity; (f) the error floor and the
    802.11n waterfall on both engines; (g) cli getting-started.  Each study
    writes its artifact into a temporary directory that is removed."""
    import tempfile
    from ldpc_tpu_torch.scripts import (ber_parity, error_floor,
                                        random_codeword_check, sort_ab,
                                        wifi_waterfall)
    from ldpc_tpu_torch.sim.stats import wilson_interval
    tag = "15valid"
    code = near_earth_code()
    out = {}
    timed = {}

    def step(name, fn):
        t0 = time.perf_counter()
        res = fn()
        timed[name] = time.perf_counter() - t0
        return res

    out["encoder"] = step("a", lambda: _val_encoder(dev, tag))
    with tempfile.TemporaryDirectory() as tmp:
        # (b) random codewords, the torch engine (no kernel)
        rc = step("b", lambda: random_codeword_check.main(
            VAL_RC_ARGS + ["--out", f"{tmp}/random_codeword"]))
        for name, entry in rc["codes"].items():
            for pt in entry["points"]:
                z, r = pt["zero"], pt["random"]
                ref = JAX_RANDOM_ZERO[(name, pt["snr_db"])]
                band = _in_band(z["ber"], z["ci95_half"], ref)
                log(tag, f"(b) {name} {pt['snr_db']} dB, "
                    f"{rc['words_per_point']} words: zero {z['ber']:.4e} ± "
                    f"{z['ci95_half']:.1e}, random {r['ber']:.4e} ± "
                    f"{r['ci95_half']:.1e}: agree {pt['agree_within_ci']}; "
                    f"zero vs JAX {ref[0]:.4e} ± {ref[1]:.1e}: "
                    f"{'in band' if band else 'OUT OF BAND'}")
                if not (pt["agree_within_ci"] and band):
                    raise AssertionError(f"(b) {name} {pt['snr_db']} dB")
        out["random_codeword"] = rc

        # (c) the sorted main path, then sort_ab at its defaults
        out["sorted"] = step("c", lambda: _val_sorted(dev, code, tag))
        clear_launches()
        ab = step("c_ab", lambda: sort_ab.main(
            VAL_SORT_AB_ARGS + ["--out", f"{tmp}/sort_ab"]))
        _val_record(VAL_PATHS["c_ab"], [key("min-sum", "bfloat16")])
        log(tag, "(c) sort_ab: speedup sorted/unsorted " + ", ".join(
            f"{s} dB {r['speedup']:.4f}" for s, r in ab["points"].items())
            + f"; adopt {ab['adopt']} (threshold {ab['adopt_threshold']})")
        out["sort_ab"] = ab

        # (d) staged_decode_counts against the cascade
        out["staged_counts"] = step("d", lambda: _val_staged_counts(
            dev, code, tag))

        # (e) ber_parity: both engines on the same LLRs, the native engine
        clear_launches()
        bp = step("e", lambda: ber_parity.main(
            VAL_PARITY_ARGS + ["--out", f"{tmp}/ber_parity"]))
        _val_record(VAL_PATHS["e"], [key("min-sum", "bfloat16")])
        for snr_s, pt in bp["points"].items():
            ok = pt["fer_overlap"]
            for name, ref in zip(("torch_f32", "cuda_bf16"),
                                 JAX_PARITY[float(snr_s)]):
                e = pt[name]
                inb = _in_band(e["ber"], e["ber_ci95_half"], ref)
                ok &= inb
                log(tag, f"(e) {snr_s} dB {name}: BER {e['ber']:.4e} ± "
                    f"{e['ber_ci95_half']:.1e} FER {e['fer']:.5f} "
                    f"[{e['fer_ci95'][0]:.5f}, {e['fer_ci95'][1]:.5f}]; JAX "
                    f"{ref[0]:.4e} ± {ref[1]:.1e}: "
                    f"{'in band' if inb else 'OUT OF BAND'}")
            log(tag, f"(e) {snr_s} dB: engines' FER intervals overlap "
                f"{pt['fer_overlap']}, BERs agree {pt['engines_agree']}")
            if not ok:
                raise AssertionError(f"(e) {snr_s} dB: {pt}")
        nat = bp["native_crosscheck"]
        if not isinstance(nat, dict):
            raise AssertionError(f"(e) native engine: {nat}")
        nat_ok = abs(nat["ber"] - nat["torch_ber_same_words"]) <= \
            nat["ber_ci95_half"]
        log(tag, f"(e) native engine, {nat['words']} words at "
            f"{nat['snr_db']} dB: BER {nat['ber']:.4e} ± "
            f"{nat['ber_ci95_half']:.1e}, torch engine on the same words "
            f"{nat['torch_ber_same_words']:.4e}: "
            f"{'within' if nat_ok else 'OUTSIDE'} its CI; word-exact "
            f"{nat['word_exact_agreement']:.3f}, iterations "
            f"{nat['iters_exact_agreement']:.3f} (the JAX artifact's: "
            f"{JAX_NATIVE_AGREEMENT[0]:.3f}, {JAX_NATIVE_AGREEMENT[1]:.3f}); "
            f"{nat['cpu_seconds']:.1f} s on the host")
        if not nat_ok:
            raise AssertionError(f"(e) native engine: {nat}")
        out["ber_parity"] = bp

        # (f) the error floor at full size, then the waterfall twice
        clear_launches()
        fl = step("f_floor", lambda: error_floor.main(
            VAL_FLOOR_ARGS + ["--out", f"{tmp}/error_floor",
                              "--checkpoint", f"{tmp}/floor.npz"]))
        _val_record(VAL_PATHS["f_floor"], [key("min-sum", "bfloat16")])
        for pt in fl["points"]:
            ref = JAX_FLOOR_FER[pt["snr_db"]]
            ok = _overlap(pt["fer_wilson95"], ref)
            log(tag, f"(f) floor {pt['snr_db']} dB, {pt['words']} words: "
                f"BER {pt['ber']:.3e}, FER {pt['fer']:.3e} "
                f"[{pt['fer_wilson95'][0]:.2e}, {pt['fer_wilson95'][1]:.2e}]"
                f" vs JAX [{ref[0]:.2e}, {ref[1]:.2e}]: "
                f"{'overlap' if ok else 'DISJOINT'}")
            if not ok:
                raise AssertionError(f"(f) floor {pt}")
        log(tag, f"(f) error floor: {fl['elapsed_s']:.2f} s for "
            f"{len(fl['points'])} points")
        out["error_floor"] = fl
        out["wifi"] = {}
        for engine in ("torch", "cuda"):
            clear_launches()
            ww = step(f"f_wifi_{engine}", lambda: wifi_waterfall.main(
                VAL_WIFI_ARGS + ["--engine", engine,
                                 "--out", f"{tmp}/wifi_{engine}"]))
            if engine == "cuda":
                _val_record(VAL_PATHS["f_wifi"],
                            [key("sum-product", "float32")])
            for rate_s, pts in ww["rates"].items():
                for pt in pts:
                    frames = JAX_WIFI_FRAMES[rate_s][pt["snr_db"]]
                    ref = wilson_interval(frames, JAX_WIFI_WORDS)[1:]
                    ok = _overlap(pt["fer_ci95"], ref)
                    if not ok or frames:
                        log(tag, f"(f) waterfall {engine} r{rate_s} "
                            f"{pt['snr_db']} dB: FER {pt['fer']:.5f} "
                            f"[{pt['fer_ci95'][0]:.5f}, "
                            f"{pt['fer_ci95'][1]:.5f}] vs JAX "
                            f"[{ref[0]:.5f}, {ref[1]:.5f}]: "
                            f"{'overlap' if ok else 'DISJOINT'}")
                    if not ok:
                        raise AssertionError(f"(f) waterfall {engine} "
                                             f"r{rate_s} {pt}")
            log(tag, f"(f) waterfall, {engine} engine: every point "
                f"overlaps the JAX package's ({ww['elapsed_s']:.1f} s)")
            out["wifi"][engine] = ww

    # (g) the CLI's environment check on the card
    gs = step("g", lambda: cli.main(["getting-started"]))
    log(tag, f"(g) cli getting-started: {gs}")
    if gs["probe"] != "OK" or not gs["native"]:
        raise AssertionError(f"(g) getting-started: {gs}")
    log(tag, "seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in timed.items()))
    out["seconds"] = timed
    return out


def _sweep_counters(stats: BerStatistics) -> dict:
    """A sweep's counters, summed over its statistics' entries."""
    return {k: int(stats.column(k).sum()) for k in (
        "weight", "errors_uncoded", "errors_decoded", "iterations",
        "success", "frame_errors")}


def _par_sweep(dev, code, mesh, tag: str, main: dict) -> dict:
    """(a) each point of the main path's protocol (one batch of BATCH
    words, 12 -> 50, capacity REDO_CAP, the cuda engine) through
    evaluate_code and evaluate_code_sharded on a one-rank mesh, in turns
    (plain, sharded, sharded, plain): counters equal, bit/s of each.
    evaluate_code takes no redo capacity (its default, B/4 rounded to 128,
    is 8,192 here); a capacity changes a cascade's cost, never its
    outputs."""
    from ldpc_tpu_torch.parallel import evaluate_code_sharded
    kw = dict(staged=True, engine="cuda", batch_size=BATCH, seed=SEED,
              device=dev)
    # the group's first collective sets its communicator up: not timed
    evaluate_code_sharded(code, [SNR_POINTS[0]], 256, MAX_ITERS, mesh=mesh,
                          **dict(kw, batch_size=256))
    counts = collections.Counter()
    points = {}
    for snr in SNR_POINTS:
        secs = {"plain": [], "sharded": []}
        got = {}
        for name in ("plain", "sharded", "sharded", "plain"):
            clear_launches()
            t0 = time.perf_counter()
            if name == "plain":
                st = evaluate_code(code, [snr], BATCH, MAX_ITERS, **kw)
            else:
                st = evaluate_code_sharded(code, [snr], BATCH, MAX_ITERS,
                                           mesh=mesh,
                                           redo_capacity=REDO_CAP, **kw)
            sync(dev)
            secs[name].append(time.perf_counter() - t0)
            if name == "sharded":
                counts.update(cuda_static.launches)
            c = _sweep_counters(st)
            if got.setdefault(name, c) != c:
                raise AssertionError(f"(a) {snr} dB: {name} runs differ")
        if got["sharded"] != got["plain"]:
            raise AssertionError(f"(a) {snr} dB: sharded {got['sharded']} "
                                 f"!= evaluate_code {got['plain']}")
        rate = {k: BATCH * code.n / float(np.median(v))
                for k, v in secs.items()}
        points[snr] = {"counters": got["sharded"], "bit_per_s": rate,
                       "seconds": secs}
        ph4 = main["points"][snr]["bit_per_s"]
        log(tag, f"(a) {snr} dB: counters equal to evaluate_code's "
            f"({got['sharded']}); bit/s sharded {rate['sharded']:.6g}, "
            f"evaluate_code {rate['plain']:.6g} (ratio "
            f"{rate['sharded'] / rate['plain']:.4f}); phase 4's step "
            f"{ph4:.6g}")
    PATH_LAUNCHES[PAR_PATHS["a"]] = dict(counts)
    if counts.get(key("min-sum", "bfloat16"), 0) == 0:
        raise AssertionError(f"(a) the sharded sweep launched {counts}")
    return points


def _par_two_ranks(dev, code, mesh, tag: str) -> dict:
    """(b) dryrun_multichip(PAR_RANKS) at PAR_DRYRUN on a gloo group whose
    ranks share the card, held to the one-rank sharded step of (a)'s mesh
    on the same batch."""
    from ldpc_tpu_torch import dryrun
    from ldpc_tpu_torch.parallel import sharded_staged_sweep_step
    cfg = PAR_DRYRUN
    b = cfg["words_per_rank"] * PAR_RANKS
    cap = cfg["redo_capacity"] and cfg["redo_capacity"] * PAR_RANKS
    step = sharded_staged_sweep_step(
        code, mesh, cfg["max_iters"], phase1_iters=cfg["phase1_iters"],
        redo_capacity=cap, engine=cfg["engine"], device=dev)
    one = step(torch.full((b,), cfg["snr"], dtype=torch.float32,
                          device=dev),
               generator=torch.Generator(device=dev).manual_seed(
                   dryrun.DRYRUN_SEED))
    one = {k: one[k] for k in ("frames", "errors_uncoded", "errors_decoded",
                               "iterations_sum", "success_count",
                               "frame_errors")}
    t0 = time.perf_counter()
    reports = dryrun.dryrun_multichip(
        PAR_RANKS, device=None if dev.type == "cuda" else "cpu",
        backend="gloo", config=cfg, timeout_s=PAR_TIMEOUT_S)
    wall = time.perf_counter() - t0
    counts = collections.Counter()
    for r in reports:
        if r["staged"] != one:
            raise AssertionError(f"(b) rank {r['rank']}: {r['staged']} != "
                                 f"the one-rank step's {one}")
        for part in PAR_SHARDED_PARTS:
            for k, c in r["launches"].get(part, {}).items():
                kind, store, sched, pc = k.split(",")
                counts[(kind, store, sched, pc == "True")] += c
        log(tag, f"(b) rank {r['rank']} ({r['device']}, {r['backend']}): "
            f"seconds by part " + ", ".join(
                f"{p} {v:.3f}" for p, v in r["seconds"].items()) +
            f"; launches {r['launches']}")
    PATH_LAUNCHES[PAR_PATHS["b"]] = dict(counts)
    r0 = reports[0]
    log(tag, f"(b) {PAR_RANKS} ranks on one card, {b} {cfg['code']} words "
        f"at {cfg['snr']} dB: staged counters {r0['staged']} equal to the "
        f"one-rank step's; row-sharded decoder {r0['row_sharded']} equal "
        f"to the unsharded one; vector step of {r0['vector_step']['envs']} "
        f"envs equal to the unsharded step (rewards "
        f"{[round(x, 4) for x in r0['vector_step']['rewards']]}); "
        f"dryrun_train_step max parameter difference "
        f"{r0['train_step']['max_param_diff']:.3g}; {wall:.1f} s in all")
    for k in (key("min-sum", "bfloat16"), key("min-sum", "float32")):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"(b) no launch of {k}: {dict(counts)}")
    return {"one_rank": one, "reports": reports, "wall_s": wall}


def _par_cli_analysis(dev, tag: str, steps_tsv: bytes) -> dict:
    """(c) cli evaluate --sharded on near-earth, post-mortem and
    topk_select on phase 14's steps.tsv, and reward-surface."""
    import os
    import tempfile

    import importlib.util

    import pandas as pd
    from ldpc_tpu_torch.analysis import (action_heatmaps, reward_surface,
                                         topk_select)
    out = {}
    clear_launches()
    st = run_cli(dev, ["evaluate", "--sharded", "--code", "near-earth",
                       "--engine", "cuda", "--transmissions",
                       str(PAR_CLI_WORDS), "--batch-size",
                       str(PAR_CLI_WORDS)])
    got = record_path(PAR_PATHS["c_cli"])
    summ = st.summary()
    log(tag, f"(c) cli evaluate --sharded: BER {summ['ber']}, FER "
        f"{summ['fer']}, launches {got}")
    if summ["transmissions"] != PAR_CLI_WORDS * len(SNR_POINTS) or \
            got.get(key("min-sum", "bfloat16"), 0) == 0:
        raise AssertionError(f"(c) cli evaluate --sharded: {summ}, {got}")
    out["cli_evaluate"] = summ
    # the figures need matplotlib (and seaborn); where the machine has
    # none, the commands run without drawing, and the log says so
    plots = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        tsv = os.path.join(tmp, "steps.tsv")
        with open(tsv, "wb") as f:
            f.write(steps_tsv)
        t0 = time.perf_counter()
        pm = run_cli(dev, ["post-mortem", tsv, "--best"] +
                     (["--heatmaps"] if plots else []))
        pm_s = time.perf_counter() - t0
        grids = {k: list(v.shape) for k, v in action_heatmaps(tsv).items()}
        maps = [f"heatMap{c}.png" for c in "IJK"] if plots else []
        if not pm["best"] or not all(os.path.exists(os.path.join(tmp, m))
                                     for m in maps):
            raise AssertionError(f"(c) post-mortem: {pm}")
        log(tag, f"(c) cli post-mortem --best"
            f"{' --heatmaps' if plots else ''} on phase 14's steps.tsv: "
            f"{len(pm['best'])} best code(s), BER "
            f"{[b['ber'] for b in pm['best']]} ({pm_s:.2f} s); heat maps "
            f"{grids}" + ("" if plots else " (arrays only: no matplotlib "
                                           "on this machine, no figure)"))
        out["post_mortem"] = {**pm, "heatmaps": grids, "figures": plots}
        df = pd.read_csv(tsv, sep="\t", dtype={"observation_hex": str})
        pos = df[df["reward"] > 0]
        cands = min(PAR_TOPK_ARGS.get("topk", 8),
                    (pos if len(pos) else df)["observation_hex"].nunique())
        reeval = dict(PAR_TOPK_KW, **({} if dev.type == "cuda"
                                      else {"device": "cpu"}))
        clear_launches()
        t0 = time.perf_counter()
        _, rows = topk_select(tsv, reeval_kw=reeval, verbose=False,
                              **PAR_TOPK_ARGS)
        topk_s = time.perf_counter() - t0
        got = record_path(PAR_PATHS["c_topk"])
        log(tag, f"(c) topk_select(reeval_kw={PAR_TOPK_KW}): "
            f"{len(rows)} of {cands} candidates re-scored, "
            f"{cands - len(rows)} skipped; train -> re-evaluated reward " +
            ", ".join(f"{r['train_reward']:.4f} -> {r['reward_mean']:.5f}"
                      f" ± {r['reward_std']:.5f}" for r in rows) +
            f"; launches {got} ({topk_s:.2f} s)")
        if len(rows) != cands or not got:
            raise AssertionError(f"(c) topk_select skipped "
                                 f"{cands - len(rows)} of {cands}")
        out["topk"] = {"candidates": cands, "rows": [
            {k: r[k] for k in ("train_reward", "reward_mean", "reward_std",
                               "penalized")} for r in rows]}
        png = os.path.join(tmp, "rewardSurface.png")
        if plots:
            slope, _, _ = run_cli(dev, ["reward-surface", "--out", png])
            if not os.path.exists(png):
                raise AssertionError("(c) reward-surface wrote nothing")
        else:
            slope, _, _ = reward_surface()
        log(tag, f"(c) {'cli ' if plots else ''}reward-surface: a "
            f"{slope.shape} grid" + (" plotted" if plots else
                                     " (no matplotlib: not plotted)"))
    return out


def phase_parallel(dev, main: dict, steps_tsv: bytes) -> dict:
    """parallel/: (a) the sharded sweep on a one-rank group against
    evaluate_code; (b) two ranks on the card; (c) the CLI and the
    post-training analysis.  Every process group is destroyed at the
    end."""
    import torch.distributed as dist
    from ldpc_tpu_torch.parallel import make_mesh
    tag = "16parallel"
    code = near_earth_code()
    timed = {}
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(device=dev)
        log(tag, f"(a) one-rank mesh {mesh}, backend "
            f"{dist.get_backend()} ({time.perf_counter() - t0:.2f} s)")
        out = {}
        for name, fn in (
                ("a", lambda: _par_sweep(dev, code, mesh, tag, main)),
                ("b", lambda: _par_two_ranks(dev, code, mesh, tag)),
                ("c", lambda: _par_cli_analysis(dev, tag, steps_tsv))):
            t0 = time.perf_counter()
            out[name] = fn()
            timed[name] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log(tag, "seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in timed.items()))
    out["seconds"] = timed
    return out


def _cont_batch(b: int) -> dict:
    """A replay batch of ``b`` PointMassEnv transitions (uniform random
    actions, 512 stored), numpy."""
    from ldpc_tpu_torch.rl.continuous import PointMassEnv, ReplayBuffer
    env = PointMassEnv(seed=SEED)
    rng = np.random.RandomState(SEED)
    buf = ReplayBuffer(env.obs_dim, env.act_dim, 1024)
    obs = env.reset()
    for _ in range(512):
        a = rng.uniform(-1, 1, env.act_dim)
        obs2, r, done, _ = env.step(a)
        buf.store(obs, a, r, obs2, done)
        obs = env.reset() if done else obs2
    return buf.sample(rng, b)


def _grads_params(mods: dict) -> tuple[dict, dict]:
    """Every parameter's gradient (None where it has none) and value, on
    the CPU, named ``<module>.<parameter>``."""
    grads, params = {}, {}
    for m, mod in mods.items():
        for n, p in mod.named_parameters():
            grads[f"{m}.{n}"] = None if p.grad is None else p.grad.cpu()
            params[f"{m}.{n}"] = p.detach().cpu()
    return grads, params


def _cont_side(name: str, nets_cpu: dict, batch_np: dict, noise, dev):
    """One update of ``name`` (ddpg, td3, sac) on ``dev`` from copies of
    ``nets_cpu``, through the algorithm's own ``update`` (SAC with
    ``auto_alpha``): (losses, gradients, parameters after, lr by
    module)."""
    import copy
    import importlib
    from ldpc_tpu_torch.rl.continuous import PointMassEnv
    d = importlib.import_module("ldpc_tpu_torch.rl.ddpg")
    nets = {k: copy.deepcopy(v).to(dev) for k, v in nets_cpu.items()}
    targ = {k: copy.deepcopy(nets[k]).requires_grad_(False) for k in (
        ("q1", "q2") if name == "sac" else nets)}
    batch = d.batch_tensors(batch_np, dev)
    noise = [x.to(dev) for x in noise]
    if name in ("ddpg", "td3"):
        cfg = d.DDPGConfig()
        losses = d.update(nets, targ, d.optimizers(nets, cfg), batch, cfg,
                          td3_mode=name == "td3", act_limit=1.0,
                          policy=True, noise=noise[0])
        lrs = {"pi": cfg.pi_lr, "q1": cfg.q_lr, "q2": cfg.q_lr}
    else:
        s = importlib.import_module("ldpc_tpu_torch.rl.sac")
        cfg = s.SACConfig(auto_alpha=True)
        log_alpha = torch.tensor(np.log(cfg.alpha), dtype=torch.float32,
                                 device=dev, requires_grad=True)
        losses = s.update(nets, targ, s.optimizers(nets, log_alpha, cfg),
                          log_alpha, batch, cfg, PointMassEnv().act_dim,
                          noise=tuple(noise))
        losses["LogAlpha"] = log_alpha.detach()
        lrs = {"pi": cfg.lr, "q1": cfg.lr, "q2": cfg.lr}
    grads, params = _grads_params(nets)
    params.update(_grads_params({f"targ_{k}": v for k, v in
                                 targ.items()})[1])
    return ({k: float(v) for k, v in losses.items()}, grads, params, lrs)


def _param_excess(got: dict, want: dict, grads: dict, lrs: dict) -> tuple:
    """(the largest |card - CPU| over PARAM_ATOL, or over lr where the
    CPU's gradient is within its tolerance of 0; such elements)."""
    worst, free = 0.0, 0
    for k, w in want.items():
        diff = (got[k] - w).abs()
        tol = torch.full_like(w, PARAM_ATOL)
        g = grads.get(k.replace("targ_", ""))
        if g is not None:
            near0 = g.abs() <= GRAD_RTOL * g.abs() + GRAD_ATOL * float(
                g.abs().max())
            lr = lrs[k.replace("targ_", "").split(".")[0]]
            # a target moves by (1 - rho) of its online element's step
            scale = 0.005 if k.startswith("targ_") else 1.0
            tol = torch.where(near0, torch.full_like(w, lr * scale), tol)
            free += int(near0.sum())
        worst = max(worst, float((diff / tol).max()))
    return worst, free


def _cont_step_check(name: str, dev) -> dict:
    """One update of ``name`` from the same weights and batch on the card
    and on the CPU (phase 17 (a))."""
    import importlib
    if name == "trpo":
        return _trpo_step_check(dev)
    from ldpc_tpu_torch.rl.continuous import PointMassEnv
    env = PointMassEnv()
    mod = importlib.import_module("ldpc_tpu_torch.rl." + (
        "ddpg" if name == "td3" else name))
    nets = mod.init_nets(env.obs_dim, env.act_dim, 1.0, SEED, "cpu")
    b = (mod.SACConfig() if name == "sac" else mod.DDPGConfig()).batch_size
    batch = _cont_batch(b)
    rng = np.random.default_rng(SEED)
    noise = [torch.tensor(rng.standard_normal((b, env.act_dim)),
                          dtype=torch.float32) for _ in range(2)]
    card = _cont_side(name, nets, batch, noise, dev)
    cpu = _cont_side(name, nets, batch, noise, torch.device("cpu"))
    loss_err = max(abs(card[0][k] - cpu[0][k]) / max(1.0, abs(cpu[0][k]))
                   for k in cpu[0])
    grad_excess, grad_rel = _grad_excess(card[1], cpu[1])
    param_excess, free = _param_excess(card[2], cpu[2], cpu[1], cpu[3])
    out = {"losses": cpu[0], "loss_err": loss_err,
           "grad_excess": grad_excess, "grad_rel_err": grad_rel,
           "param_excess": param_excess, "near_zero_gradients": free}
    if not (loss_err <= CONT_RTOL and grad_excess <= 1.0
            and param_excess <= 1.0):
        raise AssertionError(f"(a) {name}: one update on the card and on "
                             f"the CPU differ: {out}")
    return out


def _trpo_step_check(dev) -> dict:
    """TRPO's update from the same weights and rollout on the card and on
    the CPU: the surrogate's gradient, a Fisher-vector product, the
    natural-gradient step with its line search, one value step."""
    import copy
    import importlib
    from torch.nn.utils import parameters_to_vector
    from ldpc_tpu_torch.rl.buffer import PPOBuffer
    from ldpc_tpu_torch.rl.continuous import GaussianActor, PointMassEnv
    from ldpc_tpu_torch.rl.ppo import _adam, _value_update
    t = importlib.import_module("ldpc_tpu_torch.rl.trpo")
    cfg = t.TRPOConfig()
    env = PointMassEnv(seed=SEED)
    actor, critic = t.init_nets(env.obs_dim, env.act_dim, SEED, "cpu")
    buf = PPOBuffer(env.obs_dim, env.act_dim, CONT_STEPS, cfg.gamma,
                    cfg.lam, num_entropy_heads=1)
    rng = np.random.default_rng(SEED)
    obs = env.reset()
    with torch.no_grad():
        for i in range(CONT_STEPS):
            o = torch.tensor(obs[None])
            mu, ls = actor(o)
            a = mu + torch.exp(ls) * torch.tensor(
                rng.standard_normal(mu.shape), dtype=torch.float32)
            logp = GaussianActor.log_prob(mu, ls, a)
            obs2, r, done, _ = env.step(a[0].numpy())
            buf.store(obs, a[0].numpy(), r, float(critic(o)[0]),
                      float(logp[0]), 0.0, np.zeros(1))
            obs = obs2
            if done or i == CONT_STEPS - 1:
                buf.finish_path(0.0)
                obs = env.reset()
    data = buf.get()
    v = torch.tensor(rng.standard_normal(sum(
        p.numel() for p in actor.parameters())), dtype=torch.float32)
    res = {}
    for side, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        a, c = copy.deepcopy(actor).to(d), copy.deepcopy(critic).to(d)
        dd = {k: torch.as_tensor(data[k], device=d)
              for k in ("obs", "act", "adv", "ret", "logp")}
        g = t.surrogate_grad(a, dd).cpu()
        fvp = t.fisher_vector_product(a, dd["obs"],
                                      t.old_policy(a, dd["obs"]),
                                      cfg.damping)
        hv = fvp(v.to(d)).detach().cpu()
        theta = parameters_to_vector(a.parameters()).detach()
        stats = t.policy_update(a, dd, cfg)
        step = (parameters_to_vector(a.parameters()).detach() - theta).cpu()
        loss_v = float(_value_update(c, _adam(cfg.vf_lr)(c.parameters()),
                                     dd["obs"], dd["ret"]))
        res[side] = {"g": g, "hv": hv, "step": step, "stats": stats,
                     "LossV": loss_v, **dict(zip(("grads", "params"),
                                                 _grads_params({"vf": c})))}
    g, w = res["cuda"], res["cpu"]

    def rel(k):
        return float((g[k] - w[k]).norm() / w[k].norm())

    out = {"grad_rel": rel("g"), "fvp_rel": rel("hv"),
           "step_rel": rel("step"), "stats": w["stats"],
           "stats_card": g["stats"],
           "LossV_err": abs(g["LossV"] - w["LossV"]) / max(1.0, abs(
               w["LossV"])),
           "vf_grad_excess": _grad_excess(g["grads"], w["grads"])[0],
           "vf_param_excess": _param_excess(g["params"], w["params"],
                                            w["grads"],
                                            {"vf": cfg.vf_lr})[0]}
    stat_err = max(abs(g["stats"][k] - w["stats"][k]) / abs(w["stats"][k])
                   for k in ("KL", "Surrogate"))
    out["stat_err"] = stat_err
    if not (out["grad_rel"] <= FVP_RTOL and out["fvp_rel"] <= FVP_RTOL
            and out["step_rel"] <= TRPO_STEP_RTOL
            and stat_err <= TRPO_STEP_RTOL
            and g["stats"]["BacktrackAccepted"] ==
            w["stats"]["BacktrackAccepted"]
            and out["LossV_err"] <= CONT_RTOL
            and out["vf_grad_excess"] <= 1.0
            and out["vf_param_excess"] <= 1.0):
        raise AssertionError(f"(a) trpo: one update on the card and on the "
                             f"CPU differ: {out}")
    return out


def phase_continuous(dev) -> dict:
    """(a) the continuous-control suite on the card: 2 epochs of each
    algorithm, then one update on the card against the CPU."""
    import contextlib
    import io
    import pathlib
    import tempfile
    from ldpc_tpu_torch import rl
    tag = "17cont"
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    runs = {"ddpg": (rl.ddpg, rl.DDPGConfig), "td3": (rl.td3, rl.DDPGConfig),
            "sac": (rl.sac, rl.SACConfig), "trpo": (rl.trpo, rl.TRPOConfig)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in CONT_ALGOS:
            fn, cfg_cls = runs[name]
            cfg = cfg_cls(steps_per_epoch=CONT_STEPS, epochs=CONT_EPOCHS)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                fn(lambda: rl.PointMassEnv(seed=SEED), cfg,
                   output_dir=f"{tmp}/{name}", device=dev)
            sync(dev)
            dt = time.perf_counter() - t0
            lines = (pathlib.Path(tmp) / name / "progress.txt").read_text(
                ).splitlines()
            head = lines[0].split("\t")
            rows = [dict(zip(head, map(float, ln.split("\t"))))
                    for ln in lines[1:]]
            if len(rows) != CONT_EPOCHS or not all(
                    np.isfinite(list(r.values())).all() for r in rows):
                raise AssertionError(f"(a) {name}: progress {rows}")
            last = {k: v for k, v in rows[-1].items() if k != "Time"}
            t0 = time.perf_counter()
            step = _cont_step_check(name, dev)
            out[name] = {"seconds": dt, "steps_per_s":
                         CONT_STEPS * CONT_EPOCHS / dt, "last_epoch": last,
                         "step_check": step,
                         "check_seconds": time.perf_counter() - t0}
            log(tag, f"(a) {name}: {CONT_EPOCHS} epochs x {CONT_STEPS} steps "
                f"on the card in {dt:.2f} s "
                f"({CONT_STEPS * CONT_EPOCHS / dt:.0f} env steps/s); last "
                "epoch " + ", ".join(f"{k} {v:.4g}" for k, v in last.items())
                + "; one update card vs CPU: " + ", ".join(
                    f"{k} {v:.3g}" for k, v in step.items()
                    if isinstance(v, float)))
    return out


def _family_z(points: int) -> float:
    """The z of each point's interval that holds a family of ``points`` at
    95% (Bonferroni, two-sided)."""
    import statistics
    return statistics.NormalDist().inv_cdf(1 - 0.025 / points)


def _check_points(tag: str, name: str, pts: list) -> dict:
    """``pts``: (label, frames, words, JAX frames, JAX words).  Fails unless
    every point's Wilson interval overlaps the JAX one's at the family's z;
    logs the points whose 95% intervals do not overlap."""
    if not pts:
        log(tag, f"(b) {name}: no point the JAX artifact has")
        return {"points": 0}
    z = _family_z(len(pts))
    bad, out95 = [], []
    for label, k, n, kr, nr in pts:
        ok = _overlap(wilson_interval(k, n, z)[1:],
                      wilson_interval(kr, nr, z)[1:])
        if not _overlap(wilson_interval(k, n)[1:],
                        wilson_interval(kr, nr)[1:]):
            out95.append(f"{label} {k}/{n} vs JAX {kr}/{nr}")
        if not ok:
            bad.append(f"{label} {k}/{n} vs JAX {kr}/{nr}")
    log(tag, f"(b) {name}: {len(pts)} FER points against the JAX "
        f"artifact's: {len(pts) - len(bad)} within the family's 95% band "
        f"(each interval at z {z:.3f}), {len(pts) - len(out95)} within the "
        "point's own 95% band" + (f"; outside it ({len(out95)}): "
                                  f"{out95[:8]}" if out95 else ""))
    if bad:
        raise AssertionError(f"(b) {name}: outside the band: {bad}")
    return {"points": len(pts), "z": z, "outside_95": out95}


def phase_studies(dev) -> dict:
    """(b) the kernel studies at their defaults, each writing into a
    temporary directory: every FER point in the JAX artifact's band,
    sched_ab's variants word-exact, each study's launches."""
    import tempfile
    from ldpc_tpu_torch.scripts import (giant_code, layered_ab,
                                        perturbation_fer, quantized_ber,
                                        sched_ab)
    tag = "17studies"
    mods = {"layered_ab": layered_ab, "quantized_ber": quantized_ber,
            "sched_ab": sched_ab, "perturbation_fer": perturbation_fer,
            "giant_code": giant_code}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mod in mods.items():
            clear_launches()
            t0 = time.perf_counter()
            res = mod.main(STUDY_ARGS[name] + ["--out", f"{tmp}/{name}"])
            sync(dev)
            dt = time.perf_counter() - t0
            got = _val_record(STUDY_PATHS[name], STUDY_KEYS[name])
            out[name] = {"seconds": dt, "launches": got, "result": res}
            log(tag, f"(b) {name}: {dt:.2f} s, adopt {res.get('adopt', '-')}"
                f", launches {got}")
        r = out["layered_ab"]["result"]
        pts = [(f"{v} {snr}", p["frames"], r["batch"],
                JAX_LAYERED_AB_FRAMES[v][float(snr)], JAX_LAYERED_AB_WORDS)
               for v, row in r["results"].items() for snr, p in row.items()]
        out["layered_ab"]["band"] = _check_points(tag, "layered_ab", pts)
        r = out["quantized_ber"]["result"]
        pts = [(f"{st} {p['snr_db']}", round(p["fer"] * r["words"]),
                r["words"], JAX_QUANT_FRAMES[st][p["snr_db"]],
                JAX_QUANT_WORDS)
               for st, row in r["stores"].items() if st in JAX_QUANT_FRAMES
               for p in row]
        out["quantized_ber"]["band"] = _check_points(tag, "quantized_ber",
                                                     pts)
        log(tag, "(b) quantized_ber float32 (no JAX point): FER " + ", ".join(
            f"{p['snr_db']} dB {p['fer']:.5f}"
            for p in r["stores"]["float32"]))
        r = out["sched_ab"]["result"]
        if not all(e["exact"] for e in r["entries"].values()):
            raise AssertionError(f"(b) sched_ab: {r['entries']}")
        ctx = r["context"]
        pts = [(k, sum(e["nfail"]), ctx["batch"] * e["trials"],
                sum(JAX_SCHED_NFAIL[(e["dep_stride"], e["popcount_sign"])]),
                JAX_SCHED_WORDS * len(JAX_SCHED_NFAIL[
                    (e["dep_stride"], e["popcount_sign"])]))
               for k, e in r["entries"].items()
               if (e["dep_stride"], e["popcount_sign"]) in JAX_SCHED_NFAIL]
        out["sched_ab"]["band"] = _check_points(tag, "sched_ab", pts)
        log(tag, f"(b) sched_ab: {len(r['entries'])} variants word-exact; "
            "best ms " + ", ".join(f"{k} {e['best_ms']:.3f}"
                                   for k, e in r["entries"].items()))
        r = out["perturbation_fer"]["result"]
        pts = [(f"{v} {snr}", p["frames"], r["words"],
                JAX_PERTURB_FRAMES[v][JAX_PERTURB_SNRS.index(snr)],
                JAX_PERTURB_WORDS)
               for v, row in r["variants"].items() for snr, p in row.items()]
        out["perturbation_fer"]["band"] = _check_points(
            tag, "perturbation_fer", pts)
        r = out["giant_code"]["result"]
        if not r["crosscheck"]["exact"]:
            raise AssertionError(f"(b) giant_code: {r['crosscheck']}")
        pts = [(f"z {g['z']} {g['layout']}", g["frames"], g["words"],
                *JAX_GIANT_FRAMES[(g["z"], g["layout"])])
               for g in r["runs"] if (g["z"], g["layout"]) in
               JAX_GIANT_FRAMES]
        out["giant_code"]["band"] = _check_points(tag, "giant_code", pts)
        log(tag, f"(b) giant_code: {r['ranks']} gloo ranks on the card, "
            f"the cross-check (z {r['crosscheck']['z']}) exact; " + ", ".join(
                f"z {g['z']} {g['layout']} {g['bit_per_s']:.4g} bit/s "
                f"({g['state_mib_per_device']:.1f} MiB a rank, "
                f"{g['avg_iterations']:.2f} iterations)" for g in r["runs"]))
    log(tag, "seconds by study: " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in out.items()))
    return out


def _reward_band(tag: str, name: str, got: tuple, ref: tuple, n: int,
                 t: float) -> dict:
    """``got``, ``ref``: (mean, np.std) of n seeds' rewards each; fails
    unless |difference| <= t x the standard error of the difference."""
    tol = t * ((got[1] ** 2 + ref[1] ** 2) / (n - 1)) ** 0.5
    diff = got[0] - ref[0]
    log(tag, f"{name}: reward {got[0]:.5f} ± {got[1]:.5f} against JAX "
        f"{ref[0]:.5f} ± {ref[1]:.5f}: difference {diff:+.5f}, tolerance "
        f"{tol:.5f}")
    if abs(diff) > tol:
        raise AssertionError(f"{name}: reward {got[0]} vs JAX {ref[0]} "
                             f"(tolerance {tol})")
    return {"diff": diff, "tolerance": tol}


def phase_search(dev) -> dict:
    """The code-search scripts at their defaults (rl_search_wide short),
    each writing into a temporary directory: the chain's FERs and rewards,
    the discovered code's waterfall and the 802.11n reward noise in the JAX
    artifacts' bands, the staging grid word-exact, each script's
    launches."""
    import tempfile
    from ldpc_tpu_torch.scripts import (chain_figure, chain_scoreboard,
                                        discovered_code_waterfall,
                                        floor_search_analysis,
                                        floor_topk_select,
                                        reward_floor_frontier,
                                        reward_investigation, rl_search_wide,
                                        rollout_throughput, staging_grid)
    tag = "18search"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = f"{tmp}/exp"
        tsv = f"{exp}/search_wide/search_wide_s31/steps.tsv"
        topk = ["--topk", str(SEARCH_TOPK)]
        runs = [
            ("chain_scoreboard", chain_scoreboard, []),
            ("discovered_code_waterfall", discovered_code_waterfall,
             ["--save-dir", f"{tmp}/instances"]),
            ("staging_grid", staging_grid, []),
            ("rollout_throughput", rollout_throughput, []),
            ("reward_investigation", reward_investigation, []),
            ("rl_search_wide", rl_search_wide,
             SEARCH_RL_ARGS + ["--data-dir", exp]),
            ("floor_topk_select", floor_topk_select,
             ["--steps-tsv", tsv] + topk),
            ("floor_search_analysis", floor_search_analysis,
             ["--steps-tsv", tsv]),
            ("rl_search_wide --select-only", rl_search_wide,
             SEARCH_RL_ARGS + ["--data-dir", exp, "--select-only"]),
            ("reward_floor_frontier", reward_floor_frontier,
             ["--selections", f"{tmp}/floor_topk_select.json",
              f"{tmp}/rl_search_wide.json",
              "--scoreboard", f"{tmp}/chain_scoreboard.json"]),
            ("chain_figure", chain_figure,
             ["--series", f"{tmp}/discovered_code_waterfall.json"]),
        ]
        for name, mod, argv in runs:
            base = f"{tmp}/{name.split()[0]}" + ("_select" if " " in name
                                                 else "")
            clear_launches()
            t0 = time.perf_counter()
            res = mod.main(argv + ["--out", base])
            sync(dev)
            dt = time.perf_counter() - t0
            got = _val_record(SEARCH_PATHS[name], SEARCH_KEYS[name])
            out[name] = {"seconds": dt, "launches": got, "result": res}
            log(tag, f"{name}: {dt:.2f} s, launches {got}")

        r = out["chain_scoreboard"]["result"]
        if list(r["codes"]) != list(JAX_CHAIN):
            raise AssertionError(f"chain_scoreboard codes {list(r['codes'])}")
        pts = [(f"{n} {r['floor_snr_db']}", c["frame_errors"], c["words"],
                JAX_CHAIN[n][2], JAX_CHAIN_WORDS)
               for n, c in r["codes"].items()]
        out["chain_scoreboard"]["band"] = _check_points(
            tag, "chain_scoreboard FER", pts)
        out["chain_scoreboard"]["rewards"] = {
            n: _reward_band(tag, f"chain_scoreboard {n}",
                            (c["reward_mean"], c["reward_std"]),
                            JAX_CHAIN[n][:2], len(r["reeval"]["seeds"]),
                            CHAIN_REWARD_T)
            for n, c in r["codes"].items()}
        log(tag, "chain_scoreboard order (penalized): " + ", ".join(
            f"{n} {c['penalized']:.5f}" for n, c in sorted(
                r["codes"].items(), key=lambda kv: -kv[1]["penalized"])))

        r = out["discovered_code_waterfall"]["result"]
        pts = [(f"{code} {p['snr_db']}", p["frame_errors"], p["words"],
                JAX_WATERFALL_FRAMES[code][p["snr_db"]], JAX_WATERFALL_WORDS)
               for code, row in r["codes"].items() for p in row]
        out["discovered_code_waterfall"]["band"] = _check_points(
            tag, "discovered_code_waterfall", pts)
        log(tag, "discovered_code_waterfall verdicts " + ", ".join(
            f"{v['snr_db']} {v['verdict']}"
            for v in r["per_point_verdicts"]))

        r = out["staging_grid"]["result"]
        if not r["all_exact"]:
            raise AssertionError(f"staging_grid: {r['configs']}")
        log(tag, "staging_grid, every cascade word-exact to the straight "
            "decode: " + ", ".join(
                f"{c['phases']} {c['best_ms']:.3f} ms "
                f"({c['mbit_s']:.1f} Mbit/s)" for c in r["configs"]))

        r = out["rollout_throughput"]["result"]
        log(tag, "rollout_throughput env steps/s: " + ", ".join(
            f"{x['envs']} {x['mode']} {x['env_steps_per_s']:.1f} (legal "
            f"{x['legal_fraction']:.3f})" for x in r["rows"]))
        if not all(x["env_steps_per_s"] > 0 for x in r["rows"]):
            raise AssertionError(f"rollout_throughput: {r['rows']}")

        r = out["reward_investigation"]["result"]
        if r["seeds"] != REWARD_NOISE_SEEDS:
            raise AssertionError(f"reward_investigation seeds {r['seeds']}")
        out["reward_investigation"]["band"] = {
            t: _reward_band(tag, f"reward_investigation 802.11n {t} tx",
                            (r["mc_noise"][t]["mean"],
                             r["mc_noise"][t]["std"]), ref,
                            REWARD_NOISE_SEEDS, REWARD_NOISE_T)
            for t, ref in JAX_REWARD_NOISE.items()}
        nb = r["near_earth_baselines"]
        log(tag, f"reward_investigation: fit kept {r['fit']['kept']} of "
            f"{r['fit']['points']}, reward {r['fit']['reward']:.4f}; sigma "
            f"{r['sigma']['realized_mean']:.4f} realized against "
            f"{r['sigma']['nominal_mean']:.4f}; near-earth "
            f"{nb['reward_3p0_3p8']:.4f} / {nb['reward_3p0_3p4']:.4f}; "
            f"degenerate {r['degenerate']}")

        r = out["rl_search_wide"]["result"]
        again = out["rl_search_wide --select-only"]["result"]
        cands = r["selection"]["candidates"]
        if not cands or any(len(c["floors"]) != 1 for c in cands) or \
                again["selection"]["candidates"] != cands:
            raise AssertionError(f"rl_search_wide selection: {cands} / "
                                 f"{again['selection']['candidates']}")
        log(tag, f"rl_search_wide: {r['epochs']} epochs, train "
            f"{r['train_seconds']:.2f} s, selection "
            f"{r['select_seconds']:.2f} s, {len(cands)} candidates (the "
            f"--select-only rerun equal), best penalized "
            f"{r['best_found']['penalized']:.5f}, start code "
            f"{r['start_code']['penalized']:.5f}")
        for name in ("floor_topk_select", "floor_search_analysis"):
            res = out[name]["result"]
            n = len(res.get("candidates", res.get("codes")))
            log(tag, f"{name}: {n} rows")
            if n == 0:
                raise AssertionError(f"{name}: nothing scored")
        r = out["reward_floor_frontier"]["result"]
        pooled = sum(map(len, r["selections"].values()))
        log(tag, f"reward_floor_frontier: {pooled} candidates, "
            f"{len(r['chain'])} chain members, frontier {r['frontier']}")
        if len(r["chain"]) != len(JAX_CHAIN) or not r["frontier"]:
            raise AssertionError(f"reward_floor_frontier: {r}")
        r = out["chain_figure"]["result"]
        if len(r["series"]) != 2:
            raise AssertionError(f"chain_figure: {r['series']}")
    log(tag, "seconds by script: " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in out.items()))
    return out


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
    env = phase_env(dev)
    trainer = phase_trainer(dev)
    validation = phase_validation(dev)
    parallel = phase_parallel(dev, main, trainer["steps_tsv"])
    continuous = phase_continuous(dev)
    studies = phase_studies(dev)
    search = phase_search(dev)
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
            "microbench": mb, "env": env, "trainer": trainer,
            "validation": validation, "parallel": parallel,
            "continuous": continuous, "studies": studies, "search": search}


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
