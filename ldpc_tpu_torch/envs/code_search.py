"""The LDPC code-search environment (reference ``LdpcEnv``; the port of
``ldpc_tpu.envs.code_search``).

MDP (matching ``gym-ldpc/gym_ldpc/envs/ldpc_env.py``):
  * state: a QC parity code, starting at CCSDS near-earth
    (ldpc_env.py:82-90);
  * observation: circulant first rows bit-packed to 2048 uint8 bytes
    (``compress``, ldpc_env.py:379-394);
  * action: 516 bits = [1-bit block row x | 4-bit block col y | 511-bit new
    circulant first row] (ldpc_env.py:100-104,169-209);
  * step: functionally replace circulant (x, y), run a Monte-Carlo sweep
    over SNR [3.0, 3.2, 3.4] x 10 transmissions at 50 iterations
    (ldpc_env.py:88,110-114), reward = area between 1 and the recursively
    fitted BER line (ldpc_env.py:319-345);
  * episode ends when accumulated decode iterations (or time) exceed the
    budget (ldpc_env.py:25,260-262); illegal actions score -2.0 without
    mutating state (ldpc_env.py:120-121).

Design, as in the JAX package:
  * the whole (SNR x transmissions) sweep of one step is ONE batched decode
    on the device — the reference fans it out to 1-4 GPUs via process
    pools (ldpc_env.py:353-377, ldpcCUDA.py:891-932);
  * the state is a pure ``QCCode`` value (functional replace), making reset
    free and the env trivially checkpointable;
  * actions that would push a block row/col past the degree caps are
    rejected as illegal.

The decode route (``decoder_backend="dynamic"``, the default):
  * on the card, the fused kernel ``csrc/decode.cu`` through
    ``ops.cuda_static.make_static_sweep_decoder``: flooding, float32 state
    (the JAX env decodes in float32), the env's ``decoder_kind``.  The
    kernel reads its edge tables as device data, so a mutated code costs
    its plan, its tables and one upload, never a build.  A candidate the
    kernel refuses (shared memory, argmin range) raises; there is no
    fallback;
  * on the CPU, ``ops.dynamic`` (plain torch, the counterpart of the JAX
    env's XLA decoder).
Any other ``decoder_backend`` decodes with ``ops.decoder.decoder_for_code``
(plain torch), as the JAX env does with its XLA decoder.  Both routes take
the raw channel samples the JAX env feeds, whatever the kind.  The
per-code decoders are held in a ``BoundedCache``.

The channel draws one ``self.rng.randint(0, 2**31 - 1)`` a step, as the JAX
env does, and seeds a ``torch.Generator`` on the env's device with it: the
env's RandomState stream, and so the episode's legality and budgets, stay
aligned with the JAX env's (the noise itself is Philox, not threefry).

``replacement_only`` mode swaps the circulants at two coordinate pairs
(ldpc_env.py:185-200).  NOTE the reference's implementation reads the
second circulant from block (xr, xr) instead of (xr, yr) — an indexing bug;
we implement the documented swap.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..codes import compress, near_earth_code, uncompress
from ..codes.qc import QCCode
from ..sim.channel import transmit_zero_codeword
from ..sim.reward import BAD_CANDIDATE_REWARD, calc_reward
from ..sim.stats import BerStatistics
from ..utils.cache import BoundedCache
from ..utils.device import resolve_device
from .spaces import BinarySpace, Uint8Space

__all__ = ["LdpcCodeSearchEnv", "DecodeCounts", "route_counts_fn",
           "DEFAULT_SNR_POINTS",
           "DEFAULT_NUM_TRANSMISSIONS", "DEFAULT_NUM_ITERATIONS",
           "DEFAULT_TIME_BUDGET_S"]

DEFAULT_SNR_POINTS = (3.0, 3.2, 3.4)       # ldpc_env.py:88
DEFAULT_NUM_TRANSMISSIONS = 10             # LDPC_ENV_NUMBER_OF_TRANSMISSIONS
DEFAULT_NUM_ITERATIONS = 50                # LDPC_ENV_NUMBER_OF_ITERATIONS
DEFAULT_TIME_BUDGET_S = 640.0              # 64 * numTransmissions, :25
_DECODER_CACHE = 16     # per-code decoders (plan + tables) an env keeps
_STAGE_CHUNK = 256      # words a phase-2 re-decode takes at a time


@dataclasses.dataclass
class DecodeCounts:
    """What a step's statistics need of a decode, on the env's device:
    bit errors against the all-zero codeword, iterations and success, [B]
    each (or [N, B] for a vector step)."""

    errors: torch.Tensor
    iterations: torch.Tensor
    success: torch.Tensor


def _to_host(cols: dict) -> dict:
    """Device tensors of one shape -> numpy arrays, in ONE device-to-host
    copy (as float64: every value here is exact in it)."""
    names = list(cols)
    packed = torch.stack([cols[k].to(torch.float64) for k in names]).cpu()
    out = {}
    for k, v in zip(names, packed.numpy()):
        dt = cols[k].dtype
        out[k] = (v.astype(bool) if dt == torch.bool else
                  v.astype(np.float32) if dt == torch.float32 else
                  v.astype(np.int64))
    return out


def route_counts_fn(code: QCCode, max_iters: int, *, kind: str, device,
                    dmax_cn: int, dmax_vn: int, backend: str = "dynamic"):
    """``fn(llr[B, n] float32) -> (errors, iterations, success)`` of the
    env's decode route for ``code`` on ``device`` (see the module note):
    with the ``"dynamic"`` backend the fused kernel on the card and
    ``ops/dynamic.py`` at the degree caps on the CPU; any other backend
    ``ops/decoder.py``."""
    device = torch.device(device)
    if backend == "dynamic" and device.type == "cuda":
        from ..ops.cuda_static import make_static_sweep_decoder
        return make_static_sweep_decoder(code, max_iters, kind=kind,
                                         store_dtype="float32",
                                         device=device)
    if backend == "dynamic":
        from ..ops.dynamic import dynamic_plan, make_dynamic_decoder
        plan = dynamic_plan(code, dmax_cn, dmax_vn, device=device)
        dyn = make_dynamic_decoder(code.z, code.block_rows, code.block_cols,
                                   dmax_cn, dmax_vn, max_iters, kind=kind)

        def dec(llr):
            return dyn(plan, llr)
    else:
        from ..ops.decoder import decoder_for_code
        dec = decoder_for_code(code, max_iters, kind=kind)

    def fn(llr):
        res = dec(llr)
        return (res.hard.sum(-1, dtype=torch.int32), res.iterations,
                res.success)

    return fn


class LdpcCodeSearchEnv:
    """Gym-style env; ``step`` returns (obs, reward, done, info).

    ``device``: where the step's batch is drawn and decoded (default: the
    card; ``"cpu"`` runs the plain torch route)."""

    metadata = {"render.modes": ["rgb"]}

    def __init__(self,
                 code: QCCode | None = None,
                 snr_points=DEFAULT_SNR_POINTS,
                 num_transmissions=DEFAULT_NUM_TRANSMISSIONS,
                 num_iterations: int = DEFAULT_NUM_ITERATIONS,
                 seed: int = 7134066,
                 replacement_only: bool = False,
                 time_budget_s: float = DEFAULT_TIME_BUDGET_S,
                 iteration_budget: int | str | None = "auto",
                 dmax_cn_cap: int = 48,
                 dmax_vn_cap: int = 18,
                 decoder_kind: str = "min-sum",
                 decoder_backend: str = "dynamic",
                 floor_penalty: float = 0.0,
                 floor_snr_index: int = -1,
                 phase1_iterations: int | None = None,
                 device=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.reset_value = code if code is not None else near_earth_code()
        self.state = self.reset_value
        self.z = self.state.z
        self.x_bits = max(1, (self.state.block_rows - 1).bit_length())
        self.y_bits = max(1, (self.state.block_cols - 1).bit_length())
        self.replacement_only = replacement_only
        if replacement_only:
            self.action_bits = 2 * (self.x_bits + self.y_bits)
        else:
            self.action_bits = self.x_bits + self.y_bits + self.z
        self.action_space = BinarySpace(self.action_bits)
        obs = compress(self.state)
        self.observation_space = Uint8Space(obs.shape[0])

        self.snr_points = np.asarray(snr_points, np.float64)
        # Per-SNR-point transmission counts: an int applies to every point
        # (reference semantics); a sequence gives each point its own count
        # (thousands of words at the high-SNR floor points cost little,
        # since they converge in a few iterations).
        if np.ndim(num_transmissions) == 0:
            tx = np.full(len(self.snr_points), int(num_transmissions),
                         np.int64)
        else:
            tx = np.asarray(num_transmissions, np.int64)
            if tx.shape[0] != len(self.snr_points):
                raise ValueError(
                    f"num_transmissions sequence needs one entry per SNR "
                    f"point: {tx.shape[0]} vs {len(self.snr_points)}")
        self.tx_counts = tx
        self.num_transmissions = int(tx[0]) if (tx == tx[0]).all() \
            else tuple(int(t) for t in tx)
        self.num_iterations = int(num_iterations)
        self.time_budget_s = float(time_budget_s)
        # Floor-aware reward shaping: subtract ``sum_i penalty_i * FER``
        # at snr_points[floor_snr_index_i] from the fitted-line reward; a
        # scalar broadcasts against a sequence.  An index counts from the
        # end when negative (the default -1 is the highest point) and must
        # name one of the points.  ``floor_penalty_scale`` multiplies every
        # term (an annealing knob a training loop can ramp per epoch).  0.0
        # penalties = reference reward (ldpc_env.py:319-345).
        pens = np.atleast_1d(np.asarray(floor_penalty, np.float64))
        idxs = np.atleast_1d(np.asarray(floor_snr_index, np.int64))
        if pens.shape[0] != idxs.shape[0]:
            if pens.shape[0] == 1:
                pens = np.repeat(pens, idxs.shape[0])
            elif idxs.shape[0] == 1:
                idxs = np.repeat(idxs, pens.shape[0])
            else:
                raise ValueError(
                    f"floor_penalty and floor_snr_index lengths differ: "
                    f"{pens.shape[0]} vs {idxs.shape[0]}")
        k = len(self.snr_points)
        bad = idxs[(idxs < -k) | (idxs >= k)]
        if bad.size:
            raise ValueError(f"floor_snr_index {bad.tolist()} out of range "
                             f"for {k} SNR points")
        self.floor_penalties = pens
        self.floor_snr_indices = idxs % k
        self.floor_penalty_scale = 1.0
        # The primary episode terminator is the decode-iteration budget
        # (deterministic, so episode lengths reproduce across routes,
        # batching modes and hardware); time_budget_s stays a secondary
        # circuit breaker.  "auto" re-expresses the reference's
        # 64*numTransmissions-second constant in iterations (sequence
        # counts: their mean).
        if iteration_budget == "auto":
            iteration_budget = int(64 * float(tx.mean())
                                   * self.num_iterations)
        self.iteration_budget = iteration_budget
        self.reward_for_illegal_action = BAD_CANDIDATE_REWARD
        self.dmax_cn_cap = int(dmax_cn_cap)
        self.dmax_vn_cap = int(dmax_vn_cap)
        self.decoder_kind = decoder_kind
        self.decoder_backend = decoder_backend
        # Host-staged decode: the step's batch at a small cap first, then
        # only the failures at the full budget — per-word results identical
        # by convergence latching.  None = single pass.
        self.phase1_iterations = (int(phase1_iterations)
                                  if phase1_iterations else None)
        self.rng = np.random.RandomState(seed)
        self.seed_value = seed
        self._decoders = BoundedCache(_DECODER_CACHE)

        self.accumulated_evaluation_time = 0.0
        self.accumulated_iterations = 0
        self.ber_stats = BerStatistics(self.state.n)
        self.scatter_snr = self.snr_points.copy()
        self.scatter_ber = np.ones(len(self.snr_points))
        self.observed_state = obs

    # ------------------------------------------------------------------
    def counts_fn(self, code: QCCode, max_iters: int):
        """``fn(llr[B, n] float32) -> DecodeCounts`` of this env's route
        for ``code`` at ``max_iters`` (see the module note), cached."""
        key = (code, int(max_iters))
        fn = self._decoders.get(key)
        if fn is not None:
            return fn
        route = route_counts_fn(code, max_iters, kind=self.decoder_kind,
                                device=self.device,
                                dmax_cn=self.dmax_cn_cap,
                                dmax_vn=self.dmax_vn_cap,
                                backend=self.decoder_backend)

        def fn(llr):
            return DecodeCounts(*route(llr))

        self._decoders[key] = fn
        return fn

    def _decode_batched(self, code: QCCode, llr: torch.Tensor
                        ) -> DecodeCounts:
        """One batched decode of all (snr x transmission) words."""
        if (self.decoder_backend == "dynamic" and self.phase1_iterations
                and self.phase1_iterations < self.num_iterations):
            return self._staged_dynamic_decode(code, llr)
        return self.counts_fn(code, self.num_iterations)(llr)

    def _staged_dynamic_decode(self, code: QCCode, llr: torch.Tensor
                               ) -> DecodeCounts:
        """Two-phase host-staged decode: phase-1 cap for the whole batch,
        full-budget re-decode of the failures only (fixed-size chunks).
        Per-word results are IDENTICAL to the single-pass decode
        (convergence latching: a word converging within phase 1 is final;
        a failed word's re-decode is the deterministic full decode of the
        same LLRs)."""
        res1 = self.counts_fn(code, self.phase1_iterations)(llr)
        success = res1.success.cpu().numpy()
        failed = np.flatnonzero(~success)
        if failed.size == 0:
            return res1
        errors = res1.errors.clone()
        iters = res1.iterations.clone()
        ok = res1.success.clone()
        b = llr.shape[0]
        dec2 = self.counts_fn(code, self.num_iterations)
        if failed.size > 0.25 * b:
            res2 = dec2(llr)
            redo = ~res1.success
            errors[redo] = res2.errors[redo]
            iters[redo] = res2.iterations[redo]
            ok[redo] = res2.success[redo]
        else:
            chunk = min(_STAGE_CHUNK, b)
            for lo in range(0, failed.size, chunk):
                part = failed[lo:lo + chunk]
                idx = np.concatenate(
                    [part, np.zeros(chunk - part.size, np.int64)])
                res2 = dec2(llr[torch.as_tensor(idx, device=llr.device)])
                p = torch.as_tensor(part, device=llr.device)
                errors[p] = res2.errors[:part.size]
                iters[p] = res2.iterations[:part.size]
                ok[p] = res2.success[:part.size]
        return DecodeCounts(errors, iters, ok)

    def _degrees_ok(self, code: QCCode) -> bool:
        return (max(code.row_degrees()) <= self.dmax_cn_cap and
                max(code.col_degrees()) <= self.dmax_vn_cap)

    def _transmit(self):
        """Sample this step's (SNR x transmissions) batch of raw channel
        samples on the env's device.

        Draws one seed from the env's own RandomState, so batched
        multi-env stepping consumes exactly the same randomness per env as
        sequential stepping.  Returns (snr_per_word [B] numpy, noisy [B, n],
        sigma [B], sigma_actual [B])."""
        snr_per_word = np.repeat(self.snr_points, self.tx_counts)
        b = snr_per_word.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.rng.randint(0, 2 ** 31 - 1)))
        snr = torch.as_tensor(snr_per_word, dtype=torch.float32,
                              device=self.device)
        noisy, sigma, sigma_actual = transmit_zero_codeword(
            b, self.state.n, snr, generator=gen, device=self.device)
        return snr_per_word, noisy, sigma, sigma_actual

    @staticmethod
    def _device_columns(noisy, sigma, sigma_actual,
                        res: DecodeCounts) -> dict:
        """A step's per-word columns on the device, uncoded errors counted
        there."""
        return {"sigma": sigma, "sigma_actual": sigma_actual,
                "errors_uncoded": (noisy > 0).sum(-1),
                "errors_decoded": res.errors, "iterations": res.iterations,
                "success": res.success}

    def _stats_from_host(self, snr_per_word, host: dict) -> BerStatistics:
        stats = BerStatistics(self.state.n)
        stats.add_batch(snr=snr_per_word, sigma=host["sigma"],
                        sigma_actual=host["sigma_actual"],
                        errors_uncoded=host["errors_uncoded"],
                        errors_decoded=host["errors_decoded"],
                        iterations=host["iterations"],
                        max_iterations=self.num_iterations,
                        success=host["success"])
        return stats

    def _charge(self, wall_s: float, iterations) -> None:
        """Accrue this step's evaluation cost against the episode budgets."""
        self.accumulated_evaluation_time += wall_s
        self.accumulated_iterations += int(np.asarray(iterations).sum())

    def evaluate_code(self) -> BerStatistics:
        """Monte-Carlo evaluate the current state (ldpc_env.py:353-377);
        the wall time charged runs to the host read of the results."""
        t0 = time.perf_counter()
        snr_per_word, noisy, sigma, sigma_actual = self._transmit()
        res = self._decode_batched(self.state, noisy)
        host = _to_host(self._device_columns(noisy, sigma, sigma_actual,
                                             res))
        self._charge(time.perf_counter() - t0, host["iterations"])
        return self._stats_from_host(snr_per_word, host)

    # ------------------------------------------------------------------
    def _split_action(self, action):
        action = np.asarray(action).reshape(-1)
        if action.shape[0] != self.action_bits:
            raise ValueError(
                f"action must have {self.action_bits} bits, got "
                f"{action.shape[0]}")
        xb, yb = self.x_bits, self.y_bits
        # big-endian bit packing, matching xCoordinateBinaryToInt =
        # flipud(2**arange) (ldpc_env.py:116-117)
        x = int(action[:xb] @ (2 ** np.arange(xb)[::-1]))
        y = int(action[xb:xb + yb] @ (2 ** np.arange(yb)[::-1]))
        rest = action[xb + yb:]
        return x, y, rest

    def _prepare_step(self, action):
        """Action -> (legal, candidate code) without evaluating."""
        x, y, rest = self._split_action(action)
        legal = x < self.state.block_rows and y < self.state.block_cols
        candidate = None
        if legal:
            if self.replacement_only:
                xr = int(rest[:self.x_bits] @
                         (2 ** np.arange(self.x_bits)[::-1]))
                yr = int(rest[self.x_bits:] @
                         (2 ** np.arange(self.y_bits)[::-1]))
                legal = (xr < self.state.block_rows and
                         yr < self.state.block_cols)
                if legal:
                    a = self.state.shifts[x][y]
                    bshifts = self.state.shifts[xr][yr]
                    candidate = self.state.replace_block(
                        x, y, bshifts).replace_block(xr, yr, a)
            else:
                candidate = self.state.replace_block(x, y, rest)
            if candidate is not None and not self._degrees_ok(candidate):
                legal, candidate = False, None
        return legal and candidate is not None, candidate

    def _finish_step(self, legal: bool, stats: BerStatistics | None):
        """Reward from the evaluated stats + budget/done/obs bookkeeping."""
        if legal and stats is not None:
            self.ber_stats = stats
            (scatter_snr, scatter_ber, _, _, _, ber_data,
             _) = self.ber_stats.get_stats_v2()
            self.scatter_snr, self.scatter_ber = scatter_snr, scatter_ber
            self.ber_points = ber_data
            reward = calc_reward(scatter_snr, scatter_ber, self.snr_points)
            for pen, idx in zip(self.floor_penalties,
                                self.floor_snr_indices):
                if not pen:
                    continue
                snr_f = self.snr_points[idx]
                sel = stats.column("snr") == snr_f
                w = stats.column("weight")[sel].sum()
                fer = (stats.column("frame_errors")[sel].sum() / w
                       if w else 0.0)
                reward -= self.floor_penalty_scale * pen * float(fer)
        else:
            reward = self.reward_for_illegal_action

        done = self.accumulated_evaluation_time > self.time_budget_s
        if self.iteration_budget is not None:
            done = done or (self.accumulated_iterations >
                            self.iteration_budget)
        self.observed_state = compress(self.state)
        info = {
            "legal": legal,
            "accumulated_evaluation_time": self.accumulated_evaluation_time,
            "accumulated_iterations": self.accumulated_iterations,
        }
        return self.observed_state, float(reward), bool(done), info

    def step(self, action):
        legal, candidate = self._prepare_step(action)
        stats = None
        if legal:
            self.state = candidate
            stats = self.evaluate_code()
        return self._finish_step(legal, stats)

    def reset(self):
        self.state = self.reset_value
        self.observed_state = compress(self.state)
        self.ber_points = np.ones(len(self.snr_points))
        self.accumulated_evaluation_time = 0.0
        self.accumulated_iterations = 0
        return self.observed_state

    def render(self, mode="rgb", close=False):
        return None

    def seed(self, seed=None):
        self.rng = np.random.RandomState(seed)
        return [seed]

    # convenience accessors mirroring the reference codec entry points
    def compress(self) -> np.ndarray:
        return compress(self.state)

    def uncompress(self, observation) -> QCCode:
        return uncompress(observation, self.state.block_rows,
                          self.state.block_cols, self.z)
