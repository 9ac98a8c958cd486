"""GAE experience buffer (reference ``buffer.py:24-181``; the port's copy of
``ldpc_tpu.rl.buffer``, numpy only, so it gives the same numbers).

Same layout and semantics as the Spinning-Up-derived PPOBuffer: fixed-size
numpy arrays, ``store`` per step, ``finish_path`` computes GAE-lambda
advantages and rewards-to-go with discounted cumulative sums
(``openAIcore.py:38-53``), ``get`` normalizes advantages.  The
normalization statistics are local by default (the reference's
num_procs()==1 path); pass ``stat_fn`` to reduce them across processes
(``utils.logging.statistics_scalar(distributed=True)``, the
``mpi_statistics_scalar`` of buffer.py:97).

``BufferContainer`` merges per-env buffers (buffer.py:110-181 equivalent).
"""

from __future__ import annotations

import numpy as np

__all__ = ["discount_cumsum", "PPOBuffer", "BufferContainer"]


def discount_cumsum(x: np.ndarray, discount: float) -> np.ndarray:
    """Backward discounted cumulative sum (openAIcore.py:38-53 semantics,
    scipy.signal.lfilter-free)."""
    out = np.zeros_like(x, dtype=np.float64)
    acc = 0.0
    for t in range(len(x) - 1, -1, -1):
        acc = x[t] + discount * acc
        out[t] = acc
    return out.astype(x.dtype) if x.dtype != np.float64 else out


class PPOBuffer:
    def __init__(self, obs_dim: int, act_dim: int, size: int,
                 gamma: float = 0.99, lam: float = 0.95,
                 num_entropy_heads: int = 18):
        self.obs_buf = np.zeros((size, obs_dim), np.float32)
        self.act_buf = np.zeros((size, act_dim), np.float32)
        self.adv_buf = np.zeros(size, np.float32)
        self.rew_buf = np.zeros(size, np.float32)
        self.ret_buf = np.zeros(size, np.float32)
        self.val_buf = np.zeros(size, np.float32)
        self.ent_buf = np.zeros(size, np.float32)
        self.entropy_heads_buf = np.zeros((size, num_entropy_heads),
                                          np.float32)
        self.logp_buf = np.zeros(size, np.float32)
        self.gamma, self.lam = gamma, lam
        self.ptr, self.path_start_idx, self.max_size = 0, 0, size

    def store(self, obs, act, rew, val, logp, ent, entropy_heads):
        assert self.ptr < self.max_size
        self.obs_buf[self.ptr] = obs
        self.act_buf[self.ptr] = act
        self.rew_buf[self.ptr] = rew
        self.val_buf[self.ptr] = val
        self.logp_buf[self.ptr] = logp
        self.ent_buf[self.ptr] = ent
        self.entropy_heads_buf[self.ptr] = entropy_heads
        self.ptr += 1

    def finish_path(self, last_val: float = 0.0):
        sl = slice(self.path_start_idx, self.ptr)
        rews = np.append(self.rew_buf[sl], last_val)
        vals = np.append(self.val_buf[sl], last_val)
        deltas = rews[:-1] + self.gamma * vals[1:] - vals[:-1]
        self.adv_buf[sl] = discount_cumsum(deltas, self.gamma * self.lam)
        self.ret_buf[sl] = discount_cumsum(rews, self.gamma)[:-1]
        self.path_start_idx = self.ptr

    def get(self, stat_fn=None):
        assert self.ptr == self.max_size, "buffer must be full"
        self.ptr, self.path_start_idx = 0, 0
        if stat_fn is None:
            adv_mean = float(self.adv_buf.mean())
            adv_std = float(self.adv_buf.std())
        else:
            adv_mean, adv_std = stat_fn(self.adv_buf)
        self.adv_buf = (self.adv_buf - adv_mean) / max(adv_std, 1e-8)
        return dict(obs=self.obs_buf.copy(), act=self.act_buf.copy(),
                    ret=self.ret_buf.copy(), adv=self.adv_buf.copy(),
                    logp=self.logp_buf.copy(), ent=self.ent_buf.copy(),
                    entropy_heads=self.entropy_heads_buf.copy())


class BufferContainer:
    """Per-env buffers merged at get() (buffer.py:110-181)."""

    def __init__(self, obs_dim, act_dim, size, num_buffers,
                 gamma=0.99, lam=0.95, num_entropy_heads=18):
        self.buffers = [
            PPOBuffer(obs_dim, act_dim, size, gamma, lam, num_entropy_heads)
            for _ in range(num_buffers)]

    def __getitem__(self, idx) -> PPOBuffer:
        return self.buffers[idx]

    def get(self, stat_fn=None):
        datas = [b.get(stat_fn=lambda a: (0.0, 1.0)) for b in self.buffers]
        merged = {k: np.concatenate([d[k] for d in datas])
                  for k in datas[0]}
        adv = merged["adv"]
        if stat_fn is None:
            mean, std = float(adv.mean()), float(adv.std())
        else:
            mean, std = stat_fn(adv)
        merged["adv"] = (adv - mean) / max(std, 1e-8)
        return merged
