"""The port's GAE buffer (``ldpc_tpu_torch/rl/buffer.py``) against the JAX
package's (``ldpc_tpu/rl/buffer.py``): both are numpy, so on the same
numpy inputs every output is held EQUAL (no tolerance): the discounted
sums, GAE advantages and rewards-to-go, the merged container and the
normalised advantages, local and with a ``stat_fn``."""

import numpy as np
import pytest

from ldpc_tpu.rl import buffer as jax_buffer
from ldpc_tpu_torch.rl import buffer as port_buffer
from ldpc_tpu_torch.rl import (BufferContainer, PPOBuffer, discount_cumsum)


def test_discount_cumsum():
    x = np.array([1.0, 1.0, 1.0])
    np.testing.assert_allclose(discount_cumsum(x, 0.5), [1.75, 1.5, 1.0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("discount", [0.0, 0.5, 0.99 * 0.97, 1.0])
def test_discount_cumsum_equals_jax(dtype, discount):
    x = np.random.default_rng(3).standard_normal(37).astype(dtype)
    got = port_buffer.discount_cumsum(x, discount)
    want = jax_buffer.discount_cumsum(x, discount)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_buffer_gae():
    buf = PPOBuffer(obs_dim=2, act_dim=3, size=3, gamma=0.5, lam=1.0,
                    num_entropy_heads=2)
    for t in range(3):
        buf.store(np.zeros(2), np.zeros(3), rew=1.0, val=0.0, logp=-1.0,
                  ent=0.1, entropy_heads=np.zeros(2))
    buf.finish_path(last_val=0.0)
    data = buf.get(stat_fn=lambda a: (0.0, 1.0))
    np.testing.assert_allclose(data["ret"], [1.75, 1.5, 1.0])
    np.testing.assert_allclose(data["adv"], [1.75, 1.5, 1.0])


def _fill(mod, rng_seed, num_buffers, size, paths):
    """The same transitions into ``mod``'s container: per buffer, paths
    ending at the given steps (the last with a bootstrap value)."""
    rng = np.random.default_rng(rng_seed)
    bufs = mod.BufferContainer(obs_dim=5, act_dim=4, size=size,
                               num_buffers=num_buffers, gamma=0.99,
                               lam=0.97, num_entropy_heads=6)
    for b in range(num_buffers):
        for t in range(size):
            bufs[b].store(rng.standard_normal(5), rng.integers(0, 9, 4),
                          rew=float(rng.standard_normal()),
                          val=float(rng.standard_normal()),
                          logp=float(-rng.random() * 10),
                          ent=float(rng.random()),
                          entropy_heads=rng.random(6))
            if t + 1 in paths:
                bufs[b].finish_path(0.0 if t + 1 < size
                                    else float(rng.standard_normal()))
    return bufs


@pytest.mark.parametrize("stat", ["local", "given"])
@pytest.mark.parametrize("num_buffers", [1, 3])
def test_container_get_equals_jax(num_buffers, stat):
    """GAE, rewards-to-go and the normalised advantages of the merged
    buffers, element for element."""
    def stat_fn(a):
        return float(a.mean()) + 0.25, float(a.std()) * 2.0
    kw = {} if stat == "local" else {"stat_fn": stat_fn}
    paths = (4, 9, 16)
    got = _fill(port_buffer, 11, num_buffers, 16, paths).get(**kw)
    want = _fill(jax_buffer, 11, num_buffers, 16, paths).get(**kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if stat == "local":
        assert abs(float(got["adv"].mean())) < 1e-6


def test_single_buffer_get_equals_jax():
    rng = np.random.default_rng(5)
    bufs = [m.PPOBuffer(3, 2, 8, gamma=0.9, lam=0.8, num_entropy_heads=4)
            for m in (port_buffer, jax_buffer)]
    for t in range(8):
        row = (rng.standard_normal(3), rng.integers(0, 4, 2),
               float(rng.standard_normal()), float(rng.standard_normal()),
               float(-rng.random()), float(rng.random()), rng.random(4))
        for b in bufs:
            b.store(*row)
        if t in (2, 7):
            for b in bufs:
                b.finish_path(0.5)
    got, want = (b.get() for b in bufs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_get_needs_a_full_buffer():
    buf = BufferContainer(2, 2, 3, 1)
    buf[0].store(np.zeros(2), np.zeros(2), 1.0, 0.0, 0.0, 0.0,
                 np.zeros(18))
    with pytest.raises(AssertionError):
        buf.get()
