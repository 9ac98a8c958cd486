"""The port's native C++ engine (``ldpc_tpu_torch/native``) against the JAX
package's native engine, the numpy oracle and the torch engine, on the
same numpy LLRs.  Skips only where ``g++`` is absent."""

import shutil

import numpy as np
import pytest
import torch

from ldpc_tpu import native as jax_native
from ldpc_tpu_torch import native
from ldpc_tpu_torch.codes import wifi_code
from ldpc_tpu_torch.ops.decoder import decoder_for_code
from ldpc_tpu_torch.ops.oracle import dense_min_sum_decode

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    assert native.available()


def _llrs(n, b, sigma, seed):
    return -1.0 + np.random.RandomState(seed).normal(0, sigma, (b, n))


def test_native_matches_jax_native_and_numpy_oracle(gxx):
    code = wifi_code()
    h = code.to_dense(np.int8)
    llrs = _llrs(code.n, 6, 0.45, 11)
    got = native.native_min_sum_decode(h, llrs, 25)
    want = jax_native.native_min_sum_decode(h, llrs, 25)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    hard, soft, iters, ok = got
    for i in range(6):
        oh, osf, oit, ook = dense_min_sum_decode(h, llrs[i], 25)
        assert ok[i] == ook and iters[i] == oit
        assert np.array_equal(hard[i], oh)
        np.testing.assert_allclose(soft[i], osf, rtol=1e-12, atol=1e-12)


def test_native_matches_torch_engine_on_converged_words(gxx):
    """float64 on a dense H against the torch engine's float32: every word
    here converges and both give the same decisions and iterations."""
    code = wifi_code()
    llrs = _llrs(code.n, 8, 0.4, 3)
    hard, _, iters, ok = native.native_min_sum_decode(
        code.to_dense(np.int8), llrs, 25)
    res = decoder_for_code(code, 25)(torch.from_numpy(
        llrs.astype(np.float32)))
    assert ok.all() and res.success.all()
    assert np.array_equal(iters, res.iterations.numpy())
    assert np.array_equal(hard, res.hard.numpy())


def test_native_single_word_shape(gxx):
    code = wifi_code()
    hard, soft, iters, ok = native.native_min_sum_decode(
        code.to_dense(np.int8), np.full(code.n, -1.0), 5)
    assert hard.shape == (1, code.n) and iters[0] == 0 and ok[0]


def test_native_builds_into_the_port_build_directory(gxx):
    so = native.build()
    assert so.parent.name == "_build"
    assert so.parent.parent.name == "ldpc_tpu_torch"
    assert so.name.startswith("libldpc_native-")


def test_available_reports_a_missing_compiler(monkeypatch, tmp_path):
    """Without g++ (and no built library) available() is False, not an
    exception."""
    import importlib
    mod = importlib.reload(native)
    try:
        monkeypatch.setattr(mod, "_BUILD_DIR", tmp_path)
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
        assert mod.available() is False
        with pytest.raises(RuntimeError):
            mod.native_min_sum_decode(np.ones((1, 2), np.int8),
                                      np.zeros(2), 1)
    finally:
        monkeypatch.undo()
        importlib.reload(native)
