"""The port's code-search env, vector env, random agent and CLI commands on
the CPU (``device="cpu"``: the plain torch route, ``ops/dynamic.py``).

* Every case of ``tests/test_envs.py`` but the PPO trainer's (in
  ``tests/test_torch_train.py``), mirrored on the port's env; the mesh
  case on a one-rank group here, on 2 and 4 ranks in
  ``tests/test_torch_parallel.py``.
* The port env and the JAX env given the same numpy batches (``_transmit``
  replaced on both instances, each still drawing its one seed a step):
  the same legal flags, shifts, observations, accumulated iterations,
  dones and rewards.  The rewards agree to 1e-9 with words failing too:
  the two dynamic decoders agree bit for bit on the non-converged min-sum
  words at these sizes as well (``tests/test_torch_dynamic.py``), and the
  reward fit is the same numpy code on the same numbers.
* ``run_random_agent`` with one seed walks the same codes in both
  packages.
* ``random-agent`` and ``perturb`` through the port's CLI on the CPU.
* The loggers the agent writes through (``utils/logging.py``) against the
  JAX package's, and ``statistics_scalar`` across two gloo ranks.
"""

import json

import numpy as np
import pytest
import torch

from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.envs import EnvironmentVector as JaxVector
from ldpc_tpu.envs import LdpcCodeSearchEnv as JaxEnv
from ldpc_tpu.rl import run_random_agent as jax_random_agent
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import near_earth_code, uncompress, wifi_code
from ldpc_tpu_torch.envs import (BinarySpace, EnvironmentVector,
                                 LdpcCodeSearchEnv, Uint8Space,
                                 register_gymnasium)
from ldpc_tpu_torch.rl import run_random_agent

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

SMALL = dict(snr_points=(3.0, 3.5), num_transmissions=4, num_iterations=10,
             seed=3, dmax_cn_cap=24, dmax_vn_cap=8)


def small_env(**kw):
    """Wifi-based env on the CPU: small code -> fast CPU decodes."""
    defaults = dict(code=wifi_code(), device="cpu", **SMALL)
    defaults.update(kw)
    return LdpcCodeSearchEnv(**defaults)


def test_binary_space():
    s = BinarySpace(516)
    s.seed(0)
    x = s.sample()
    assert x.shape == (516,) and s.contains(x)
    assert not s.contains(np.full(516, 2))
    assert not s.contains(np.zeros(5, np.int32))


def test_uint8_space():
    s = Uint8Space(2048)
    s.seed(0)
    x = s.sample()
    assert s.contains(x)
    assert not s.contains(x.astype(np.int32))


def test_env_near_earth_shapes():
    env = LdpcCodeSearchEnv(device="cpu")  # defaults: near-earth
    assert env.action_bits == 1 + 4 + 511
    assert env.observation_space.shape == (2048,)
    obs = env.reset()
    assert obs.dtype == np.uint8 and obs.shape == (2048,)
    assert env.uncompress(obs).shifts == near_earth_code().shifts
    assert env.device == torch.device("cpu")


def test_env_step_legal_action():
    env = small_env()
    obs0 = env.reset()
    xb, yb = env.x_bits, env.y_bits
    action = np.zeros(env.action_bits, np.int32)
    action[xb + yb + 5] = 1  # install single-shift circulant at block (0,0)
    obs, reward, done, info = env.step(action)
    assert info["legal"]
    assert env.state.shifts[0][0] == (5,)
    assert not np.array_equal(obs, obs0)
    assert isinstance(reward, float) and reward != env.reward_for_illegal_action
    assert info["accumulated_evaluation_time"] > 0


def test_env_step_degree_cap_illegal():
    env = small_env(dmax_cn_cap=20)  # wifi rows are already degree 19-20
    env.reset()
    xb, yb = env.x_bits, env.y_bits
    action = np.zeros(env.action_bits, np.int32)
    action[xb + yb:xb + yb + 10] = 1  # 10 hot bits -> row degree blows cap
    state_before = env.state
    obs, reward, done, info = env.step(action)
    assert not info["legal"]
    assert reward == env.reward_for_illegal_action
    assert env.state is state_before


def test_env_reward_tracks_code_quality():
    env = small_env(num_transmissions=6)
    env.reset()
    xb, yb = env.x_bits, env.y_bits
    benign = np.zeros(env.action_bits, np.int32)
    benign[xb + yb + 13] = 1  # same shift as current (0,0) block: no-op
    _, r_benign, _, _ = env.step(benign)
    assert env.state.shifts == wifi_code().shifts  # literally unchanged
    env.reset()
    env.seed(3)


def _bits(value, width):
    return [int(b) for b in np.binary_repr(value, width)]


def test_env_replacement_only_swaps():
    env = small_env(replacement_only=True)
    env.reset()
    a00 = env.state.shifts[0][0]
    a12 = env.state.shifts[1][2]
    xb, yb = env.x_bits, env.y_bits
    action = np.array(_bits(0, xb) + _bits(0, yb) +
                      _bits(1, xb) + _bits(2, yb), np.int32)
    obs, reward, done, info = env.step(action)
    assert info["legal"]
    assert env.state.shifts[0][0] == a12
    assert env.state.shifts[1][2] == a00


def test_env_time_budget_terminates():
    env = small_env(time_budget_s=0.0)
    env.reset()
    xb, yb = env.x_bits, env.y_bits
    action = np.zeros(env.action_bits, np.int32)
    action[xb + yb] = 1
    _, _, done, _ = env.step(action)
    assert done


def test_env_reset_restores_initial_code():
    env = small_env()
    env.reset()
    xb, yb = env.x_bits, env.y_bits
    action = np.zeros(env.action_bits, np.int32)
    action[xb + yb + 7] = 1
    env.step(action)
    assert env.state.shifts != wifi_code().shifts
    env.reset()
    assert env.state.shifts == wifi_code().shifts
    assert env.accumulated_evaluation_time == 0.0


def test_environment_vector_batched_matches_sequential():
    """The fused vector step must reproduce sequential per-env stepping:
    same rewards, iterations, states."""
    def fns():
        return [lambda: small_env(seed=1), lambda: small_env(seed=2),
                lambda: small_env(seed=5)]

    seq = EnvironmentVector(fns(), batched=False)
    bat = EnvironmentVector(fns(), batched=True)
    seq.reset(), bat.reset()
    xb, yb = seq.envs[0].x_bits, seq.envs[0].y_bits
    rng = np.random.RandomState(0)
    for _ in range(2):
        actions = []
        for _ in range(3):
            a = np.zeros(seq.action_space.shape[0], np.int32)
            a[xb + yb + rng.randint(0, seq.envs[0].z)] = 1
            actions.append(a)
        # one deliberately illegal action (out-of-range block row)
        actions[2][:xb] = 1
        actions[2][0] = 1 if seq.envs[0].state.block_rows <= (
            1 << (xb - 1)) else actions[2][0]
        _, r_seq, d_seq, i_seq = seq.step(actions)
        _, r_bat, d_bat, i_bat = bat.step(actions)
        np.testing.assert_allclose(r_bat, r_seq, rtol=1e-6)
        assert list(d_bat) == list(d_seq)
        assert [i["legal"] for i in i_bat] == [i["legal"] for i in i_seq]
        for es, eb in zip(seq.envs, bat.envs):
            assert es.state.shifts == eb.state.shifts
            assert es.accumulated_iterations == eb.accumulated_iterations


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group in this process for the test, then none."""
    import torch.distributed as dist
    from ldpc_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_environment_vector_mesh_waits_for_parallel(one_rank_mesh):
    """``mesh=`` (once refused, waiting for ``parallel/``): with a mesh,
    ``batched=None`` fuses the step, its candidates go through the
    sharded decode, and the results equal sequential stepping's."""
    fns = [(lambda s=s: small_env(seed=s)) for s in (1, 2)]
    meshed = EnvironmentVector(fns, mesh=one_rank_mesh)
    seq = EnvironmentVector(fns, batched=False)
    meshed.reset(), seq.reset()
    fused = []
    orig = EnvironmentVector._decode_live

    def spy(self, live, llrs):
        fused.append(len(live))
        return orig(self, live, llrs)

    xb, yb = seq.envs[0].x_bits, seq.envs[0].y_bits
    rng = np.random.RandomState(4)
    EnvironmentVector._decode_live = spy
    try:
        for _ in range(2):
            actions = []
            for _ in range(2):
                a = np.zeros(seq.action_space.shape[0], np.int32)
                a[xb + yb + rng.randint(0, seq.envs[0].z)] = 1
                actions.append(a)
            _, r_mesh, d_mesh, _ = meshed.step(actions)
            _, r_seq, d_seq, _ = seq.step(actions)
            assert list(r_mesh) == list(r_seq)
            assert list(d_mesh) == list(d_seq)
    finally:
        EnvironmentVector._decode_live = orig
    assert fused == [2, 2]
    for em, es in zip(meshed.envs, seq.envs):
        assert em.state.shifts == es.state.shifts
        assert em.accumulated_iterations == es.accumulated_iterations


def test_env_iteration_budget_is_default_terminator():
    env = small_env()
    assert env.iteration_budget == 64 * env.num_transmissions * \
        env.num_iterations
    env2 = small_env(iteration_budget=None)
    assert env2.iteration_budget is None


def test_vector_budget_termination_identical_fused_vs_sequential():
    def fns(budget):
        return [(lambda s=s: small_env(seed=s, iteration_budget=budget))
                for s in (1, 2)]

    budget = 40
    seq = EnvironmentVector(fns(budget), batched=False)
    bat = EnvironmentVector(fns(budget), batched=True)
    seq.reset(), bat.reset()
    xb, yb = seq.envs[0].x_bits, seq.envs[0].y_bits
    done_steps_seq = []
    for t in range(6):
        actions = []
        for k in range(2):
            a = np.zeros(seq.action_space.shape[0], np.int32)
            a[xb + yb + 3 + k + t] = 1
            actions.append(a)
        _, _, d_seq, _ = seq.step(actions)
        _, _, d_bat, _ = bat.step(actions)
        assert list(d_seq) == list(d_bat)
        done_steps_seq.append(list(d_seq))
    assert any(any(d) for d in done_steps_seq), \
        "budget never tripped — test budget too large"
    for es, eb in zip(seq.envs, bat.envs):
        assert es.accumulated_iterations == eb.accumulated_iterations


def test_environment_vector_batched_rejects_mixed():
    with pytest.raises(ValueError):
        EnvironmentVector(
            [lambda: small_env(seed=1),
             lambda: small_env(seed=2, num_iterations=12)], batched=True)


def test_environment_vector():
    vec = EnvironmentVector(
        [lambda: small_env(seed=1), lambda: small_env(seed=2)])
    obs = vec.reset()
    assert obs.shape == (2, vec.observation_space.shape[0])
    xb, yb = vec.envs[0].x_bits, vec.envs[0].y_bits
    action = np.zeros(vec.action_space.shape[0], np.int32)
    action[xb + yb + 3] = 1
    obs, rewards, dones, infos = vec.step([action, action])
    assert obs.shape[0] == 2 and rewards.shape == (2,)
    assert all(i["legal"] for i in infos)
    assert vec.envs[0].state.shifts == vec.envs[1].state.shifts


def test_env_per_point_transmissions_and_floor_penalty():
    def mk(penalty):
        return LdpcCodeSearchEnv(
            code=wifi_code(), snr_points=(1.0, 4.5),
            num_transmissions=(4, 32), num_iterations=6, seed=3,
            dmax_cn_cap=32, dmax_vn_cap=12, floor_penalty=penalty,
            device="cpu")

    base, pen = mk(0.0), mk(40.0)
    assert base.tx_counts.tolist() == [4, 32]
    row = np.zeros(base.z, np.int32)
    row[[3, 17, 42]] = 1   # legal: 3-hot replacement at block (0, 0)
    a = np.concatenate([np.zeros(base.x_bits + base.y_bits, np.int32), row])
    obs0, r0, d0, i0 = base.step(a)
    obs1, r1, d1, i1 = pen.step(a)
    sel = pen.ber_stats.column("snr") == 4.5
    fer = (pen.ber_stats.column("frame_errors")[sel].sum()
           / pen.ber_stats.column("weight")[sel].sum())
    assert i0["legal"] and i1["legal"]
    np.testing.assert_allclose(r1, r0 - 40.0 * fer, rtol=1e-12)
    assert pen.ber_stats.column("weight").sum() == 36


def test_env_multi_point_floor_penalty_and_anneal_scale():
    def mk(**kw):
        return LdpcCodeSearchEnv(
            code=wifi_code(), snr_points=(1.0, 4.0, 4.5),
            num_transmissions=(4, 16, 32), num_iterations=6, seed=3,
            dmax_cn_cap=32, dmax_vn_cap=12, device="cpu", **kw)

    base = mk()
    multi = mk(floor_penalty=(20.0, 40.0), floor_snr_index=(1, 2))
    row = np.zeros(base.z, np.int32)
    row[[3, 17, 42]] = 1
    a = np.concatenate([np.zeros(base.x_bits + base.y_bits, np.int32), row])
    _, r0, _, _ = base.step(a)
    multi.floor_penalty_scale = 1.5
    _, r1, _, i1 = multi.step(a)
    assert i1["legal"]
    fers = []
    for snr in (4.0, 4.5):
        sel = multi.ber_stats.column("snr") == snr
        fers.append(multi.ber_stats.column("frame_errors")[sel].sum()
                    / multi.ber_stats.column("weight")[sel].sum())
    np.testing.assert_allclose(
        r1, r0 - 1.5 * (20.0 * fers[0] + 40.0 * fers[1]), rtol=1e-12)
    both = mk(floor_penalty=25.0, floor_snr_index=(1, 2))
    assert both.floor_penalties.tolist() == [25.0, 25.0]
    with pytest.raises(ValueError):
        mk(floor_penalty=(1.0, 2.0), floor_snr_index=(0, 1, 2))


@pytest.mark.parametrize("index,want", [
    (0, [0]), (2, [2]), (-1, [2]), (-3, [0]), ((1, -1), [1, 2]),
    (3, None), (-4, None), ((0, 3), None)])
def test_env_floor_snr_index_must_name_a_point(index, want):
    """An index counts from the end when negative; one that names no SNR
    point raises in the constructor, not at the first legal step."""
    def mk():
        return LdpcCodeSearchEnv(
            code=wifi_code(), snr_points=(1.0, 4.0, 4.5),
            num_transmissions=4, num_iterations=6, floor_penalty=10.0,
            floor_snr_index=index, device="cpu")

    if want is None:
        with pytest.raises(ValueError, match="out of range"):
            mk()
    else:
        assert mk().floor_snr_indices.tolist() == want


def test_env_staged_dynamic_decode_identical():
    """phase1_iterations gives IDENTICAL step results to the single-pass
    env (the over-25% branch: most words fail phase 1 at 2.0 dB)."""
    kw = dict(code=wifi_code(), snr_points=(2.0, 4.5),
              num_transmissions=(12, 12), num_iterations=12, seed=5,
              dmax_cn_cap=32, dmax_vn_cap=12)
    plain = LdpcCodeSearchEnv(device="cpu", **kw)
    staged = LdpcCodeSearchEnv(device="cpu", phase1_iterations=4, **kw)
    row = np.zeros(plain.z, np.int32)
    row[[1, 9, 30]] = 1
    a = np.concatenate([np.zeros(plain.x_bits + plain.y_bits, np.int32),
                        row])
    _, r0, _, i0 = plain.step(a)
    _, r1, _, i1 = staged.step(a)
    nfail = int((staged.ber_stats.column("iterations") > 4).sum())
    assert nfail > 0.25 * 24, nfail
    assert r0 == r1
    assert (i0["accumulated_iterations"] == i1["accumulated_iterations"])
    for colname in ("errors_decoded", "iterations", "success"):
        np.testing.assert_array_equal(plain.ber_stats.column(colname),
                                      staged.ber_stats.column(colname))


def test_env_staged_dynamic_decode_chunked_branch():
    """The chunked phase-2 path (few failures: pad/gather/scatter merge)
    is also exact."""
    kw = dict(code=wifi_code(), snr_points=(3.2,), num_transmissions=64,
              num_iterations=16, seed=9, dmax_cn_cap=32, dmax_vn_cap=12)
    plain = LdpcCodeSearchEnv(device="cpu", **kw)
    staged = LdpcCodeSearchEnv(device="cpu", phase1_iterations=8, **kw)
    row = np.zeros(plain.z, np.int32)
    row[[2, 11, 40]] = 1
    a = np.concatenate([np.zeros(plain.x_bits + plain.y_bits, np.int32),
                        row])
    _, r0, _, _ = plain.step(a)
    _, r1, _, _ = staged.step(a)
    nfail = int((staged.ber_stats.column("iterations") > 8).sum())
    assert 0 < nfail <= 0.25 * 64, nfail
    assert r0 == r1
    for colname in ("errors_decoded", "iterations", "success"):
        np.testing.assert_array_equal(plain.ber_stats.column(colname),
                                      staged.ber_stats.column(colname))


def test_env_other_backend_decodes_with_the_torch_decoder():
    """decoder_backend other than "dynamic": ops.decoder (the same rule,
    so the same step results as the dynamic route)."""
    row = np.zeros(81, np.int32)
    row[[4, 50]] = 1
    out = []
    for backend in ("dynamic", "static"):
        env = small_env(decoder_backend=backend, snr_points=(2.6, 3.4))
        a = np.concatenate([np.zeros(env.x_bits + env.y_bits, np.int32),
                            row])
        out.append((env.step(a), env.ber_stats))
    (o0, r0, d0, i0), s0 = out[0]
    (o1, r1, d1, i1), s1 = out[1]
    assert np.array_equal(o0, o1) and r0 == r1
    assert i0["accumulated_iterations"] == i1["accumulated_iterations"]
    for colname in ("errors_decoded", "iterations", "success"):
        np.testing.assert_array_equal(s0.column(colname), s1.column(colname))


# --- the port's env against the JAX env, on the same numpy batches --------

class _Batches:
    """The same numpy (SNR x transmissions) batch for both envs' step t;
    each replaced ``_transmit`` still draws its env's one seed a step."""

    def __init__(self, seed):
        self.seed = seed
        self.cache = {}

    def batch(self, t, snr_points, tx_counts, n):
        if t not in self.cache:
            rng = np.random.default_rng([self.seed, t])
            snr = np.repeat(snr_points, tx_counts)
            sigma = np.sqrt(0.5 / 10 ** (snr / 10)).astype(np.float32)
            noise = (sigma[:, None] * rng.standard_normal(
                (snr.size, n))).astype(np.float32)
            sig_act = np.sqrt(np.mean(noise * noise, axis=-1))
            self.cache[t] = (snr, (-1.0 + noise).astype(np.float32), sigma,
                             sig_act.astype(np.float32))
        return self.cache[t]

    def install(self, env, port: bool):
        calls = [0]

        def transmit():
            env.rng.randint(0, 2 ** 31 - 1)
            snr, noisy, sigma, sig_act = self.batch(
                calls[0], env.snr_points, env.tx_counts, env.state.n)
            calls[0] += 1
            if not port:
                return snr, noisy, sigma, sig_act
            t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
            return snr, t(noisy), t(sigma), t(sig_act)

        env._transmit = transmit
        return env


def _actions(env, steps, seed):
    """Mixed actions: 1-4 hot bits (some rows over the cap), an
    out-of-range block row, a no-op."""
    rng = np.random.RandomState(seed)
    out = []
    for t in range(steps):
        x = rng.randint(0, 1 << env.x_bits)
        y = rng.randint(0, 1 << env.y_bits)
        row = np.zeros(env.z, np.int32)
        row[rng.choice(env.z, rng.randint(1, 5 if t % 3 else 9),
                       replace=False)] = 1
        out.append(np.concatenate([_bits(x, env.x_bits),
                                   _bits(y, env.y_bits), row]).astype(
                                       np.int32))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(snr_points=(2.4, 3.6), phase1_iterations=4),
    dict(snr_points=(1.0, 4.0), num_transmissions=(3, 9),
         floor_penalty=30.0, iteration_budget=400),
    dict(decoder_kind="normalized-min-sum", snr_points=(2.6, 3.4)),
], ids=["reference", "staged", "floor", "normalized"])
def test_port_env_matches_jax_env_on_the_same_batches(kw):
    args = dict(SMALL, **kw)
    port = _Batches(11).install(LdpcCodeSearchEnv(
        code=wifi_code(), device="cpu", **args), port=True)
    jax_env = _Batches(11).install(JaxEnv(code=jax_wifi_code(), **args),
                                   port=False)
    assert np.array_equal(port.reset(), jax_env.reset())
    converged_all = []
    for a in _actions(port, 8, seed=4):
        o1, r1, d1, i1 = port.step(a)
        o2, r2, d2, i2 = jax_env.step(a)
        assert i1["legal"] == i2["legal"]
        assert port.state.shifts == jax_env.state.shifts
        assert np.array_equal(o1, o2) and d1 == d2
        assert i1["accumulated_iterations"] == i2["accumulated_iterations"]
        np.testing.assert_allclose(r1, r2, rtol=0, atol=1e-9)
        if i1["legal"]:
            for colname in ("errors_decoded", "iterations", "success"):
                np.testing.assert_array_equal(
                    port.ber_stats.column(colname),
                    jax_env.ber_stats.column(colname))
            converged_all.append(bool(port.ber_stats.column(
                "success").all()))
        if d1:
            port.reset(), jax_env.reset()
    # steps where every word converged and steps where some failed
    assert converged_all
    if not kw:
        assert True in converged_all
    if "phase1_iterations" in kw:
        assert False in converged_all


def test_port_vector_matches_jax_vector_on_the_same_batches():
    def fns(make, seeds):
        return [(lambda s=s: make(s)) for s in seeds]

    def port_env(s):
        return LdpcCodeSearchEnv(code=wifi_code(), device="cpu",
                                 **dict(SMALL, seed=s))

    def jax_env(s):
        return JaxEnv(code=jax_wifi_code(), **dict(SMALL, seed=s))

    port = EnvironmentVector(fns(port_env, (1, 2)), batched=True)
    jvec = JaxVector(fns(jax_env, (1, 2)), batched=True)
    for k, (pe, je) in enumerate(zip(port.envs, jvec.envs)):
        _Batches(20 + k).install(pe, port=True)
        _Batches(20 + k).install(je, port=False)
    for a, b in zip(_actions(port.envs[0], 3, 1), _actions(port.envs[0],
                                                            3, 2)):
        o1, r1, d1, i1 = port.step([a, b])
        o2, r2, d2, i2 = jvec.step([a, b])
        assert np.array_equal(o1, o2) and list(d1) == list(d2)
        np.testing.assert_allclose(r1, r2, rtol=0, atol=1e-9)
        assert [i["legal"] for i in i1] == [i["legal"] for i in i2]
        for pe, je in zip(port.envs, jvec.envs):
            assert pe.accumulated_iterations == je.accumulated_iterations


def test_random_agent_walks_the_same_codes_in_both_packages():
    def record(env):
        walked = []
        step = env.step

        def recorded(action):
            out = step(action)
            walked.append(env.state.shifts)
            return out

        env.step = recorded
        return walked

    port = _Batches(5).install(small_env(seed=8), port=True)
    jenv = _Batches(5).install(JaxEnv(code=jax_wifi_code(),
                                      **dict(SMALL, seed=8)), port=False)
    w1, w2 = record(port), record(jenv)
    r1, _ = run_random_agent(port, num_steps=6, seed=17)
    r2, _ = jax_random_agent(jenv, num_steps=6, seed=17)
    assert w1 == w2 and len(w1) == 6
    np.testing.assert_allclose(r1, r2, rtol=0, atol=1e-9)
    assert len(set(w1)) > 1


def test_random_agent_checks_the_codec_every_step(monkeypatch):
    env = small_env()
    seen = []
    real = env.uncompress

    def spy(obs):
        seen.append(obs.copy())
        return real(obs)

    monkeypatch.setattr(env, "uncompress", spy)
    rewards, env = run_random_agent(env, num_steps=3, seed=2)
    assert len(rewards) == 3 and len(seen) == 3
    assert uncompress(seen[-1], 4, 24, 81).shifts == env.state.shifts


def test_cli_random_agent_and_perturb_on_the_cpu(monkeypatch, tmp_path,
                                                 capsys):
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    rewards = cli.main(["random-agent", "--code", "wifi", "--steps", "2",
                        "--transmissions", "2", "--seed", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"rewards": rewards} and len(rewards) == 2
    got = cli.main(["perturb", "--code", "wifi", "--out", str(tmp_path)])
    assert got == {"written": 96, "dir": str(tmp_path)}
    from ldpc_tpu.codes import io as jio
    files = sorted(tmp_path.glob("*.npz"))
    assert len(files) == 96
    code, _ = jio.load_code_instance(files[0])
    assert any(b == () for row in code.shifts for b in row)
    default = cli.build_parser().parse_args(["perturb"])
    assert default.out.endswith("ldpc_tpu_test_matrices")
    ra = cli.build_parser().parse_args(["random-agent"])
    assert (ra.code, ra.steps, ra.transmissions, ra.seed) == (
        "near-earth", 10, 10, 42)


def test_register_gymnasium_names_the_port():
    try:
        import gymnasium
    except ImportError:
        assert register_gymnasium() is False
        return
    assert register_gymnasium("ldpc_tpu_torch/Test-v0")
    spec = gymnasium.spec("ldpc_tpu_torch/Test-v0")
    assert spec.entry_point == \
        "ldpc_tpu_torch.envs.code_search:LdpcCodeSearchEnv"


# --- utils/logging: the loggers, against the JAX package's ---------------

def test_loggers_write_what_the_jax_loggers_write(tmp_path, capsys):
    from ldpc_tpu.utils import logging as jlog
    from ldpc_tpu_torch.utils import logging as tlog
    assert tlog.colorize("x", "red", bold=True) == \
        jlog.colorize("x", "red", bold=True)
    x = np.random.default_rng(0).normal(size=50)
    assert tlog.statistics_scalar(x, with_min_and_max=True) == \
        jlog.statistics_scalar(x, with_min_and_max=True)
    assert tlog.statistics_scalar([]) == jlog.statistics_scalar([])
    for mod, name in ((tlog, "port"), (jlog, "jax")):
        tsv = mod.TsvLogger(["step", "reward"], path=tmp_path / name /
                            "steps.tsv", print_rows=True)
        tsv.log(step=0, reward=0.25)
        tsv.log(step=1, reward=-2.0)
        ep = mod.EpochLogger(tmp_path / name, exp_name="t",
                             distributed=True)
        ep.save_config({"seed": 3})
        for epoch in range(2):
            ep.store(Ret=[1.0 + epoch, 2.0])
            ep.log_tabular("Epoch", epoch)
            ep.log_tabular("Ret", with_min_and_max=True)
            ep.dump_tabular()
        ep.close()
        with pytest.raises(ValueError, match="cannot append"):
            mod.TsvLogger(["other"], path=tmp_path / name / "steps.tsv",
                          append=True)
    for f in ("steps.tsv", "progress.txt", "config.json"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text(), f
    out = capsys.readouterr().out
    assert out.count("AverageRet") == 4


def _gloo_rank(rank, path, out):
    import torch.distributed as dist
    from ldpc_tpu_torch.utils import logging as tlog
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=2, rank=rank)
    try:
        x = np.arange(3.0) + 10.0 * rank
        out.put((rank, tlog._is_chief(),
                 tlog.statistics_scalar(x, with_min_and_max=True,
                                        distributed=True),
                 tlog.statistics_scalar(x)))
    finally:
        dist.destroy_process_group()


def test_statistics_scalar_gathers_across_gloo_ranks(tmp_path):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, tmp_path / "rendezvous", out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict((r, rest) for r, *rest in (out.get(timeout=120)
                                          for _ in procs))
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    both = np.concatenate([np.arange(3.0), np.arange(3.0) + 10.0])
    want = (both.mean(), both.std(), both.min(), both.max())
    for rank, (chief, dist_stats, local) in got.items():
        assert chief == (rank == 0)
        np.testing.assert_allclose(dist_stats, want, rtol=1e-12)
        x = np.arange(3.0) + 10.0 * rank
        np.testing.assert_allclose(local, (x.mean(), x.std()), rtol=1e-12)
