"""The port stands alone: no ``jax`` and nothing of ``ldpc_tpu`` in
``ldpc_tpu_torch/``, ``chip_smoke.py`` or ``kernel_ab.py`` (the machine with the card has no
JAX), and its entry points refuse to run quietly on the CPU."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import near_earth_code, wifi_code
from ldpc_tpu_torch.ops.cuda_static import make_static_sweep_decoder
from ldpc_tpu_torch.ops import microbench
from ldpc_tpu_torch.ops.decoder import decode
from ldpc_tpu_torch.scripts import kernel_microbench
from ldpc_tpu_torch.sim.channel import (epsilon_probe, snr_db_to_sigma,
                                        transmit_zero_codeword)
from ldpc_tpu_torch.sim.evaluate import (evaluate_code,
                                         evaluate_epsilon_probe,
                                         make_staged_decoder_device,
                                         make_staged_sweep_device,
                                         sweep_step)
from ldpc_tpu_torch.utils.device import default_device
from ldpc_tpu_torch.utils.profiling import ThroughputTimer, device_roofline

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ldpc_tpu_torch"
FORBIDDEN = ("jax", "ldpc_tpu")
# the code-search scripts and a command line each accepts
SEARCH_SCRIPTS = {
    "chain_scoreboard": [], "discovered_code_waterfall": [],
    "floor_topk_select": ["--steps-tsv", "steps.tsv"],
    "floor_search_analysis": ["--steps-tsv", "steps.tsv"],
    "rl_search_wide": [], "rollout_throughput": [], "staging_grid": [],
    "reward_investigation": [], "reward_floor_frontier": [],
    "chain_figure": []}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "kernel_ab.py"]


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ldpc_tpu_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_BLOCKED_IMPORT = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["ldpc_tpu"] = None     # and any import of the JAX package
import ldpc_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    ldpc_tpu_torch.__path__, "ldpc_tpu_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "ldpc_tpu")))
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for m in ("ldpc_tpu_torch.ops.cuda_static", "ldpc_tpu_torch.sim.evaluate",
              "ldpc_tpu_torch.csrc", "ldpc_tpu_torch.codes.ccsds",
              "ldpc_tpu_torch.codes.wifi", "ldpc_tpu_torch.ops.decoder",
              "ldpc_tpu_torch.ops.oracle", "ldpc_tpu_torch.sim.stats",
              "ldpc_tpu_torch.cli", "ldpc_tpu_torch.ops.microbench",
              "ldpc_tpu_torch.utils.profiling",
              "ldpc_tpu_torch.scripts.kernel_microbench",
              "ldpc_tpu_torch.scripts.phi_sass",
              "ldpc_tpu_torch.ops.dynamic", "ldpc_tpu_torch.codes.codec",
              "ldpc_tpu_torch.codes.io", "ldpc_tpu_torch.codes.perturb",
              "ldpc_tpu_torch.sim.reward", "ldpc_tpu_torch.envs.spaces",
              "ldpc_tpu_torch.envs.code_search",
              "ldpc_tpu_torch.envs.vector", "ldpc_tpu_torch.rl.random_agent",
              "ldpc_tpu_torch.utils.cache", "ldpc_tpu_torch.utils.logging",
              "ldpc_tpu_torch.rl.buffer", "ldpc_tpu_torch.rl.model",
              "ldpc_tpu_torch.rl.ppo", "ldpc_tpu_torch.rl.train",
              "ldpc_tpu_torch.rl.vpg", "ldpc_tpu_torch.utils.checkpoint",
              "ldpc_tpu_torch.utils.experiment",
              "ldpc_tpu_torch.codes.encode", "ldpc_tpu_torch.native",
              "ldpc_tpu_torch.utils.provenance",
              "ldpc_tpu_torch.analysis.plots",
              "ldpc_tpu_torch.scripts.studies",
              "ldpc_tpu_torch.scripts.ber_parity",
              "ldpc_tpu_torch.scripts.random_codeword_check",
              "ldpc_tpu_torch.scripts.error_floor",
              "ldpc_tpu_torch.scripts.wifi_waterfall",
              "ldpc_tpu_torch.scripts.sort_ab",
              *(f"ldpc_tpu_torch.scripts.{name}" for name in SEARCH_SCRIPTS)):
        assert m in res["modules"]


def test_shift_table_is_the_port_own_copy():
    mine = PORT / "data" / "ccsds_near_earth.json"
    assert mine.read_bytes() == \
        (ROOT / "ldpc_tpu" / "data" / "ccsds_near_earth.json").read_bytes()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.delenv("LDPC_TPU_PLATFORM", raising=False)
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    code, wifi = near_earth_code(), wifi_code()
    calls = [default_device,
             lambda: make_static_sweep_decoder(code, 4),
             lambda: make_static_sweep_decoder(wifi, 4, kind="sum-product",
                                               store_dtype="float32"),
             lambda: make_staged_decoder_device(code),
             lambda: make_staged_decoder_device(code, engine="cuda"),
             lambda: make_staged_sweep_device(code),
             lambda: sweep_step(wifi),
             lambda: evaluate_code(wifi, [3.0], 4, 5),
             lambda: evaluate_code(wifi, [3.0], 4, 5, engine="cuda"),
             lambda: evaluate_epsilon_probe(wifi, max_iters=4),
             lambda: decode(wifi, [[-1.0] * wifi.n], 4),
             lambda: epsilon_probe(16),
             lambda: cli.main(["probe", "--iterations", "4"]),
             lambda: transmit_zero_codeword(2, 16, 3.0),
             lambda: snr_db_to_sigma(3.0),
             lambda: kernel_microbench.main(["--quick"]),
             lambda: microbench.fill_tiles("abs_add_baseline"),
             lambda: microbench.input_tile(1, 512, torch.float32),
             lambda: device_roofline(),
             lambda: ThroughputTimer()]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_code_search_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.delenv("LDPC_TPU_PLATFORM", raising=False)
    if torch.cuda.is_available():
        return
    from ldpc_tpu_torch.envs import EnvironmentVector, LdpcCodeSearchEnv
    from ldpc_tpu_torch.ops.dynamic import dynamic_plan
    from ldpc_tpu_torch.rl import run_random_agent
    wifi = wifi_code()
    calls = [lambda: LdpcCodeSearchEnv(),
             lambda: LdpcCodeSearchEnv(code=wifi, num_transmissions=2),
             lambda: EnvironmentVector(2, code=wifi),
             lambda: dynamic_plan(wifi),
             lambda: run_random_agent(num_steps=1),
             lambda: cli.main(["random-agent", "--code", "wifi", "--steps",
                               "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_validation_entry_points_raise_without_a_card(monkeypatch,
                                                      tmp_path):
    """The encoder, the random-codeword step, the studies and `cli
    getting-started` run on the card unless asked for the CPU; the studies
    raise before they write anything."""
    monkeypatch.delenv("LDPC_TPU_PLATFORM", raising=False)
    if torch.cuda.is_available():
        return
    import importlib
    from ldpc_tpu_torch.codes.encode import encode, encoder_for_code
    from ldpc_tpu_torch.sim.evaluate import random_codeword_sweep_step
    wifi = wifi_code()
    k = encoder_for_code(wifi).k_eff
    out = str(tmp_path / "art")
    calls = [lambda: encode(wifi, [[0] * k]),
             lambda: encoder_for_code(wifi)([[0] * k]),
             lambda: random_codeword_sweep_step(wifi),
             lambda: evaluate_code(wifi, [3.0], 4, 5, codewords="random"),
             lambda: cli.main(["getting-started"])]
    for name in ("ber_parity", "random_codeword_check", "error_floor",
                 "wifi_waterfall", "sort_ab"):
        mod = importlib.import_module(f"ldpc_tpu_torch.scripts.{name}")
        calls.append(lambda mod=mod: mod.main(["--out", out]))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", SEARCH_SCRIPTS)
def test_search_scripts_raise_without_a_card(monkeypatch, tmp_path, name):
    """Each code-search script runs on the card unless asked for the CPU,
    and raises before it reads or writes anything."""
    monkeypatch.delenv("LDPC_TPU_PLATFORM", raising=False)
    if torch.cuda.is_available():
        return
    import importlib
    mod = importlib.import_module(f"ldpc_tpu_torch.scripts.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(SEARCH_SCRIPTS[name] + ["--out", str(tmp_path / "art")])
    assert not list(tmp_path.iterdir())


def test_trainer_refuses_to_run_on_the_cpu_unless_asked(monkeypatch,
                                                        tmp_path):
    """ppo, vpg, train.main and ``cli train`` train on the card; without
    one, and without device="cpu" or LDPC_TPU_PLATFORM=cpu, they raise
    before they write anything."""
    monkeypatch.delenv("LDPC_TPU_PLATFORM", raising=False)
    if torch.cuda.is_available():
        return
    from ldpc_tpu_torch.rl import (ActorCriticConfig, init_params, ppo,
                                   vpg)
    from ldpc_tpu_torch.rl.train import main as train_main

    def env_fn():
        raise AssertionError("an env was built")

    out = tmp_path / "out"
    calls = [lambda: ppo(env_fn, output_dir=out),
             lambda: vpg(env_fn, output_dir=out),
             lambda: train_main(["--data_dir", str(out)]),
             lambda: cli.main(["train", "--data_dir", str(out)]),
             lambda: init_params(ActorCriticConfig())]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not out.exists()


def _run_chip_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_chip_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
