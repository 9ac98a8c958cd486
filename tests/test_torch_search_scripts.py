"""The code-search scripts of ``ldpc_tpu_torch/scripts/``
(``chain_scoreboard``, ``discovered_code_waterfall``, ``floor_topk_select``,
``floor_search_analysis``, ``rl_search_wide``, ``rollout_throughput``,
``staging_grid``, ``reward_investigation``, ``reward_floor_frontier``,
``chain_figure``) and the carried chain (``data/chain/``): each script runs
on the CPU at a tiny size into ``--out`` (the fused kernel's plain version,
``ops/dynamic.py`` for the env), and each piece is held to the JAX package:
its code instances, its scripts' functions and its committed artifacts."""

import ast
import copy
import importlib.util
import json
import pathlib
import random
import types

import numpy as np
import pytest
import torch

from ldpc_tpu.codes.io import load_code_instance as jax_load_instance
from ldpc_tpu_torch.codes import (QCCode, compress, near_earth_code,
                                  save_code_json, wifi_code)
from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
from ldpc_tpu_torch.scripts import (chain_figure, chain_scoreboard,
                                    discovered_code_waterfall,
                                    floor_search_analysis, floor_topk_select,
                                    reward_floor_frontier,
                                    reward_investigation, rl_search_wide,
                                    rollout_throughput, staging_grid, studies)
from ldpc_tpu_torch.sim.evaluate import StagedDecoder

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DOCS = ROOT / "docs"
# the carried chain members, in the JAX scoreboard's order
CHAIN_NAMES = ["s47", "boot_s52", "topk_r4", "floor2", "floor2_late"]
HEADER = ("epoch\tstep\tenv\treward\tvalue\tlogp\ti\tj\tk\t"
          "observation_hex")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    # a run without --out writes nowhere on the CPU
    monkeypatch.setattr(studies, "DATA", tmp_path / "data")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _doc(name):
    return json.loads((DOCS / name).read_text())


def _written(base):
    doc = json.loads(pathlib.Path(f"{base}.json").read_text())
    assert pathlib.Path(f"{base}.md").read_text().startswith("# ")
    assert doc["device"] == "cpu" and len(doc["kernel_hash"]) == 64
    return doc


def _shifts(code):
    return [[sorted(int(s) for s in b) for b in row] for row in code.shifts]


def _steps_tsv(path, codes, rewards):
    """A steps.tsv as ``rl.ppo`` writes it, one row a (code, reward)."""
    rows = [HEADER]
    for i, (code, r) in enumerate(zip(codes, rewards)):
        rows.append(f"{i // 3}\t{i % 3}\t0\t{r}\t0.1\t-3.0\t{i % 2}\t{i % 5}"
                    f"\t{i % 7}\t{compress(code).tobytes().hex()}")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _mutated_wifi(block=(0, 0), shift=5):
    w = wifi_code()
    shifts = [[list(b) for b in row] for row in w.shifts]
    mb, nb = block
    shifts[mb][nb] = [(s + shift) % w.z for s in shifts[mb][nb]] or [shift]
    return QCCode(z=w.z, shifts=shifts, name="mutated")


# --- the carried chain ---------------------------------------------------

@pytest.mark.parametrize("name", CHAIN_NAMES)
def test_carried_chain_code_equals_the_jax_instance(name):
    entry = studies.chain_index()["codes"][name]
    npz = ROOT / entry["instance"]
    import hashlib
    assert hashlib.sha256(npz.read_bytes()).hexdigest() == entry["sha256"]
    mine, source = studies.resolve_code(name)
    theirs = jax_load_instance(str(npz))[0]
    assert source == entry["instance"]
    assert (mine.z, mine.block_rows, mine.block_cols, mine.name) == \
        (theirs.z, theirs.block_rows, theirs.block_cols, theirs.name)
    assert _shifts(mine) == _shifts(theirs)
    # the other spellings of the same code
    assert _shifts(studies.resolve_code(str(studies.CHAIN / entry["file"]))
                   [0]) == _shifts(theirs)
    assert _shifts(studies.resolve_code(str(npz))[0]) == _shifts(theirs)


def test_carry_chain_regenerates_the_committed_files(monkeypatch, tmp_path):
    monkeypatch.chdir(ROOT)
    index = studies.carry_chain("docs/chain_scoreboard.json",
                                tmp_path / "chain")
    assert list(index["codes"]) == CHAIN_NAMES
    for f in sorted(studies.CHAIN.iterdir()):
        assert (tmp_path / "chain" / f.name).read_bytes() == f.read_bytes()
    s47 = index["codes"]["s47"]["waterfall"]
    assert s47["artifact"] == "docs/discovered_code.json"
    assert s47["provenance"]["train_reward"] == \
        _doc("discovered_code.json")["train_reward"]


# --- chain_scoreboard ----------------------------------------------------

def test_chain_order_and_penalized_equal_the_jax_artifact():
    art = _doc("chain_scoreboard.json")
    codes = copy.deepcopy(art["codes"])
    for name, c in codes.items():
        c["penalized"] = c["reward_mean"] - art["penalty"] * c["fer_floor"]
        assert c["penalized"] == art["codes"][name]["penalized"]
    shuffled = dict(random.Random(0).sample(list(codes.items()), len(codes)))
    md = (DOCS / "chain_scoreboard.md").read_text().splitlines()
    jax_rows = [r for r in md if r.startswith("| ") and
                not r.startswith("| code")]
    assert [chain_scoreboard.score_row(n, c)
            for n, c in chain_scoreboard.ranked(shuffled)] == jax_rows
    mine = chain_scoreboard.scoreboard_md(
        {**art, "codes": shuffled, "device": "cpu", "kernel_hash": "0" * 64})
    assert mine[:len(md)] == md


def test_chain_scoreboard_cpu_smoke(tmp_path):
    out = chain_scoreboard.main(["--smoke", "--out",
                                 str(tmp_path / "cs")])
    doc = _written(tmp_path / "cs")
    assert list(doc["codes"]) == ["wifi"] and doc["instances"] == {}
    c = doc["codes"]["wifi"]
    assert c["words"] == 32 and c["penalized"] == pytest.approx(
        c["reward_mean"] - 30.0 * c["fer_floor"])
    assert out["codes"] == doc["codes"]
    # a run without --out writes nothing on the CPU
    chain_scoreboard.main(["--smoke"])
    assert not (tmp_path / "data").exists()


def test_chain_scoreboard_takes_carried_names_and_pairs(tmp_path,
                                                        monkeypatch):
    seen = {}

    def fake_score(codes, **kw):
        seen.update(codes)
        return {n: {"reward_mean": 0.8, "reward_std": 0.0, "fer_floor": 0.0,
                    "fer_wilson95": [0.0, 1.0], "frame_errors": 0,
                    "words": 1, "penalized": 0.8, "seconds": 0.0}
                for n in codes}
    monkeypatch.setattr(chain_scoreboard, "score_codes", fake_score)
    path = tmp_path / "m.json"
    save_code_json(_mutated_wifi(), path)
    out = chain_scoreboard.main(["s47", f"mine={path}", "--out",
                                 str(tmp_path / "cs")])
    assert list(seen) == ["near_earth", "s47", "mine"]
    assert out["instances"]["mine"] == str(path)
    assert out["instances"]["s47"].endswith(".npz")
    seen.clear()
    chain_scoreboard.main(["--out", str(tmp_path / "cs2")])
    assert list(seen) == ["near_earth", *CHAIN_NAMES]


# --- discovered_code_waterfall -------------------------------------------

@pytest.mark.parametrize("name", ["discovered_code.json",
                                  "floor_topk_code.json", "boot_code.json",
                                  "floor2_code.json"])
def test_point_verdicts_equal_the_jax_artifact(name):
    art = _doc(name)
    base = next(k for k in art["codes"] if k != "discovered")
    assert discovered_code_waterfall.point_verdicts(
        art["codes"][base], art["codes"]["discovered"], base) == \
        art["per_point_verdicts"]


def test_provenance_from_a_summary_equals_the_jax_artifact():
    path = "docs/experiments/search_floor2/summary.json"
    prov = discovered_code_waterfall.provenance_from(
        json.loads((ROOT / path).read_text()), path)
    want = dict(_doc("floor2_code.json")["provenance"])
    want.pop("instance")
    assert prov == want


def test_discovered_code_waterfall_cpu_smoke(tmp_path):
    code = _mutated_wifi()
    save_code_json(code, tmp_path / "code.json")
    out = discovered_code_waterfall.main([
        "--instance", str(tmp_path / "code.json"), "--baseline", "wifi",
        "--words", "8", "--iters", "6", "--snrs", "1.5", "4.0",
        "--save-dir", str(tmp_path / "inst"), "--out",
        str(tmp_path / "w")])
    doc = _written(tmp_path / "w")
    assert doc["blocks_changed"] == [[0, 0]]
    assert list(doc["codes"]) == ["wifi", "discovered"]
    assert [v["snr_db"] for v in doc["per_point_verdicts"]] == [1.5, 4.0]
    assert (tmp_path / "inst" / f"{doc['code_instance']}.npz").exists()
    assert doc["code_instance"] == \
        discovered_code_waterfall.instance_name(code)
    assert out["provenance"]["instance"] == str(tmp_path / "code.json")


def test_discovered_code_waterfall_default_is_the_carried_s47(monkeypatch,
                                                              tmp_path):
    calls = []

    def fake_sweep(code, snrs, words, iters, engine, seed, dev):
        calls.append((code.name, words, iters, engine))
        pts = [{"snr_db": s, "ber": 0.0, "ber_ci95_half": 0.0, "fer": 0.0,
                "fer_wilson95": [0.0, 1.0], "avg_iters": 1.0} for s in snrs]
        return pts, 0.0, None
    monkeypatch.setattr(discovered_code_waterfall, "sweep", fake_sweep)
    out = discovered_code_waterfall.main(["--out", str(tmp_path / "w")])
    art = _doc("discovered_code.json")
    assert out["blocks_changed"] == art["blocks_changed"]
    assert out["code_instance"] == art["code_instance"]
    assert out["train_reward"] == art["train_reward"]
    assert out["reeval_reward"] == art["reeval_reward"]
    assert out["provenance"]["steps_tsv"] == studies.DEFAULT_STEPS_TSV
    assert calls[0][1:] == (16384, 50, "cuda")


# --- floor_topk_select and floor_search_analysis -------------------------

def test_floor_topk_ranking_equals_the_jax_artifact():
    art = _doc("rl_search_floor_topk.json")
    cands = art["candidates"]
    topk_rows = [{"rank_train": c["rank"], "train_reward":
                  c["train_reward"], "epoch": c["epoch"],
                  "observation_hex": c["observation_hex"],
                  "reward_mean": c["reward_mean"],
                  "reward_std": c["reward_std"],
                  "floors": [{"snr_db": 3.8, "penalty": 30.0,
                              "fer": c["fer_floor"],
                              "fer_wilson95": c["fer_wilson95"]}],
                  "penalized": c["penalized"]} for c in cands]
    random.Random(1).shuffle(topk_rows)
    assert floor_topk_select.candidate_rows(topk_rows) == cands


def test_floor_topk_select_cpu_smoke(monkeypatch, tmp_path):
    codes = [_mutated_wifi((0, b), 3 + b) for b in range(4)] + [wifi_code()]
    tsv = _steps_tsv(tmp_path / "steps.tsv", codes,
                     [0.9, 0.95, 0.8, 0.85, -2.0])
    w = wifi_code()
    monkeypatch.setattr(floor_topk_select, "SHAPE",
                        (w.block_rows, w.block_cols, w.z))
    monkeypatch.setattr(floor_topk_select, "ITERS", 6)
    out = floor_topk_select.main([
        "--steps-tsv", tsv, "--topk", "2",
        "--reeval-tx", "2", "--reeval-seeds", "21", "--floor-words", "4",
        "--snr", "2.0", "3.0", "--floor-snr", "3.0",
        "--out", str(tmp_path / "t")])
    doc = _written(tmp_path / "t")
    assert [c["train_reward"] for c in sorted(
        doc["candidates"], key=lambda c: c["rank"])] == [0.95, 0.9]
    assert set(doc["candidates"][0]) == set(
        _doc("rl_search_floor_topk.json")["candidates"][0])
    pen = [c["penalized"] for c in doc["candidates"]]
    assert pen == sorted(pen, reverse=True)
    assert out["best_instance"].startswith("81_4_24_")


def test_floor_search_analysis_cpu_smoke(monkeypatch, tmp_path):
    codes = [near_earth_code()] + [studies.resolve_code(n)[0]
                                   for n in ("s47", "floor2")]
    tsv = _steps_tsv(tmp_path / "steps.tsv", codes * 2,
                     [0.80, 0.82, 0.79, 0.81, 0.83, 0.78])
    monkeypatch.setattr(floor_search_analysis, "ITERS", 2)
    out = floor_search_analysis.main([
        "--steps-tsv", tsv, "--reeval-tx", "1", "--reeval-seeds", "11",
        "--snr", "3.0", "3.8", "--floor-words", "2",
        "--out", str(tmp_path / "a")])
    doc = _written(tmp_path / "a")
    assert list(doc["codes"]) == ["near_earth", "s47", "boot_s52",
                                  "floor_best"]
    assert doc["epochs"] == 2 and doc["train_best_penalized_reward"] == 0.83
    assert doc["code_instance"] == \
        discovered_code_waterfall.instance_name(codes[1])
    assert doc["heatmaps"]["i"][1] == 2
    assert out["windows"] == doc["windows"]


# --- rl_search_wide ------------------------------------------------------

FLOOR_CASES = [([30.0], [-1]), ([30.0], [3, 4]), ([30.0, 60.0], [-1]),
               ([30.0, 60.0], [3, 4]), ([30.0, 60.0, 10.0], [3, 4]),
               ([30.0], [5]), ([30.0], [-6]), ([0.0], [-1]),
               ([30.0, 0.0], [3, -2])]


@pytest.mark.parametrize("pens,idxs", FLOOR_CASES)
def test_floor_terms_broadcast_and_raise_as_the_env(pens, idxs):
    snrs = (3.0, 3.2, 3.4, 3.6, 3.8)
    try:
        env = LdpcCodeSearchEnv(code=wifi_code(), snr_points=snrs,
                                floor_penalty=pens, floor_snr_index=idxs,
                                num_transmissions=2, dmax_cn_cap=24,
                                dmax_vn_cap=8, device="cpu")
    except ValueError as exc:
        with pytest.raises(ValueError) as mine:
            rl_search_wide.floor_terms(pens, idxs, snrs)
        assert str(mine.value) == str(exc)
        return
    got = rl_search_wide.floor_terms(pens, idxs, snrs)
    keep = env.floor_penalties != 0
    assert got == (env.floor_penalties[keep].tolist(),
                   [snrs[i] for i in env.floor_snr_indices[keep]])


def test_rl_search_wide_cpu_smoke_and_select_only(tmp_path):
    data = str(tmp_path / "exp")
    out = rl_search_wide.main(["--smoke", "--topk", "2", "--data-dir", data,
                               "--out", str(tmp_path / "r")])
    doc = _written(tmp_path / "r")
    sel = doc["selection"]
    assert sel["method"] == "topk_reevaluated" and sel["floor_snrs"] == []
    assert 1 <= len(sel["candidates"]) <= 2
    assert doc["epochs"] == 2 and doc["start_code"]["code"] == "wifi"
    run = tmp_path / "exp" / "search_wide"
    assert json.loads((run / "summary.json").read_text())["best_found"] == \
        doc["best_found"]
    assert (run / f"{sel['best_instance']}.npz").exists()
    assert out["best_found"]["penalized"] == sel["candidates"][0][
        "penalized"]
    again = rl_search_wide.main(["--smoke", "--select-only", "--topk", "2",
                                 "--data-dir", data, "--out",
                                 str(tmp_path / "r2")])
    assert again["selection"]["candidates"] == sel["candidates"]
    assert again["train_seconds"] == pytest.approx(
        rl_search_wide._train_seconds(sel["steps_tsv"]))


# --- rollout_throughput --------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 511), (4, 24, 81)])
def test_random_actions_equal_the_jax_script(shape):
    jax_rt = _jax_script("rollout_throughput")
    rows, cols, z = shape
    envs = [types.SimpleNamespace(
        state=types.SimpleNamespace(block_rows=rows, block_cols=cols), z=z,
        x_bits=max(1, (rows - 1).bit_length()),
        y_bits=max(1, (cols - 1).bit_length())) for _ in range(3)]
    rng_a, rng_b = np.random.RandomState(97), np.random.RandomState(97)
    for _ in range(4):
        mine = rollout_throughput.random_actions(envs, rng_a)
        theirs = jax_rt.random_actions(envs, rng_b)
        assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))


def test_rollout_throughput_cpu_smoke(tmp_path):
    out = rollout_throughput.main(["--steps", "1", "--warm", "1", "--envs",
                                   "1", "2", "--tx", "2", "--code", "wifi",
                                   "--out", str(tmp_path / "t")])
    doc = _written(tmp_path / "t")
    assert [(r["envs"], r["mode"]) for r in doc["rows"]] == [
        (1, "sequential"), (2, "sequential"), (2, "fused")]
    for r in out["rows"]:
        assert 0 <= r["legal_fraction"] <= 1 and r["env_steps_per_s"] > 0
    assert doc["single_env_steps_per_s"] == doc["rows"][0]["env_steps_per_s"]


# --- staging_grid --------------------------------------------------------

def _jax_configs(b):
    """The JAX script's grid, read from its source (``configs = [...]``)
    and evaluated at batch ``b``."""
    tree = ast.parse((ROOT / "scripts" / "staging_grid.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "configs")
    return eval(compile(ast.Expression(node.value), "staging_grid", "eval"),
                {"b": b})


def _jax_round_cap(c, b):
    """The JAX cascade's capacity of an explicit value on the pallas engine
    (``ldpc_tpu/sim/evaluate.py`` ``round_cap``: up to the 128-word tile,
    at most B)."""
    return min(max(128, -(-c // 128) * 128), b)


def test_staging_grid_configs_and_capacities_equal_the_jax_list():
    b = 32768
    assert staging_grid.configs(b) == _jax_configs(b)
    code = near_earth_code()
    for phases, caps in staging_grid.configs(b):
        dec = StagedDecoder(code, 50, phase1_iters=list(phases),
                            redo_capacity=list(caps), engine="cuda",
                            device="cpu")
        assert dec.capacities(b) == [_jax_round_cap(c, b) for c in caps]


def test_staging_grid_cascades_are_word_exact_at_a_tiny_batch(tmp_path):
    out = staging_grid.main(["--code", "wifi", "--batch", "16", "--snr",
                             "1.5", "--trials", "1", "--max-iters", "20",
                             "--out", str(tmp_path / "g")])
    doc = _written(tmp_path / "g")
    assert [(r["phases"], r["caps"]) for r in doc["configs"]] == [
        (list(p), list(c)) for p, c in staging_grid.configs(16)]
    assert doc["all_exact"] and out["all_exact"]
    for r in doc["configs"]:
        assert r["words_checked"] == 32 and r["mismatched_words"] == 0
        assert len(r["times_ms"]) == 1 and len(r["branches"]) == 2
    # at 1.5 dB most 802.11n words fail every stage: "many" is taken
    assert any("many" in b for r in doc["configs"] for b in r["branches"])


# --- reward_investigation ------------------------------------------------

def test_reward_investigation_cpu_smoke(monkeypatch, tmp_path):
    for name, value in [("SEEDS", 2), ("TX", (2, 4)), ("FIT_WORDS", 4),
                        ("MAX_ITERS", 5)]:
        monkeypatch.setattr(reward_investigation, name, value)
    out = reward_investigation.main(["--out", str(tmp_path / "r")])
    doc = _written(tmp_path / "r")
    assert set(doc) >= set(_doc("reward_investigation.json"))
    assert list(doc["mc_noise"]) == ["2", "4"]
    assert len(doc["mc_noise"]["2"]["rewards"]) == 2
    assert doc["fit"]["points"] == 12
    assert doc["degenerate"] == _doc("reward_investigation.json")[
        "degenerate"]
    assert out["near_earth_baselines"]["reference_3p0_3p8"] == \
        rl_search_wide.WIDE_BASELINE


def test_near_earth_baselines_as_the_jax_script_computes_them():
    """The JAX script's section 4 on the port's ber_parity artifact (its
    ``xla_f32`` engine is the port's ``torch_f32``)."""
    from ldpc_tpu.sim.reward import calc_reward as jax_calc_reward
    parity = json.loads((studies.CHAIN.parent / "ber_parity.json")
                        .read_text())
    snrs, bers = [], []
    for pt in parity["points"].values():
        snrs.append(pt["realized_snr_db"])
        bers.append(pt["torch_f32"]["ber"])
    order = np.argsort(snrs)
    snrs, bers = np.asarray(snrs)[order], np.asarray(bers)[order]
    mine = reward_investigation.near_earth_baselines(parity)
    assert mine["reward_3p0_3p8"] == pytest.approx(
        jax_calc_reward(snrs, bers, [3.0, 3.8]), rel=1e-12)
    assert mine["reward_3p0_3p4"] == pytest.approx(
        jax_calc_reward(snrs, bers, [3.0, 3.4]), rel=1e-12)


# --- reward_floor_frontier and chain_figure ------------------------------

@pytest.mark.parametrize("path", [
    "rl_search_floor_topk.json", "experiments/search_floor2/summary.json",
    "experiments/search_floor2_late/summary.json"])
def test_frontier_candidates_equal_the_jax_script(path):
    jax_rf = _jax_script("reward_floor_frontier")
    assert list(reward_floor_frontier.candidates(str(DOCS / path))) == \
        list(jax_rf._candidates(str(DOCS / path)))


def test_reward_floor_frontier_and_chain_figure_cpu(tmp_path):
    sels = [str(DOCS / "rl_search_floor_topk.json"),
            str(DOCS / "experiments/search_floor2/summary.json")]
    out = reward_floor_frontier.main([
        "--selections", *sels, str(tmp_path / "missing.json"),
        "--scoreboard", str(DOCS / "chain_scoreboard.json"),
        "--out", str(tmp_path / "f")])
    doc = _written(tmp_path / "f")
    assert list(doc["selections"]) == sels
    assert [c[0] for c in doc["chain"]] == list(_doc(
        "chain_scoreboard.json")["codes"])
    pts = [(p[0], p[1]) for v in out["selections"].values() for p in v] + \
        [(c[1], c[2]) for c in out["chain"]]
    for r, f in doc["frontier"]:
        assert not any(r2 > r and f2 <= f for r2, f2 in pts)
    assert (doc["figure"] is None) == (not studies.can_draw())
    fig = chain_figure.main(["--series",
                             str(DOCS / "discovered_code.json"),
                             str(DOCS / "boot_code.json") + ":discovered:boot",
                             "--out", str(tmp_path / "c")])
    doc = _written(tmp_path / "c")
    assert [s["label"] for s in doc["series"]] == [
        "discovered_code: near_earth", "discovered_code: discovered",
        "boot"]
    art = _doc("discovered_code.json")["codes"]["discovered"]
    assert fig["series"][1]["fer"] == [max(p["fer"], 1e-9) for p in art]
