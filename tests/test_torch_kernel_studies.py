"""The kernel studies of ``ldpc_tpu_torch/scripts/`` (``layered_ab``,
``quantized_ber``, ``sched_ab``, ``perturbation_fer``) and ``giant_code``:
each runs on the CPU at a tiny size into ``--out`` (the cuda engine's plain
version, ``ops/dynamic.py``, gloo ranks), and each verdict (``adopt``)
gives the JAX script's verdict on the JAX script's own result dicts: its
committed artifacts and variants of them."""

import copy
import importlib.util
import json
import pathlib

import pytest
import torch

from ldpc_tpu_torch.scripts import (giant_code, layered_ab,
                                    perturbation_fer, quantized_ber,
                                    sched_ab, studies)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def _artifact(name):
    return json.loads((ROOT / "docs" / f"{name}.json").read_text())


def _written(base):
    doc = json.loads(pathlib.Path(f"{base}.json").read_text())
    assert pathlib.Path(f"{base}.md").read_text().startswith("# ")
    assert doc["device"] == "cpu" and len(doc["kernel_hash"]) == 64
    return doc


def test_layered_ab_cpu_smoke(tmp_path):
    out = layered_ab.main(["--code", "wifi", "--batch", "16", "--trials",
                           "1", "--max-iters", "12", "--snr", "3.0,3.4",
                           "--out", str(tmp_path / "layered_ab")])
    doc = _written(tmp_path / "layered_ab")
    assert doc["results"] == out["results"]
    assert list(out["results"]) == ["flooding-p3", "layered-p1",
                                    "layered-p1-3"]
    for r in out["results"].values():
        for p in r.values():
            assert 0 <= p["fer"] <= 1 and p["fer_ci95"][0] <= p["fer"]
    assert not (tmp_path / "data").exists()


def test_layered_ab_verdict_on_the_jax_artifact():
    art = _artifact("layered_ab")
    v = layered_ab.adopt_verdict(art["results"], art["snr_points"],
                                 art["baseline"])
    assert v["adopt"] == art["adopt"] is False
    # the JAX rule: faster at 3.4 dB and within the baseline's upper band
    # at every point; make layered-p6 faster, then push one point out
    res = copy.deepcopy(art["results"])
    res["layered-p6"]["3.4"]["bit_per_s"] = 2e9
    v = layered_ab.adopt_verdict(res, art["snr_points"], art["baseline"])
    assert v["adopt"] and v["recommended"] == "layered-p6"
    res["layered-p6"]["3.0"]["fer"] = \
        res["flooding-p12"]["3.0"]["fer_ci95"][1] + 1e-3
    assert not layered_ab.adopt_verdict(res, art["snr_points"],
                                        art["baseline"])["adopt"]


def test_quantized_ber_cpu_smoke(tmp_path):
    out = quantized_ber.main(["--code", "wifi", "--words", "16",
                              "--max-iters", "16", "--snr", "3.0", "3.4",
                              "--out", str(tmp_path / "q")])
    doc = _written(tmp_path / "q")
    assert list(doc["stores"]) == ["bfloat16", "float32", "int8"]
    assert {"adopt", "ber_within_band",
            "faster_at_operating_point"} <= set(out)
    for pts in doc["stores"].values():
        assert [p["snr_db"] for p in pts] == [3.0, 3.4]
        for p in pts:
            assert len(p["trial_s"]) == quantized_ber.TRIALS
            assert p["decode_s"] == min(p["trial_s"])
            first = p["first_call"]
            assert first["s"] > 0 and first["new_segments"] == 0
            assert len(first["branches"]) == 1
            assert set(first["branches"]) <= {"none", "few", "many"}


def _quantized_cases():
    art = _artifact("quantized_ber")
    base = {"words": art["words"], "stores": art["stores"]}
    faster = copy.deepcopy(base)
    faster["stores"]["int8"][2]["mbit_s"] = 1e4
    inband = copy.deepcopy(faster)
    for pb, pi in zip(inband["stores"]["bfloat16"],
                      inband["stores"]["int8"]):
        pi["fer"], pi["ber"] = pb["fer"], pb["ber"]
    slow = copy.deepcopy(inband)
    slow["stores"]["int8"][2]["mbit_s"] = 1.0
    only_bf16 = {"words": 1024, "stores": {"bfloat16": art["stores"][
        "bfloat16"]}}
    return [base, faster, inband, slow, only_bf16]


@pytest.mark.parametrize("case", range(5))
def test_quantized_ber_verdict_matches_jax(case):
    jax_q = _jax_script("quantized_ber")
    res = _quantized_cases()[case]
    snrs = [3.0, 3.2, 3.4, 3.6]
    want = jax_q.adjudicate(copy.deepcopy(res), snrs, res["words"])
    got = quantized_ber.adjudicate(copy.deepcopy(res), snrs, res["words"])
    for k in ("adopt", "ber_within_band", "faster_at_operating_point",
              "recommended"):
        assert got.get(k) == want.get(k), k
    if case == 0:
        assert got["adopt"] == _artifact("quantized_ber")["adopt"] is False


def test_sched_ab_cpu_smoke(tmp_path):
    out = sched_ab.main(["--code", "wifi", "--batch", "16", "--mi", "4",
                         "--trials", "2", "--out", str(tmp_path / "s")])
    doc = _written(tmp_path / "s")
    assert doc["barrier_probe_exact"] is True
    assert list(doc["entries"]) == [
        f"s{s}_p{p}_bfloat16" for p in (0, 1) for s in (0, 4, 8)]
    assert all(e["exact"] and len(e["nfail"]) == 2
               for e in out["entries"].values())


def _sched_times():
    return [{(0, 128, False): [0.10, 0.11], (4, 128, False): [0.12, 0.12],
             (0, 128, True): [0.105, 0.107]},
            {(0, 128, False): [0.10, 0.11], (8, 128, False): [0.095, 0.2],
             (0, 128, True): [0.099, 0.1]},
            {(0, 128, False): [0.10], (0, 128, True): [0.05]}]


@pytest.mark.parametrize("case", range(3))
def test_sched_ab_verdict_matches_jax(tmp_path, case):
    """The JAX script's write_artifact on synthetic times; the port's
    verdict on its entries (the tile, fixed at 128, out of the key)."""
    import types
    jax_s = _jax_script("sched_ab")
    times = _sched_times()[case]
    variants = list(times)
    args = types.SimpleNamespace(batch=1024, mi=10, snr=3.4, code="wifi",
                                 store="bfloat16", trials=2,
                                 out=str(tmp_path / "jax_sched.json"))
    jax_s.write_artifact(args, variants, times,
                         {v: [1] for v in variants},
                         {v: True for v in variants})
    want = json.loads((tmp_path / "jax_sched.json").read_text())
    entries = {k.replace("_t128", ""): e for k, e in want["entries"].items()}
    got = sched_ab.adopt_verdict(entries)
    assert got["adopt"] == want["adopt"]
    rec = {k: v for k, v in want["recommended"].items() if k != "tile_b"}
    assert got["recommended"] == rec


def test_sched_ab_verdict_on_the_jax_artifact():
    art = _artifact("sched_ab")
    entries = {k.replace("_t128", ""): e for k, e in art["entries"].items()}
    got = sched_ab.adopt_verdict(entries)
    assert got["adopt"] == art["adopt"] is False
    assert got["recommended"] == {k: v for k, v in art["recommended"].items()
                                  if k != "tile_b"}


def test_perturbation_fer_cpu_smoke(tmp_path):
    out = perturbation_fer.main(["--words", "4", "--max-iters", "5",
                                 "--snr", "3.6", "3.8",
                                 "--out", str(tmp_path / "p")])
    doc = _written(tmp_path / "p")
    assert list(doc["variants"]) == list(
        _artifact("perturbation_fer")["variants"])
    assert doc["route"] == "ops/dynamic.py"
    for row in out["variants"].values():
        assert list(row) == ["3.6", "3.8"]
        for p in row.values():
            assert p["frames"] == round(p["fer"] * 4)


def test_perturbation_fer_suite_matches_the_jax_artifact_keys():
    """The port's 33 codes are the JAX artifact's, in its order."""
    from ldpc_tpu_torch.codes import near_earth_code
    from ldpc_tpu_torch.codes.perturb import zeroed_circulant_suite
    names = ["intact"] + [f"zero_{mb}_{nb}" for mb, nb, _ in
                          zeroed_circulant_suite(near_earth_code())]
    assert names == list(_artifact("perturbation_fer")["variants"])


def test_studies_refuse_to_write_from_the_cpu_without_out(tmp_path):
    out = perturbation_fer.main(["--words", "2", "--max-iters", "2",
                                 "--snr", "3.8"])
    assert out["variants"]["intact"]["3.8"]["frames"] in (0, 1, 2)
    assert not (tmp_path / "data").exists()


def test_giant_code_cpu_smoke(tmp_path):
    """Two gloo ranks: the row-sharded decode exact against the unsharded
    decoder, and both layouts that use every rank."""
    out = giant_code.main(["--ranks", "2", "--z-list", "64",
                           "--layouts", "1x2,2x1,1x4", "--crosscheck-z",
                           "32", "--out", str(tmp_path / "g")])
    doc = _written(tmp_path / "g")
    assert doc["crosscheck"] == {"z": 32, "n": 768, "row_ranks": 2,
                                 "words": 4, "exact": True}
    assert [(r["layout"], r["words"]) for r in out["runs"]] == [
        ("1x2", 2), ("2x1", 4)]
    for r in out["runs"]:
        assert r["n"] == 64 * 24 and r["success_rate"] == 1.0


@pytest.mark.parametrize("z,n_row,b", [(2048, 8, 2), (8192, 4, 2),
                                       (512, 2, 3)])
def test_giant_code_state_bytes_match_jax(z, n_row, b):
    from ldpc_tpu_torch.codes import synthetic_qc_code
    jax_g = _jax_script("giant_code")
    code = synthetic_qc_code(z, 8, 24, seed=1)
    d_cn = max(code.row_degrees())
    assert giant_code.state_bytes_per_device(code, n_row, b, d_cn) == \
        jax_g.state_bytes_per_device(code, n_row, b, d_cn)
