"""What the studies and the code-search scripts of this package share: the
device they run on, the stamp every artifact carries, where the artifacts
go, the carried discovery chain and the keywords that put a sweep on the
fused kernel.

Each study writes ``<base>.json`` and ``<base>.md``: ``base`` is ``--out``
when given, else ``ldpc_tpu_torch/data/<name>`` on the card.  A CPU run
(``LDPC_TPU_PLATFORM=cpu``) writes only to an explicit ``--out``, so a smoke
run never overwrites an artifact measured on the card.

The discovery chain (``data/chain/``): the codes the JAX package's searches
found, each a ``code_to_dict`` JSON converted once from its ``.npz``
instance under ``docs/experiments/`` (which never reaches the card), and
``index.json``, naming each file's source, the source's SHA-256 and the
provenance its waterfall artifact recorded.  Regenerate it from a checkout
that has ``docs/``::

    python -m ldpc_tpu_torch.scripts.studies --carry-chain \
        docs/chain_scoreboard.json

A script that takes a code accepts a carried name (``s47``), a carried or
any other JSON code file, a ``.npz``/``.mat`` instance, or ``near-earth`` /
``wifi``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pathlib

import torch

from ..cli import _device
from ..codes import (QCCode, code_from_dict, code_to_dict, load_code_instance,
                     load_code_json, near_earth_code, wifi_code)
from ..utils.device import resolve_device
from ..utils.profiling import smi_query
from ..utils.provenance import kernel_source_hash

__all__ = ["DATA", "CHAIN", "study_device", "stamp", "sync", "artifact_base",
           "write_artifact", "chain_index", "resolve_code", "carry_chain",
           "sweep_kw", "fer_point", "can_draw"]

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
CHAIN = DATA / "chain"
# the JAX package's waterfall artifacts, each of one chain member
WATERFALLS = ("docs/discovered_code.json", "docs/boot_code.json",
              "docs/floor_topk_code.json", "docs/floor2_code.json")
# where discovered_code_waterfall took its code when the artifact predates
# its provenance block: the JAX script's default search log
DEFAULT_STEPS_TSV = "docs/experiments/search_wide/search_wide_s47/steps.tsv"
NAMED = {"near-earth": near_earth_code, "wifi": wifi_code}


def study_device() -> torch.device:
    """The card, or the CPU under ``LDPC_TPU_PLATFORM=cpu``."""
    return resolve_device(_device())


def stamp(dev: torch.device) -> dict:
    """The port's decode-path hash and the device: on the card its name
    and power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives
    them."""
    kind = (", ".join(smi_query("name", "power.limit"))
            if dev.type == "cuda" else "cpu")
    return {"kernel_hash": kernel_source_hash(), "device": kind}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def artifact_base(name: str, out: str | None,
                  dev: torch.device) -> pathlib.Path | None:
    """Where the study writes (see the module docstring); None: nowhere."""
    if out:
        return pathlib.Path(out)
    return DATA / name if dev.type == "cuda" else None


def write_artifact(base: pathlib.Path | None, doc: dict,
                   md: list[str]) -> None:
    """``base``.json (indented) and ``base``.md, unless ``base`` is None."""
    if base is None:
        print("CPU run without --out: not writing the artifact", flush=True)
        return
    base.parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(f"{base}.json").write_text(json.dumps(doc, indent=1) + "\n")
    pathlib.Path(f"{base}.md").write_text("\n".join(md) + "\n")
    print(f"wrote {base}.json / .md", flush=True)


def can_draw(*extra: str) -> bool:
    """Whether figures can be drawn: matplotlib and the ``extra`` modules
    are installed (the card's machine has no matplotlib: there the scripts
    compute the arrays and draw nothing)."""
    return all(importlib.util.find_spec(m) is not None
               for m in ("matplotlib", *extra))


def chain_index() -> dict:
    """``data/chain/index.json``: name -> file, source instance, SHA-256,
    provenance."""
    return json.loads((CHAIN / "index.json").read_text())


def resolve_code(spec: str) -> tuple[QCCode, str]:
    """(code, source) of a carried name, a named code, a JSON code file or a
    ``.npz``/``.mat`` instance; ``source`` is the instance a carried code
    was converted from, else ``spec``."""
    if spec in NAMED:
        return NAMED[spec](), spec
    entry = chain_index()["codes"].get(spec)
    if entry is not None:
        doc = json.loads((CHAIN / entry["file"]).read_text())
        return code_from_dict(doc), entry["instance"]
    if spec.endswith(".json"):
        return load_code_json(spec), spec
    return load_code_instance(spec)[0], spec


def _repo_path(path: str) -> str:
    """A recorded path from ``docs/`` on, however the recording machine
    spelled the checkout's root."""
    i = path.find("docs/")
    return path[i:] if i >= 0 else path


def carry_chain(scoreboard: str = "docs/chain_scoreboard.json",
                out: pathlib.Path = CHAIN) -> dict:
    """Convert each chain member of a JAX scoreboard artifact
    (``"instances"``: name -> ``.npz``) to ``<out>/<name>.json`` with the
    port's ``load_code_instance``, and write ``<out>/index.json``.  Paths
    are read from the working directory, the root of a checkout with
    ``docs/``."""
    instances = json.loads(pathlib.Path(scoreboard).read_text())["instances"]
    waterfalls = {}
    for path in WATERFALLS:
        if pathlib.Path(path).exists():
            doc = json.loads(pathlib.Path(path).read_text())
            waterfalls[doc["code_instance"]] = (path, doc)
    out.mkdir(parents=True, exist_ok=True)
    index = {"scoreboard": scoreboard, "codes": {}}
    for name, npz in instances.items():
        code = load_code_instance(npz)[0]
        (out / f"{name}.json").write_text(json.dumps(code_to_dict(code)) +
                                          "\n")
        entry = {"file": f"{name}.json", "instance": npz,
                 "sha256": hashlib.sha256(
                     pathlib.Path(npz).read_bytes()).hexdigest()}
        stem = pathlib.Path(npz).stem
        if stem in waterfalls:
            path, doc = waterfalls[stem]
            prov = dict(doc.get("provenance") or {
                "steps_tsv": _repo_path(doc.get("steps_tsv",
                                                DEFAULT_STEPS_TSV)),
                "selection_method": "argmax_train_reward"})
            prov.setdefault("train_reward", doc["train_reward"])
            entry["waterfall"] = {
                "artifact": path, "provenance": prov,
                "reeval_reward": doc.get("reeval_reward")}
        index["codes"][name] = entry
    (out / "index.json").write_text(json.dumps(index, indent=1) + "\n")
    return index


def sweep_kw(dev: torch.device, words: int | None = None,
             max_iters: int = 50) -> dict:
    """``evaluate_code`` keywords that decode through the fused kernel
    (``engine="cuda"``, bf16 state; on the CPU its plain version): with
    ``words``, the JAX scripts' floor sweep (batches of up to 16,384,
    staged 12 -> ``max_iters`` where ``max_iters`` > 12), else one straight
    decode a batch."""
    kw = {"engine": "cuda", "device": dev}
    if words is not None:
        kw.update(batch_size=min(16384, words), staged=max_iters > 12)
    return kw


def fer_point(stats, snr: float) -> dict:
    """FER, its Wilson 95% interval, the frame errors and the words of one
    point of a ``BerStatistics``."""
    from ..sim.stats import wilson_interval
    sel = stats.column("snr") == snr
    fe = int(stats.column("frame_errors")[sel].sum())
    words = int(stats.column("weight")[sel].sum())
    fer, lo, hi = wilson_interval(fe, words)
    return {"fer": fer, "fer_wilson95": [lo, hi], "frame_errors": fe,
            "words": words}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="regenerate data/chain/")
    ap.add_argument("--carry-chain", metavar="SCOREBOARD_JSON",
                    default="docs/chain_scoreboard.json")
    a = ap.parse_args()
    idx = carry_chain(a.carry_chain)
    print(f"wrote {len(idx['codes'])} codes and index.json to {CHAIN}")
