"""What the validation studies (``ber_parity``, ``random_codeword_check``,
``error_floor``, ``wifi_waterfall``, ``sort_ab``) share: the device they
run on, the stamp every artifact carries, and where the artifacts go.

Each study writes ``<base>.json`` and ``<base>.md``: ``base`` is ``--out``
when given, else ``ldpc_tpu_torch/data/<name>`` on the card.  A CPU run
(``LDPC_TPU_PLATFORM=cpu``) writes only to an explicit ``--out``, so a smoke
run never overwrites an artifact measured on the card.
"""

from __future__ import annotations

import json
import pathlib

import torch

from ..cli import _device
from ..utils.device import resolve_device
from ..utils.profiling import smi_query
from ..utils.provenance import kernel_source_hash

__all__ = ["DATA", "study_device", "stamp", "sync", "artifact_base",
           "write_artifact"]

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


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
