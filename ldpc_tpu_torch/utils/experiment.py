"""Experiment management: output-dir conventions + hyperparameter grids (the
port of ``ldpc_tpu.utils.experiment``).

Covers the reference's ``run_utils.py`` / ``user_config.py`` capabilities
(SURVEY.md §2 L5): ``setup_logger_kwargs`` output-dir convention
(``data_dir/exp_name/exp_name_s<seed>``, run_utils.py:27-89) and the
``ExperimentGrid`` cartesian sweep with shorthand-named variants
(run_utils.py:242-559).  Experiments run in-process (one card, one
process — the reference forked subprocesses per variant because of MPI;
here there is nothing to fork).
"""

from __future__ import annotations

import itertools
import os
import tempfile
import time

__all__ = ["DEFAULT_DATA_DIR", "setup_logger_kwargs", "ExperimentGrid"]

DEFAULT_DATA_DIR = os.environ.get(
    "LDPC_TPU_DATA_DIR", os.path.join(tempfile.gettempdir(),
                                      "ldpc_tpu_experiments"))
FORCE_DATESTAMP = False


def setup_logger_kwargs(exp_name: str, seed: int | None = None,
                        data_dir: str | None = None,
                        datestamp: bool = False) -> dict:
    """Reference-identical naming (run_utils.py:27-89)."""
    datestamp = datestamp or FORCE_DATESTAMP
    ymd = time.strftime("%Y-%m-%d")
    relpath = f"{ymd}_{exp_name}" if datestamp else exp_name
    if seed is not None:
        if datestamp:
            hms = time.strftime("%Y-%m-%d_%H-%M-%S")
            subfolder = f"{hms}-{exp_name}_s{seed}"
        else:
            subfolder = f"{exp_name}_s{seed}"
        relpath = os.path.join(relpath, subfolder)
    data_dir = data_dir or DEFAULT_DATA_DIR
    return dict(output_dir=os.path.join(data_dir, relpath),
                exp_name=exp_name)


def _valid_str(v) -> str:
    if hasattr(v, "__name__"):
        return _valid_str(v.__name__)
    if isinstance(v, (tuple, list)):
        return "-".join(_valid_str(x) for x in v)
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in str(v)).lower()


class ExperimentGrid:
    """Cartesian hyperparameter grid (run_utils.py:242-559 semantics).

    >>> g = ExperimentGrid("sweep")
    >>> g.add("ppo_cfg:seed", [0, 1], in_name=True)
    >>> g.add("ppo_cfg:steps_per_epoch", [32])
    >>> g.run(my_train_fn)
    """

    def __init__(self, name: str = ""):
        self.name = name
        self.keys: list[str] = []
        self.vals: list[list] = []
        self.shs: list[str | None] = []
        self.in_names: list[bool] = []

    def add(self, key: str, vals, shorthand: str | None = None,
            in_name: bool = False):
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if shorthand is None:
            # default shorthand: first 3 significant chars of the last
            # key segment (run_utils.py:297-306)
            base = key.split(":")[-1].split(".")[-1]
            shorthand = "".join(
                [c for c in base if c.isalnum()][:3]) or base[:3]
        self.keys.append(key)
        self.vals.append(list(vals))
        self.shs.append(shorthand)
        self.in_names.append(in_name)
        return self

    def variants(self) -> list[dict]:
        out = []
        for combo in itertools.product(*self.vals):
            out.append(dict(zip(self.keys, combo)))
        return out

    def variant_name(self, variant: dict) -> str:
        parts = [self.name] if self.name else []
        for key, sh, in_name, vals in zip(self.keys, self.shs,
                                          self.in_names, self.vals):
            if in_name or len(vals) > 1:
                v = variant[key]
                if isinstance(v, bool):
                    parts.append(f"{sh}" if v else f"no-{sh}")
                else:
                    parts.append(f"{sh}-{_valid_str(v)}")
        return "_".join(parts) or "experiment"

    def run(self, thunk, data_dir: str | None = None,
            datestamp: bool = False) -> list:
        """Call ``thunk(output_dir=..., exp_name=..., **variant)`` for
        every variant; returns the list of results."""
        results = []
        for variant in self.variants():
            name = self.variant_name(variant)
            seed = variant.get("seed")
            kwargs = setup_logger_kwargs(name, seed, data_dir, datestamp)
            results.append(thunk(**kwargs, **variant))
        return results
