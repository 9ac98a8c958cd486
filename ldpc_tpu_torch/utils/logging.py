"""Experiment loggers: TSV row logger + epoch logger (the port's copy of
``ldpc_tpu.utils.logging``).

Covers the reference's three logging systems (SURVEY.md §5):
* ``TsvLogger`` — the key-schema'd TSV logger with a colored console table,
  process-0-gated (``utilityFunctions.py:129-207``); gating uses the rank of
  ``torch.distributed`` when a process group is initialised, instead of MPI
  rank.
* ``EpochLogger`` — the Spinning Up logger (``logx.py:75-396``): config
  JSON dump, tabular ``progress.txt``, stat aggregation with optional
  min/max (``log_tabular(..., with_min_and_max)``).

The reference's joblib/pickle ``save_state`` (logx.py:180-280) is not
here: training state goes to ``utils/checkpoint.py``.
"""

from __future__ import annotations

import json
import pathlib
import tempfile
import time

import numpy as np

__all__ = ["TsvLogger", "EpochLogger", "colorize", "statistics_scalar"]

_COLORS = dict(gray=30, red=31, green=32, yellow=33, blue=34, magenta=35,
               cyan=36, white=37)


def colorize(string: str, color: str = "green", bold: bool = False) -> str:
    """ANSI color wrap (utilityFunctions.colourString:116 / logx.py:29)."""
    attr = [str(_COLORS.get(color, 32))]
    if bold:
        attr.append("1")
    return f"\x1b[{';'.join(attr)}m{string}\x1b[0m"


def _distributed():
    """``torch.distributed`` when a process group is initialised, else
    None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _is_chief() -> bool:
    dist = _distributed()
    return dist is None or dist.get_rank() == 0


def statistics_scalar(x, with_min_and_max: bool = False,
                      distributed: bool = False):
    """Global mean/std(/min/max) of an array across processes — the
    ``mpi_statistics_scalar`` equivalent (mpi_tools.py:73-95).

    With ``distributed=True`` and an initialised ``torch.distributed``
    process group of more than one rank, the five sufficient statistics
    [sum, sumsq, n, min, max] are all-gathered across ranks (one tiny
    collective) and combined, exactly like the
    reference's MPI sum-reductions; single-process runs take the local
    path (the ``num_procs()==1`` no-op, mpi_tools.py:75).  The default is
    LOCAL: a collective is only safe when every process calls with the
    same key sequence, so symmetric callers (the RL epoch loggers) opt in
    explicitly rather than every ad-hoc caller risking a deadlock.
    """
    x = np.asarray(x, np.float64).reshape(-1)
    if x.size == 0:
        x = np.zeros(1, np.float64)
    dist = _distributed() if distributed else None
    if dist is not None and dist.get_world_size() > 1:
        import torch
        local = torch.tensor([x.sum(), (x ** 2).sum(), float(x.size),
                              x.min(), x.max()], dtype=torch.float64)
        if dist.get_backend() == "nccl":
            local = local.cuda()
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        stats = torch.stack(parts).cpu().numpy()
        total_n = stats[:, 2].sum()
        mean = stats[:, 0].sum() / total_n
        # global std from global second moment
        std = float(np.sqrt(max(stats[:, 1].sum() / total_n -
                                mean ** 2, 0.0)))
        if with_min_and_max:
            return (float(mean), std,
                    float(stats[:, 3].min()), float(stats[:, 4].max()))
        return float(mean), std
    mean, std = float(x.mean()), float(x.std())
    if with_min_and_max:
        return mean, std, float(x.min()), float(x.max())
    return mean, std


class TsvLogger:
    """Schema'd row logger (utilityFunctions.logger semantics): declare
    keys up front, log rows as dicts, rows go to a TSV file and a colored
    console line; silent on non-chief processes."""

    def __init__(self, keys, path=None, print_rows: bool = True,
                 append: bool = False):
        self.keys = list(keys)
        self.print_rows = print_rows
        self.active = _is_chief()
        self.path = None
        if path is not None and self.active:
            self.path = pathlib.Path(path)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # append=True continues an existing file (resumed training
            # keeps one contiguous steps.tsv); header only when starting
            # fresh
            if append and self.path.exists() and self.path.stat().st_size:
                header = self.path.read_text().splitlines()[0].split("\t")
                if header != self.keys:
                    raise ValueError(
                        f"cannot append to {self.path}: header {header} "
                        f"!= keys {self.keys}")
            else:
                with open(self.path, "w") as f:
                    f.write("\t".join(self.keys) + "\n")

    def log(self, **row):
        if not self.active:
            return
        vals = [row.get(k, "") for k in self.keys]
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write("\t".join(str(v) for v in vals) + "\n")
        if self.print_rows:
            cells = []
            for k, v in zip(self.keys, vals):
                txt = f"{v:.4g}" if isinstance(v, float) else str(v)
                cells.append(f"{colorize(k, 'cyan')}={txt}")
            print("  ".join(cells))


class EpochLogger:
    """Spinning Up-style epoch logger (logx.py:75-396).

    ``store`` accumulates per-step diagnostics; ``log_tabular`` emits a
    statistic of them (or a bare value); ``dump_tabular`` prints the epoch
    table and appends to progress.txt.
    """

    def __init__(self, output_dir=None, output_fname: str = "progress.txt",
                 exp_name: str | None = None, distributed: bool = True,
                 append: bool = False):
        # distributed=True: log_tabular aggregates across hosts (safe here
        # because the RL loops call log_tabular with identical key
        # sequences on every process — the reference's mpi_statistics_
        # scalar contract, logx.py:311-396).
        # append=True continues an existing progress.txt (resumed
        # training); headers are read back from the file so the column
        # schema stays consistent across the resume boundary.
        self.distributed = distributed
        self.active = _is_chief()
        self.exp_name = exp_name
        self.epoch_dict: dict[str, list] = {}
        self.log_headers: list[str] = []
        self.log_current_row: dict = {}
        self.first_row = True
        self.output_dir = None
        self.output_file = None
        if self.active:
            self.output_dir = pathlib.Path(
                output_dir or pathlib.Path(tempfile.gettempdir()) /
                "experiments" / str(int(time.time())))
            self.output_dir.mkdir(parents=True, exist_ok=True)
            path = self.output_dir / output_fname
            if append and path.exists() and path.stat().st_size:
                self.log_headers = path.read_text().splitlines()[0].split(
                    "\t")
                self.first_row = False
                self.output_file = open(path, "a")
            else:
                self.output_file = open(path, "w")
            print(colorize(f"Logging data to {self.output_file.name}",
                           "green", bold=True))

    def log(self, msg: str, color: str = "green"):
        if self.active:
            print(colorize(msg, color, bold=True))

    def save_config(self, config: dict):
        """JSON config dump (logx.py convert_json + save_config)."""
        if not self.active:
            return

        def default(o):
            return repr(o)

        out = json.dumps(config, indent=4, sort_keys=True, default=default)
        with open(self.output_dir / "config.json", "w") as f:
            f.write(out)

    def store(self, **kwargs):
        for k, v in kwargs.items():
            self.epoch_dict.setdefault(k, []).append(v)

    def log_tabular(self, key, val=None, with_min_and_max: bool = False,
                    average_only: bool = False):
        if val is not None:
            self._set(key, val)
            return
        stored = self.epoch_dict.get(key) or [0.0]
        vals = np.concatenate([np.atleast_1d(np.asarray(v, np.float64))
                               for v in stored])
        stats = statistics_scalar(vals, with_min_and_max=with_min_and_max,
                                  distributed=self.distributed)
        self._set("Average" + key, stats[0])
        if not average_only:
            self._set("Std" + key, stats[1])
        if with_min_and_max:
            self._set("Min" + key, stats[2])
            self._set("Max" + key, stats[3])
        self.epoch_dict[key] = []

    def _set(self, key, val):
        if self.first_row:
            self.log_headers.append(key)
        else:
            assert key in self.log_headers, (
                f"new key {key} introduced after the first epoch")
        assert key not in self.log_current_row, (
            f"value for {key} already set this epoch")
        self.log_current_row[key] = val

    def dump_tabular(self):
        if not self.active:
            self.log_current_row.clear()
            self.first_row = False
            return
        key_lens = [len(k) for k in self.log_headers]
        max_key_len = max(15, max(key_lens, default=15))
        fmt = "| %" + str(max_key_len) + "s | %15s |"
        n_slashes = 22 + max_key_len
        print("-" * n_slashes)
        for key in self.log_headers:
            val = self.log_current_row.get(key, "")
            valstr = f"{val:8.3g}" if hasattr(val, "__float__") else val
            print(fmt % (key, valstr))
        print("-" * n_slashes, flush=True)
        if self.output_file is not None:
            if self.first_row:
                self.output_file.write(
                    "\t".join(self.log_headers) + "\n")
            self.output_file.write("\t".join(
                str(self.log_current_row.get(k, ""))
                for k in self.log_headers) + "\n")
            self.output_file.flush()
        self.log_current_row.clear()
        self.first_row = False

    def drop_epochs_after(self, max_epoch: int):
        """Resume helper: drop progress rows with Epoch > ``max_epoch``.

        A crash BETWEEN checkpoints leaves rows for epochs that will be
        re-run after resume; without truncation the appended log would
        duplicate them (post-mortem tooling assumes one row per epoch).
        No-op when the file has no Epoch column or on non-chief
        processes.
        """
        if not self.active or self.output_file is None:
            return
        path = pathlib.Path(self.output_file.name)
        self.output_file.close()
        lines = path.read_text().splitlines()
        if lines:
            hdr = lines[0].split("\t")
            if "Epoch" in hdr:
                ei = hdr.index("Epoch")
                kept = [lines[0]]
                for ln in lines[1:]:
                    cells = ln.split("\t")
                    try:
                        if float(cells[ei]) > max_epoch:
                            continue
                    except (ValueError, IndexError):
                        pass
                    kept.append(ln)
                lines = kept
        path.write_text("\n".join(lines) + ("\n" if lines else ""))
        self.output_file = open(path, "a")

    def close(self):
        if self.output_file is not None:
            self.output_file.close()
