"""Process groups, device meshes and shardings: the port of
``ldpc_tpu.parallel.mesh``.

The JAX package shards over the devices of one process; the port shards
over the ranks of a ``torch.distributed`` process group, one process a
rank.  On the card the group is NCCL (one rank a card, or one rank alone);
on the CPU it is gloo.  Gloo also runs several ranks on ONE card (each
process decoding on ``cuda:0``), which NCCL refuses; gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only, so every collective of
``parallel/`` and of the sharded entry points is an ``all_reduce``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks:
1-D (``data``) by default, 2-D (``dcn``, ``ici``) for the hierarchical
layout, whose batch axis shards dcn-major, as in the JAX package.  Its
device type follows the group's backend ("cuda" for NCCL, else "cpu"):
the device a rank decodes on is the sharded function's ``device``.

Everything degrades to one rank: ``make_mesh`` on a process without a
group creates a one-rank group (the reference's ``num_procs()==1`` no-op
paths, mpi_pytorch.py:22-26).
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import resolve_device

__all__ = ["initialize_distributed", "make_mesh", "make_hierarchical_mesh",
           "data_sharding", "replicated_sharding", "process_batch_slice",
           "spawn_module_ranks", "DATA_AXIS", "DCN_AXIS", "ICI_AXIS"]

DATA_AXIS = "data"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"
TIMEOUT_S = 300.0       # every collective of a group, its set-up included


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_module_ranks(module: str,
                       argv_of_rank: Callable[[int, int, str], list[str]],
                       n: int, timeout_s: float, *,
                       one_thread: bool = False) -> list[dict | None]:
    """Run ``python -m module *argv_of_rank(rank, port, report)`` for ranks
    0 .. n-1 from the repository's root, every rank given one free local
    ``port`` and its own ``report`` path; wait for all of them (at most
    ``timeout_s`` together) and return the JSON each rank wrote to its
    ``report``, rank 0 first (None where a rank wrote none).

    A rank that exits nonzero raises ``RuntimeError`` with the end of its
    stderr; every process is stopped either way.  ``one_thread`` sets
    ``OMP_NUM_THREADS=1`` in the ranks unless it is set already."""
    root = pathlib.Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    if one_thread:
        env.setdefault("OMP_NUM_THREADS", "1")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        reports = [pathlib.Path(tmp) / f"rank{r}.json" for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module,
             *argv_of_rank(r, port, str(reports[r]))], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        failed = []
        deadline = time.monotonic() + timeout_s
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                if p.returncode != 0:
                    failed.append(f"rank {r} exited {p.returncode}:\n"
                                  f"{err[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError(f"{module} ranks failed:\n" +
                               "\n".join(failed))
        return [json.loads(f.read_text()) if f.exists() else None
                for f in reports]


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device=None, backend: str | None = None,
                           timeout_s: float = TIMEOUT_S) -> None:
    """Join this process to a group of ``num_processes`` ranks at
    ``coordinator_address`` ("host:port", or a ``tcp://`` URL), as rank
    ``process_id``.

    A no-op when a group already exists, and on a one-process run without
    a coordinator (``LDPC_TPU_DISTRIBUTED=1`` instead reads the group from
    the environment, ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE``, as a launcher such as ``torchrun`` sets them).  The
    backend is NCCL when the rank decodes on the card (``device`` None or
    CUDA; the rank then takes card ``process_id`` modulo the cards), gloo
    when ``device="cpu"``; ``backend="gloo"`` with the card puts several
    ranks on one card.  Every collective waits at most ``timeout_s``.
    Reference equivalent: ``mpi_fork`` + mpi4py COMM_WORLD
    (mpi_tools.py:6-64), without the re-exec.
    """
    if dist.is_initialized():
        return
    from_env = os.environ.get("LDPC_TPU_DISTRIBUTED") == "1"
    if coordinator_address is None and (num_processes or 1) == 1 \
            and not from_env:
        return
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes or 1),
                                rank=int(process_id or 0), timeout=timeout)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _ensure_group(device) -> None:
    """A one-rank group on a free local port when the process has none."""
    if not dist.is_initialized():
        initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                               device=device)


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _ranks(devices) -> np.ndarray:
    return np.asarray(list(devices) if devices is not None
                      else range(dist.get_world_size()), np.int64)


def make_mesh(devices=None, axis_name: str = DATA_AXIS, *,
              device=None) -> DeviceMesh:
    """A 1-D mesh over the given ranks (default: every rank of the group).

    Monte-Carlo decode, BER reduction and PPO gradient sync are all
    data-parallel, so one flat axis is the right default; the batch axis
    is sharded over it.  Without a group, one is created with this process
    as its only rank, on ``device`` (default: the card)."""
    _ensure_group(device)
    return DeviceMesh(_mesh_device_type(), torch.as_tensor(_ranks(devices)),
                      mesh_dim_names=(axis_name,))


def make_hierarchical_mesh(dcn: int | None = None, ici: int | None = None,
                           devices=None, *, device=None) -> DeviceMesh:
    """A 2-D (dcn, ici) mesh for multi-host runs.

    ``dcn`` counts hosts (the data-center network axis), ``ici`` ranks a
    host.  Either may be omitted and is inferred from the rank count; with
    neither, ``dcn`` is the number of processes, as the JAX package's
    ``process_count()`` (every rank here is a process, so ``ici`` is 1).
    The batch axis shards over both, dcn-major, so one host holds a
    contiguous batch range and a reduction sums within a host before it
    crosses hosts."""
    _ensure_group(device)
    ranks = _ranks(devices)
    total = ranks.size
    if dcn is None and ici is None:
        dcn = max(1, dist.get_world_size())
    if dcn is None:
        dcn = total // ici
    if ici is None:
        ici = total // dcn
    if dcn * ici != total:
        raise ValueError(f"dcn*ici = {dcn}*{ici} != {total} ranks")
    return DeviceMesh(_mesh_device_type(),
                      torch.as_tensor(ranks.reshape(dcn, ici)),
                      mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def data_sharding(mesh: DeviceMesh, axis_name: str = DATA_AXIS,
                  rank: int = 2) -> tuple:
    """DTensor placements that shard the leading (batch) axis over
    ``axis_name`` and replicate the rest; on a mesh without that axis
    (the hierarchical one) the batch shards over every axis, dcn-major.
    ``rank`` (the array's rank, for the JAX signature) changes nothing: a
    placement names only the sharded dimension."""
    names = mesh.mesh_dim_names or ()
    if axis_name in names:
        return tuple(Shard(0) if n == axis_name else Replicate()
                     for n in names)
    return (Shard(0),) * mesh.ndim


def replicated_sharding(mesh: DeviceMesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def _slice(total: int, i: int, n: int) -> tuple[int, int]:
    """(start, size) of part ``i`` of ``n`` contiguous parts of ``total``
    rows: the first ``total % n`` parts take one row more."""
    per, extra = divmod(total, n)
    return i * per + min(i, extra), per + (1 if i < extra else 0)


def process_batch_slice(total_batch: int) -> tuple[int, int]:
    """(start, size) of this process's slice of a global batch (cf. the
    reference splitting transmissions across GPUs, ldpcCUDA.py:898-900)."""
    if not dist.is_initialized():
        return 0, total_batch
    return _slice(total_batch, dist.get_rank(), dist.get_world_size())


def mesh_rows(mesh: DeviceMesh, total: int, axes=None) -> slice:
    """This rank's contiguous rows of a ``total``-row batch sharded over
    the ``axes`` of ``mesh`` (default: all, dcn-major)."""
    start, size = _slice(total, *mesh_position(mesh, axes))
    return slice(start, start + size)


def mesh_position(mesh: DeviceMesh, axes=None) -> tuple[int, int]:
    """(index, count) of this rank among the ``axes`` of ``mesh`` (default:
    all of them), flattened in the mesh's order (dcn-major)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    names = list(mesh.mesh_dim_names or ())
    dims = (range(mesh.ndim) if axes is None
            else [names.index(a) for a in axes])
    shape = [mesh.shape[d] for d in dims]
    return (int(np.ravel_multi_index([coord[d] for d in dims], shape)),
            int(np.prod(shape)))


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh, axes=None
                   ) -> torch.Tensor:
    """Sum ``t`` in place over the ``axes`` of ``mesh`` (default: all),
    one ``all_reduce`` an axis; returns ``t``."""
    names = list(mesh.mesh_dim_names or ())
    dims = range(mesh.ndim) if axes is None else [names.index(a)
                                                  for a in axes]
    for d in dims:
        dist.all_reduce(t, group=mesh.get_group(d))
    return t
