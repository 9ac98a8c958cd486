"""The kernel microbenchmark's probes: the CUDA kernel ``csrc/microbench.cu``
and its plain PyTorch version.

Port of the probe of ``scripts/kernel_microbench.py`` (``_build_probe`` and
the seven bodies of its ``main()``): a body runs K times on a tile,
written back after each run, then the float32 sum of buffer 0.  The tile is
``x[G, n_bufs, rows, 128]``; G = 1 is the JAX function, G > 1 the same
function on G tiles at once (the card needs many tiles to fill its SMs).

``probe(name, x, n_iters)`` returns ``(sums[G] float32, buffers)``, the
buffers after the last run in ``x``'s shape and dtype.  On a CUDA tensor it
launches the kernel (a failed build or launch raises) and adds one to
``launches[name]``; on a CPU tensor it runs ``probe_reference``, the plain
version with the same bodies as torch ops.  The buffers agree exactly; the
sums only to a tolerance, since the kernel sums in another order.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..utils.device import resolve_device

__all__ = ["NAMES", "PROBES", "OPS_PER_ELEMENT", "SMEM_BYTES_PER_ELEMENT",
           "launches", "probe", "probe_reference", "input_tile",
           "fill_tiles"]

LANES = 128        # columns of a tile
STRIP = 16         # columns a block of the kernel holds
SHIFT = 117        # the probes' rotation
Z, ZP = 511, 512   # the near-earth circulant size and its padded tile

# name: (body index in csrc/microbench.cu, n_bufs, rows, dtype); the names
# and shapes of the JAX script's `probes` list
PROBES = {
    "abs_add_baseline": (0, 1, ZP, torch.float32),
    "baseline+static_roll": (1, 1, ZP, torch.float32),
    "baseline+static_roll_1024": (2, 1, 1024, torch.float32),
    "baseline+mod511_rot": (3, 1, ZP, torch.float32),
    "baseline+f32_to_bf16": (4, 1, ZP, torch.bfloat16),
    "twomin_edge_no_rot": (5, 3, ZP, torch.float32),
    "recon_no_rot": (6, 3, ZP, torch.float32),
}
NAMES = tuple(PROBES)
# float32 operations a body does on one element position (conversions and
# the rotations' index arithmetic not counted, as in chip_smoke.py's OPS):
# abs and add; the fold: multiply, subtract, abs, compare, min, select, min,
# compare, negate, select; the rebuild: compare, select, compare, select,
# multiply, abs, add
OPS_PER_ELEMENT = {"abs_add_baseline": 2, "baseline+static_roll": 2,
                   "baseline+static_roll_1024": 2, "baseline+mod511_rot": 2,
                   "baseline+f32_to_bf16": 2, "twomin_edge_no_rot": 10,
                   "recon_no_rot": 7}

# shared-memory bytes a run must move for one element position: every
# buffer read and every changed buffer written (the rebuild writes m2 and
# am back unchanged, and the compiler drops those stores)
SMEM_BYTES_PER_ELEMENT = {"abs_add_baseline": 8, "baseline+static_roll": 8,
                          "baseline+static_roll_1024": 8,
                          "baseline+mod511_rot": 8,
                          "baseline+f32_to_bf16": 4,
                          "twomin_edge_no_rot": 24, "recon_no_rot": 16}

launches: collections.Counter = collections.Counter()

_SOURCE = "microbench"
_LIB: ctypes.CDLL | None = None
_STEP = 0.1


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ..csrc import load
        lib = load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.microbench_launch.argtypes = [i, p, p, p, p, i, i, p]
        lib.microbench_launch.restype = i
        lib.microbench_occupancy.argtypes = [i, ctypes.POINTER(i)]
        lib.microbench_occupancy.restype = i
        _LIB = lib
    return _LIB


def _spec(name: str):
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}; one of {NAMES}")
    return PROBES[name]


def _check(name: str, x: torch.Tensor, n_iters: int) -> None:
    _, n_bufs, rows, dtype = _spec(name)
    want = (n_bufs, rows, LANES)
    if x.ndim != 4 or tuple(x.shape[1:]) != want or x.shape[0] < 1:
        raise ValueError(f"{name} takes x[G, {n_bufs}, {rows}, {LANES}], got "
                         f"{tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")


def input_tile(n_bufs: int, rows: int, dtype, t: int = 0, tiles: int = 1,
               device=None) -> torch.Tensor:
    """The JAX script's probe input for trial ``t``: ``arange % 7 - 3`` over
    ``[tiles, n_bufs, rows, 128]`` plus ``t`` (``slope_ns`` and ``_time``),
    in ``dtype``.  Tile 0 is the JAX script's tile; the others continue the
    count, so every tile differs."""
    dev = resolve_device(device)
    numel = tiles * n_bufs * rows * LANES
    x = (torch.arange(numel, dtype=torch.int64, device=dev) % 7 - 3 + t)
    return x.to(torch.float32).to(dtype).reshape(tiles, n_bufs, rows, LANES)


def _abs_add(x: torch.Tensor) -> torch.Tensor:
    return x.abs() + _STEP


def _run(name: str, bufs: list[torch.Tensor]) -> list[torch.Tensor]:
    """One run of the body on float32 buffers [G, rows, 128] (bf16 rounding
    included where the probe stores bf16)."""
    if name == "abs_add_baseline":
        return [_abs_add(bufs[0])]
    if name.startswith("baseline+static_roll"):
        return [torch.roll(_abs_add(bufs[0]), SHIFT, dims=-2)]
    if name == "baseline+mod511_rot":
        x = _abs_add(bufs[0])
        a = torch.roll(x, ZP - SHIFT, dims=-2)
        b = torch.roll(x, Z - SHIFT, dims=-2)
        i_row = torch.arange(x.shape[-2], device=x.device).view(-1, 1)
        return [torch.where(i_row < Z - SHIFT, a, b)]
    if name == "baseline+f32_to_bf16":
        return [_abs_add(bufs[0]).to(torch.bfloat16).to(torch.float32)]
    if name == "twomin_edge_no_rot":
        t, m1, m2 = bufs
        v = t - m1 * 0.5
        a = v.abs()
        m2n = torch.where(a < m1, m1, torch.minimum(m2, a))
        m1n = torch.minimum(m1, a)
        return [torch.where(v < 0, -t, t), m1n, m2n]
    m1, m2, am = bufs                                 # recon_no_rot
    sgn = torch.where(m1 > 1.0, -1.0, 1.0)
    mag = torch.where(am == 3.0, m2, m1)
    return [_abs_add(sgn * mag), m2, am]


def probe_reference(name: str, x: torch.Tensor, n_iters: int):
    """The plain version: ``(sums[G], buffers)`` after ``n_iters`` runs of
    the body on each tile of ``x[G, n_bufs, rows, 128]``."""
    _check(name, x, n_iters)
    bufs = list(x.to(torch.float32).unbind(1))
    for _ in range(n_iters):
        bufs = _run(name, bufs)
    out = torch.stack(bufs, 1).to(x.dtype)
    return out[:, 0].to(torch.float32).sum(dim=(-2, -1)), out


def probe(name: str, x: torch.Tensor, n_iters: int):
    """``(sums[G], buffers)`` of ``n_iters`` runs of probe ``name`` on
    ``x[G, n_bufs, rows, 128]``: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    _check(name, x, n_iters)
    if x.device.type == "cpu":
        return probe_reference(name, x, n_iters)
    body = PROBES[name][0]
    tiles = x.shape[0]
    lib = _lib()
    out = torch.empty_like(x)
    partial = torch.empty(tiles * (LANES // STRIP), dtype=torch.float32,
                          device=x.device)
    sums = torch.empty(tiles, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.microbench_launch(
            body, x.data_ptr(), out.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), tiles, n_iters,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"microbench launch ({name}, {tiles} tiles, "
                           f"{n_iters} runs) failed: CUDA error {rc}")
    launches[name] += 1
    return sums, out


def fill_tiles(name: str, device=None) -> int:
    """The fewest tiles whose blocks fill every SM of the card at the
    kernel's occupancy for probe ``name`` (one full wave); raises without a
    card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"fill_tiles needs a CUDA device, got {dev}")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _lib().microbench_occupancy(PROBES[name][0],
                                         ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"microbench occupancy ({name}) failed: CUDA "
                           f"error {rc}, {per_sm.value} blocks an SM")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return math.ceil(sms * per_sm.value / (LANES // STRIP))
