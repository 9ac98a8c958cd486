"""Count the SASS of the fused kernel's edge loops, flooding (B1, and B5 on
the int8 store), layered (B3) and sum-product (B4), and of the phase-split
pair's (B7), on the card's toolkit.

``csrc/decode.cu`` is compiled to a cubin with the kernel's ``nvcc``
flags for ``sm_90a`` and read with ``cuobjdump -sass``.  In the min-sum
flooding instances (B1: ``decode_kernel<0, __nv_bfloat16, false, false,
false>``, and its float32 twin) the script finds every loop by its
back-edge branch (a ``BRA`` to an address at or before its own) and keeps
the innermost ones, those that hold no other loop.  Of these, the edge
loop of phase A (the two-min fold over a check's slots) is one that holds
an ``FMNMX`` and no global load; the edge loop of phase B (the sum of a
variable's messages) is one that holds no ``FMNMX`` and no global load, a
shared load and an accumulating float add: an ``FADD`` (or the addend of an
``FFMA``) whose register is carried around the loop, or is the result of
such an add earlier in the body.

For each loop body it reports the SASS instructions, the shared-memory
instructions (``LDS*``/``STS*``) by opcode, the conversions (``F2F``,
``F2FP``, ``F2I``, ``I2F``, ``I2FP``, ``FRND``) and the edges the body
handles: in phase A the ``FMNMX`` over 2 (each edge updates the first and
the second minimum, ``fminf`` each, in every version of the fold), in
phase B the accumulating adds (one for each edge's message).  Where a
phase has several such loops (an unrolled body and its remainder), its
line is the loop with the most edges a body.

The layered instances (B3: ``decode_kernel<0, __nv_bfloat16, false, true,
false>`` and its float32 twin) have three edge loops a sweep.  The fold of
(a) holds an ``FMNMX`` (edges: ``FMNMX`` over 2, a check and a slot each);
the delta loop of (c) holds no ``FMNMX`` and an accumulating add, the
rounded total carried from edge to edge (edges: those adds); the syndrome
loop holds neither, a float compare and an xor (``LOP3.LUT`` 0x3c or 0x96)
of the parity (edges: the compares; the error count's loop has no xor).
Where a class has several loops (unrolled bodies and remainders, the one-
and two-check variants of (a), row 0's fold), its line is the loop with
the most edges a body and, of those, the fewest instructions an edge.  A
fold that holds an xor takes the parity of the totals itself (row 0's, in
the redesign of the layered sweep), so the syndrome loop covers the other
block rows only: the sum an edge-sweep weighs it by (rows - 1) / rows at
near-earth's 2 block rows, else by 1.

The int8 instance of the same loops (B5: ``decode_kernel<0, int8,
false, false, false>``) is counted the same way, with two changes for its
integer domain: the fold's minima are ``FMNMX`` or ``IMNMX``/``VIMNMX``,
phase B is the loop that loads through a table entry loaded in the same
body, and in both phases the edges are those loads (a total, a record):
the integer fold may take three minima an edge and a message two adds.

The sum-product instances (B4: ``decode_kernel<3, __nv_bfloat16, false,
false, false>`` and its float32 twin) are counted whatever their mapping
of edges to threads: every innermost loop with a shared load, no global
access, and a phi (``MUFU``) or an accumulating add is an edge loop, of
phase A where it lies before the iteration's ``__syncthreads_or``
(``BAR.RED``), of phase B after it.  Its edges a body are its
accumulating adds, or else its phi (``MUFU`` over phi's own ``MUFU``
count, from ``scripts/phi_sass.py``).  A phase's line sums, over its
loops with a phi and its loops without (of each, the one with the most
edges a body), the instructions, shared-memory instructions and phi an
edge: each such loop handles every edge once.

With ``--split`` it counts the phase-split pair of ``csrc/split.cu``
(B7) instead: in every instance of ``split_r`` and ``split_c`` with a
check degree of at most 32 (bf16 and f32; each path of the instance's
other template arguments, where it has any), the edge loop of ``split_r``
is the innermost loop that holds an ``FMNMX`` (the two-min fold; edges:
``FMNMX`` over 2) and that of ``split_c`` the innermost loop that holds no
``FMNMX``, an accumulating float add and a load (the sum of a variable's
messages; edges: those adds).  These loops read the device memory, so
global loads do not rule a loop out here as they do in ``decode.cu``.
For each it reports the instructions, the shared loads (``LDS*``) and the
global loads (``LDG*``, ``LD``) an edge; where a kernel has several such
loops, its line is the one with the most edges a body and, of those, the
fewest instructions an edge.

On the machine with the toolkit::

    python -m ldpc_tpu_torch.scripts.edge_sass [--split] [--source PATH]

prints one JSON line: per instance, each phase's shared instructions an
edge, instructions an edge and the loop's counts, the sum over the phases
(``layered``: B3's, an edge-sweep; ``sum_product``: B4's, per phase and in
all), and ``nvcc --version``'s last line
(``--split``: per kernel and store, per path, the edge loop's counts).
``--source`` counts another ``decode.cu`` (or ``split.cu``; another
revision's, unpacked with ``git archive``).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys
import tempfile

from ..csrc import NVCC_FLAGS, _nvcc
from . import phi_sass
from .phi_sass import _cuobjdump, _run

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_DECODE = _CSRC / "decode.cu"
_SPLIT = _CSRC / "split.cu"
# mangled template arguments of decode_kernel<K, S, kWide, kLayered, kPop>
_TYPES = {"13__nv_bfloat16": "bfloat16", "f": "float32", "a": "int8"}
_KERNEL = re.compile(r"decode_kernelILi(\d+)E(13__nv_bfloat16|f|a)"
                     r"Lb([01])ELb([01])ELb([01])E")
# the instances counted: min-sum, flooding, check degree <= 32, stored sign
# (int8: B1's loops on the int8 store, B5)
INSTANCES = {"B1 bfloat16": (0, "bfloat16", 0, 0, 0),
             "B1 float32": (0, "float32", 0, 0, 0),
             "B5 int8": (0, "int8", 0, 0, 0)}
# the sum-product instances counted (B4): flooding, check degree <= 32
SUM_PRODUCT = {"B4 bfloat16": (3, "bfloat16", 0, 0, 0),
               "B4 float32": (3, "float32", 0, 0, 0)}
# the layered instances counted: min-sum, check degree <= 32, stored sign
LAYERED = {"B3 bfloat16": (0, "bfloat16", 0, 1, 0),
           "B3 float32": (0, "float32", 0, 1, 0)}
NEAR_EARTH_ROWS = 2   # near-earth's block rows, for B3's sum an edge-sweep
# mangled split_r / split_c <S, kWide[, more bools]> of csrc/split.cu
_SPLIT_KERNEL = re.compile(r"split_([rc])I(13__nv_bfloat16|f)Lb([01])E"
                           r"((?:Lb[01]E)*)E")
# the split instances counted: each kernel and store, check degree <= 32
SPLIT = {"B7 split_r bfloat16": ("r", "bfloat16"),
         "B7 split_r float32": ("r", "float32"),
         "B7 split_c bfloat16": ("c", "bfloat16"),
         "B7 split_c float32": ("c", "float32")}
SPLIT_LOOP = {"r": "fold", "c": "sum"}
_XOR_LUTS = {"0x3c", "0x96"}   # a ^ b, a ^ b ^ c
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_REG = re.compile(r"\bR(\d+)\b")
_CONVERSIONS = {"F2F", "F2FP", "F2I", "I2F", "I2FP", "FRND"}
_MINS = {"FMNMX", "IMNMX", "VIMNMX"}
_GLOBAL = {"LDG", "LD", "LDGSTS", "STG", "ST"}
_GLOBAL_LOADS = {"LDG", "LD"}

Insn = collections.namedtuple("Insn", "addr pred op mods operands")


def parse(sass: str) -> dict[str, list[Insn]]:
    """The instructions of each function of a ``cuobjdump -sass`` listing,
    NOPs left out."""
    out: dict[str, list[Insn]] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and current is not None and m.group(3) != "NOP":
            current.append(Insn(int(m.group(1), 16),
                                (m.group(2) or "").strip(), m.group(3),
                                m.group(4), m.group(5).strip()))
    return out


def _branch_target(insn: Insn) -> int | None:
    if insn.op != "BRA":
        return None
    hexes = re.findall(r"0x([0-9a-f]+)", insn.operands)
    return int(hexes[-1], 16) if hexes else None


def innermost_loops(insns: list[Insn]) -> list[list[Insn]]:
    """The bodies of the loops that hold no other loop, in address order:
    a loop is a back-edge branch and the instructions from its target to
    it."""
    spans = []
    for insn in insns:
        t = _branch_target(insn)
        if t is not None and t <= insn.addr:
            spans.append((t, insn.addr))
    inner = [s for s in spans
             if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                        for o in spans)]
    return [[i for i in insns if lo <= i.addr <= hi]
            for lo, hi in sorted(set(inner))]


def _regs(text: str) -> list[int]:
    return [int(r) for r in _REG.findall(text)]


def _dests(insn: Insn) -> list[int]:
    """Registers an instruction writes: its first operand, widened by a
    .64/.128/.WIDE modifier; stores and branches write none."""
    if insn.op.startswith(("ST", "RED", "BRA", "BAR", "EXIT")):
        return []
    regs = _regs(insn.operands.split(",")[0])
    width = (4 if ".128" in insn.mods else
             2 if ".64" in insn.mods or ".WIDE" in insn.mods else 1)
    return [r + k for r in regs[:1] for k in range(width)]


def _srcs(insn: Insn) -> list[int]:
    ops = insn.operands.split(",")
    return _regs(",".join(ops if not _dests(insn) else ops[1:]))


def accumulating_adds(body: list[Insn]) -> int:
    """Float adds whose accumulator is carried around the loop: an FADD with
    a source register that holds, where it is read, the value the body
    carries from its previous pass (the body reads it before it writes it,
    and writes it later) or the result of such an add earlier in the body,
    or an FFMA whose addend is such a register.  A register that any other
    instruction overwrites holds no accumulator from then on."""
    written, read_first = set(), set()
    for insn in body:
        read_first.update(r for r in _srcs(insn) if r not in written)
        written.update(_dests(insn))
    acc = read_first & written
    count = 0
    for insn in body:
        dests = _dests(insn)
        if insn.op in ("FADD", "FFMA"):
            ops = [o.strip() for o in insn.operands.split(",")]
            srcs = ops[1:] if insn.op == "FADD" else ops[3:4]
            if any(r in acc for s in srcs for r in _regs(s)):
                count += 1
                acc.update(dests)
                continue
        acc.difference_update(dests)
    return count


def dependent_loads(body: list[Insn]) -> int:
    """Shared loads whose address derives from a value loaded earlier in
    the same pass of the body (a record or a total found through a table
    entry): one an edge in the edge loops, whatever the arithmetic."""
    tainted: set[int] = set()
    count = 0
    for insn in body:
        addr = re.findall(r"\[([^\]]*)\]", insn.operands)
        if insn.op == "LDS" and any(r in tainted for a in addr
                                    for r in _regs(a)):
            count += 1
        if insn.op == "LDS" or any(r in tainted for r in _srcs(insn)):
            tainted.update(_dests(insn))
        else:
            tainted.difference_update(_dests(insn))
    return count


def loop_counts(body: list[Insn]) -> dict:
    """Instructions, shared-memory instructions by opcode, conversions and
    the opcodes that classify a loop body."""
    ops = collections.Counter(i.op + i.mods for i in body)
    shared = {k: v for k, v in ops.items()
              if k.startswith(("LDS", "STS", "ATOMS"))}
    return {"start": hex(body[0].addr), "end": hex(body[-1].addr),
            "instructions": len(body),
            "shared": sum(shared.values()),
            "shared_by_opcode": dict(sorted(shared.items())),
            "conversions": sum(1 for i in body if i.op in _CONVERSIONS),
            "fmnmx": sum(1 for i in body if i.op == "FMNMX"),
            "mins": sum(1 for i in body if i.op in _MINS),
            "fsetp": sum(1 for i in body if i.op == "FSETP"),
            "xors": sum(1 for i in body if i.op == "LOP3" and
                        i.operands.split(",")[-2].strip() in _XOR_LUTS),
            "accumulating_adds": accumulating_adds(body),
            "dependent_loads": dependent_loads(body),
            "mufu": sum(1 for i in body if i.op == "MUFU"),
            "global": sum(1 for i in body if i.op in _GLOBAL),
            "shared_loads": sum(1 for i in body if i.op == "LDS"),
            "global_loads": sum(1 for i in body if i.op in _GLOBAL_LOADS)}


def classify(c: dict) -> str | None:
    """Phase "A", "B" or None (another loop) of a loop's counts: phase A
    holds the fold's minima (``FMNMX``, or the integer domain's ``IMNMX``),
    phase B an accumulating add."""
    if c["global"]:
        return None
    if c["mins"]:
        return "A"
    if c["accumulating_adds"] and c["shared"]:
        return "B"
    return None


def edge_loops(insns: list[Insn], integer: bool = False) -> dict:
    """Each phase's edge loop (the one with the most edges a body) with its
    edges and per-edge counts, the other candidates, and the sum of the two
    phases' shared instructions an edge.  With ``integer`` (the int8
    instance, whose adds are integer ones) a phase-B loop is one that loads
    through a table, and in both phases the edges are those loads
    (``dependent_loads``: a total in A, a record in B): the integer fold may
    take three minima an edge, and a message two adds."""
    res: dict = {"loops": []}
    for body in innermost_loops(insns):
        c = loop_counts(body)
        phase = classify(c)
        if integer and phase != "A":
            phase = ("B" if c["dependent_loads"] and not c["global"]
                     else None)
        if phase is None:
            continue
        edges = (c["dependent_loads"] if integer
                 else c["mins"] / 2 if phase == "A"
                 else c["accumulating_adds"])
        c.update(phase=phase, edges=edges,
                 shared_per_edge=c["shared"] / edges,
                 instructions_per_edge=c["instructions"] / edges)
        res["loops"].append(c)
    for phase in ("A", "B"):
        cands = [c for c in res["loops"] if c["phase"] == phase]
        res[phase] = max(cands, key=lambda c: c["edges"]) if cands else None
    if res["A"] and res["B"]:
        res["shared_per_edge"] = (res["A"]["shared_per_edge"] +
                                  res["B"]["shared_per_edge"])
        res["instructions_per_edge"] = (res["A"]["instructions_per_edge"] +
                                        res["B"]["instructions_per_edge"])
    return res


def sum_product_loops(insns: list[Insn], phi_mufu: int) -> dict:
    """The edge loops of a sum-product instance, whatever their mapping:
    every innermost loop with a shared load, no global access, and a phi
    (``MUFU``) or an accumulating add.  A loop before the iteration's
    ``__syncthreads_or`` (``BAR.RED``) is phase A, one after it phase B.
    Its edges a body are its accumulating adds (a sum takes one an edge)
    or else its phi (``MUFU`` over ``phi_mufu``, phi's own count).  Per
    phase and in all: the sum over its loops (of those with a phi, and of
    those without, the one with the most edges a body: an unrolled body,
    not its remainder) of the instructions, the shared-memory instructions
    and the phi an edge."""
    bar = min((i.addr for i in insns if i.op == "BAR" and
               i.mods.startswith(".RED")), default=None)
    if bar is None:
        raise RuntimeError("no __syncthreads_or (BAR.RED) in the listing")
    res: dict = {"loops": []}
    for body in innermost_loops(insns):
        c = loop_counts(body)
        if (c["global"] or not c["shared_loads"] or
                not (c["mufu"] or c["accumulating_adds"])):
            continue
        edges = c["accumulating_adds"] or c["mufu"] / phi_mufu
        c.update(phase="A" if body[-1].addr < bar else "B", edges=edges,
                 phi_per_edge=c["mufu"] / phi_mufu / edges,
                 shared_per_edge=c["shared"] / edges,
                 instructions_per_edge=c["instructions"] / edges)
        res["loops"].append(c)
    keys = ("instructions_per_edge", "shared_per_edge", "phi_per_edge")
    for phase in ("A", "B"):
        # of the loops with a phi, and of those without, the one with the
        # most edges a body (an unrolled body, not its remainder)
        loops = []
        for with_phi in (True, False):
            cands = [c for c in res["loops"] if c["phase"] == phase and
                     bool(c["mufu"]) == with_phi]
            if cands:
                loops.append(max(cands, key=lambda c: c["edges"]))
        if not loops:
            raise RuntimeError(f"no sum-product loop in phase {phase}")
        res[phase] = {k: sum(c[k] for c in loops) for k in keys}
        res[phase]["loops"] = len(loops)
    for k in keys:
        res[k] = res["A"][k] + res["B"][k]
    return res


def classify_layered(c: dict) -> str | None:
    """``"syndrome"``, ``"fold"``, ``"delta"`` or None of a loop's counts
    in a layered instance."""
    if c["global"] or not any(k.startswith("LDS")
                              for k in c["shared_by_opcode"]):
        return None
    if c["fmnmx"]:
        return "fold"
    if c["accumulating_adds"]:
        return "delta"
    if c["fsetp"] and c["xors"]:
        return "syndrome"
    return None


LAYERED_EDGES = {"syndrome": lambda c: c["fsetp"],
                 "fold": lambda c: c["fmnmx"] / 2,
                 "delta": lambda c: c["accumulating_adds"]}


def layered_loops(insns: list[Insn], rows: int = NEAR_EARTH_ROWS) -> dict:
    """Each class's edge loop in a layered instance (the most edges a body,
    then the fewest instructions an edge), the syndrome loop's share of a
    sweep's edges, and the sums an edge-sweep."""
    res: dict = {"loops": []}
    for body in innermost_loops(insns):
        c = loop_counts(body)
        kind = classify_layered(c)
        if kind is None:
            continue
        edges = LAYERED_EDGES[kind](c)
        c.update(phase=kind, edges=edges,
                 shared_per_edge=c["shared"] / edges,
                 instructions_per_edge=c["instructions"] / edges)
        res["loops"].append(c)
    for kind in LAYERED_EDGES:
        cands = [c for c in res["loops"] if c["phase"] == kind]
        res[kind] = (min(cands, key=lambda c: (-c["edges"],
                                               c["instructions_per_edge"]))
                     if cands else None)
    folds_parity = any(c["phase"] == "fold" and c["xors"]
                       for c in res["loops"])
    res["syndrome_share"] = (rows - 1) / rows if folds_parity else 1.0
    if all(res[k] for k in LAYERED_EDGES):
        w = {"syndrome": res["syndrome_share"], "fold": 1.0, "delta": 1.0}
        for key in ("shared_per_edge", "instructions_per_edge"):
            res[key] = sum(w[k] * res[k][key] for k in LAYERED_EDGES)
    return res


def classify_split(c: dict) -> str | None:
    """``"fold"`` (split_r's edge loop), ``"sum"`` (split_c's) or None of a
    loop's counts in a split instance."""
    if c["fmnmx"]:
        return "fold"
    if c["accumulating_adds"] and (c["shared_loads"] or c["global_loads"]):
        return "sum"
    return None


def split_loop(insns: list[Insn], kind: str) -> dict | None:
    """The edge loop of class ``kind`` in a split instance (the most edges
    a body, then the fewest instructions an edge) with its per-edge
    counts, or None."""
    cands = []
    for body in innermost_loops(insns):
        c = loop_counts(body)
        if classify_split(c) != kind:
            continue
        edges = c["fmnmx"] / 2 if kind == "fold" else c["accumulating_adds"]
        c.update(phase=kind, edges=edges,
                 instructions_per_edge=c["instructions"] / edges,
                 shared_loads_per_edge=c["shared_loads"] / edges,
                 global_loads_per_edge=c["global_loads"] / edges)
        cands.append(c)
    return (min(cands, key=lambda c: (-c["edges"],
                                      c["instructions_per_edge"]))
            if cands else None)


def split_instance(mangled: str) -> tuple | None:
    """(kernel ``"r"`` or ``"c"``, store, kWide, the other template bools
    as a string such as ``"01"``) of a mangled split kernel's name."""
    m = _SPLIT_KERNEL.search(mangled)
    if not m:
        return None
    k, s, w, rest = m.groups()
    return k, _TYPES[s], bool(int(w)), "".join(re.findall(r"[01]", rest))


def analyse_split(sass: str) -> dict:
    """Per counted (kernel, store), per instance with a check degree of at
    most 32 (keyed by its other template bools, ``""`` where it has
    none), the edge loop's counts."""
    insts = {}
    for name, insns in parse(sass).items():
        inst = split_instance(name)
        if inst:
            insts[inst] = insns
    out = {}
    for label, (k, store) in SPLIT.items():
        found = {rest: insns for (kk, s, wide, rest), insns in insts.items()
                 if (kk, s, wide) == (k, store, False)}
        if not found:
            raise RuntimeError(f"split_{k}<{store}, false> is not in the "
                               "listing")
        res = {}
        for rest, insns in sorted(found.items()):
            loop = split_loop(insns, SPLIT_LOOP[k])
            if loop is None:
                raise RuntimeError(f"split_{k}<{store}, false{rest}>: no "
                                   f"{SPLIT_LOOP[k]} loop")
            res[rest] = loop
        out[label] = res
    return out


def split_summary(res: dict) -> str:
    """One line: per counted split kernel and path, its edge loop's
    instructions, shared loads and global loads an edge."""
    parts = []
    for label in SPLIT:
        for rest, c in res[label].items():
            parts.append(
                f"{label}{' <' + rest + '>' if rest else ''}: "
                f"{c['instructions_per_edge']:.3g} instructions, "
                f"{c['shared_loads_per_edge']:.3g} shared and "
                f"{c['global_loads_per_edge']:.3g} global loads an edge "
                f"({c['edges']:g} edges a body)")
    return "; ".join(parts)


def instance_name(mangled: str) -> str | None:
    """``decode_kernel<K, S, kWide, kLayered, kPop>`` of a mangled name."""
    m = _KERNEL.search(mangled)
    if not m:
        return None
    k, s, w, lay, pop = m.groups()
    return (f"decode_kernel<{k}, {_TYPES[s]}, {bool(int(w))}, "
            f"{bool(int(lay))}, {bool(int(pop))}>")


def analyse(sass: str) -> dict:
    """The edge loops of each counted instance in a listing."""
    funcs = {instance_name(k): v for k, v in parse(sass).items()}
    out = {}
    for label, (k, s, w, lay, pop) in INSTANCES.items():
        name = (f"decode_kernel<{k}, {s}, {bool(w)}, {bool(lay)}, "
                f"{bool(pop)}>")
        if name not in funcs:
            raise RuntimeError(f"{name} is not in the listing")
        res = edge_loops(funcs[name], integer=s == "int8")
        if res["A"] is None or res["B"] is None:
            raise RuntimeError(f"{name}: no edge loop of phase "
                               f"{'A' if res['A'] is None else 'B'}")
        out[label] = res
    return out


def analyse_sum_product(sass: str, phi_mufu: int) -> dict:
    """The edge loops of each counted sum-product instance in a listing."""
    funcs = {instance_name(k): v for k, v in parse(sass).items()}
    out = {}
    for label, (k, s, w, lay, pop) in SUM_PRODUCT.items():
        name = (f"decode_kernel<{k}, {s}, {bool(w)}, {bool(lay)}, "
                f"{bool(pop)}>")
        if name not in funcs:
            raise RuntimeError(f"{name} is not in the listing")
        out[label] = sum_product_loops(funcs[name], phi_mufu)
    return out


def analyse_layered(sass: str) -> dict:
    """The edge loops of each counted layered instance in a listing."""
    funcs = {instance_name(k): v for k, v in parse(sass).items()}
    out = {}
    for label, (k, s, w, lay, pop) in LAYERED.items():
        name = (f"decode_kernel<{k}, {s}, {bool(w)}, {bool(lay)}, "
                f"{bool(pop)}>")
        if name not in funcs:
            raise RuntimeError(f"{name} is not in the listing")
        res = layered_loops(funcs[name])
        missing = [k for k in LAYERED_EDGES if res[k] is None]
        if missing:
            raise RuntimeError(f"{name}: no {missing[0]} loop")
        out[label] = res
    return out


def _sass(path: pathlib.Path) -> tuple[str, str]:
    """``cuobjdump -sass`` of ``path`` compiled to a cubin with the build's
    flags, and ``nvcc --version``'s last line."""
    nvcc = _nvcc()
    cuobjdump = _cuobjdump(nvcc)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "kernel.cubin"
        _run([nvcc, *flags, "-cubin", "-o", str(cubin), str(path)])
        sass = _run([cuobjdump, "-sass", str(cubin)])
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    return sass, version.splitlines()[-1] if version else ""


def count(path: pathlib.Path = _DECODE) -> dict:
    """Compile ``path`` to a cubin and count its edge loops; raises where
    ``nvcc`` or ``cuobjdump`` fails or a loop is not found."""
    sass, version = _sass(path)
    res = analyse(sass)
    res["layered"] = analyse_layered(sass)
    phi_mufu = phi_sass.count(path)["by_opcode"].get("MUFU", 0)
    if not phi_mufu:
        raise RuntimeError("phi holds no MUFU: its evaluations cannot be "
                           "counted")
    res["sum_product"] = analyse_sum_product(sass, phi_mufu)
    res["phi_mufu"] = phi_mufu
    res["source"] = str(path)
    res["nvcc"] = version
    return res


def count_split(path: pathlib.Path = _SPLIT) -> dict:
    """Compile a ``split.cu`` to a cubin and count its edge loops; raises
    where ``nvcc`` or ``cuobjdump`` fails or a loop is not found."""
    sass, version = _sass(path)
    return {**analyse_split(sass), "source": str(path), "nvcc": version}


def summary(res: dict) -> str:
    """One line: each instance's shared instructions an edge, per phase
    (B3's, with ``layered`` in ``res``, an edge-sweep)."""
    parts = []
    for label in INSTANCES:
        r = res[label]
        parts.append(
            f"{label}: phase A {r['A']['shared_per_edge']:.3g} shared "
            f"({r['A']['instructions_per_edge']:.3g} instructions) an edge, "
            f"phase B {r['B']['shared_per_edge']:.3g} "
            f"({r['B']['instructions_per_edge']:.3g}), "
            f"{r['shared_per_edge']:.3g} in all")
    for label, r in res.get("layered", {}).items():
        parts.append(
            f"{label}: syndrome {r['syndrome']['shared_per_edge']:.3g} "
            f"shared ({r['syndrome']['instructions_per_edge']:.3g} "
            f"instructions) an edge x {r['syndrome_share']:.3g}, fold "
            f"{r['fold']['shared_per_edge']:.3g} "
            f"({r['fold']['instructions_per_edge']:.3g}), delta "
            f"{r['delta']['shared_per_edge']:.3g} "
            f"({r['delta']['instructions_per_edge']:.3g}), "
            f"{r['shared_per_edge']:.3g} ({r['instructions_per_edge']:.3g}) "
            "an edge-sweep")
    for label, r in res.get("sum_product", {}).items():
        parts.append(
            f"{label}: phase A {r['A']['shared_per_edge']:.3g} shared "
            f"({r['A']['instructions_per_edge']:.4g} instructions, "
            f"{r['A']['phi_per_edge']:.3g} phi) an edge, phase B "
            f"{r['B']['shared_per_edge']:.3g} "
            f"({r['B']['instructions_per_edge']:.4g}, "
            f"{r['B']['phi_per_edge']:.3g} phi), "
            f"{r['instructions_per_edge']:.4g} instructions and "
            f"{r['phi_per_edge']:.3g} phi in all")
    return "; ".join(parts)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", action="store_true",
                    help="count split.cu's loops instead of decode.cu's")
    ap.add_argument("--source", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if args.split:
        res = count_split(args.source or _SPLIT)
    else:
        res = count(args.source or _DECODE)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
