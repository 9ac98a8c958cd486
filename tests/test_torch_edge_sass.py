"""The edge-loop SASS counter of the fused kernel
(``ldpc_tpu_torch/scripts/edge_sass.py``) on canned ``cuobjdump -sass``
listings; the count itself needs the card's toolkit (``tests/test_torch_gpu
.py``)."""

import pytest

from ldpc_tpu_torch.scripts import edge_sass

_B1 = "_ZN12_GLOBAL__N_113decode_kernelILi0E13__nv_bfloat16Lb0ELb0ELb0EEEvNS_4ArgsE"
_F32 = "_ZN12_GLOBAL__N_113decode_kernelILi0EfLb0ELb0ELb0EEEvNS_4ArgsE"
_I8 = "_ZN12_GLOBAL__N_113decode_kernelILi0EaLb0ELb0ELb0EEEvNS_4ArgsE"

# a phase-A loop (0x10-0x90: two edges, 2 FMNMX each, 3 shared loads), a
# phase-B loop (0xb0-0x110: two accumulating FADDs, 3 shared loads, a
# conversion), an init loop with a global load (0x130-0x160) and an error
# count loop with no float add (0x170-0x1a0)
_BODY = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.64 R10, [R3] ;
        /*0020*/                   LDS.U16 R4, [R2] ;
        /*0030*/                   LDS.U16 R5, [R2+0x200] ;
        /*0040*/                   FADD R6, R4, -R7 ;
        /*0050*/                   FMNMX R8, R8, |R6|, PT ;
        /*0060*/               @P1 FMNMX R9, |R6|, R9, PT ;
        /*0070*/                   FMNMX R12, R12, |R5|, PT ;
        /*0080*/                   FMNMX R13, |R5|, R13, PT ;
        /*0090*/              @P0 BRA 0x10 ;
        /*00a0*/                   STS.128 [R2], R8 ;
        /*00b0*/                   LDS.128 R12, [R3+0x10] ;
        /*00c0*/                   LDS.128 R16, [R2+0x10] ;
        /*00d0*/                   LDS.128 R24, [R2+0x810] ;
        /*00e0*/                   LOP3.LUT R20, R17, 0x7fff0000, RZ, 0xc0, !PT ;
        /*00f0*/                   FADD R21, R21, R20 ;
        /*0100*/                   FADD R22, R22, R25 ;
        /*0110*/              @!P1 BRA 0xb0 ;
        /*0120*/                   F2FP.BF16.F32.PACK_AB R23, RZ, R21 ;
        /*0130*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0140*/                   FMNMX R4, R4, 1e+30, PT ;
        /*0150*/                   STS.U16 [R5], R4 ;
        /*0160*/              @P2 BRA 0x130 ;
        /*0170*/                   LDS.U16 R4, [R5] ;
        /*0180*/                   FSETP.GEU.AND P3, PT, R4, RZ, PT ;
        /*0190*/                   IADD3 R6, R6, 0x1, RZ ;
        /*01a0*/              @P4 BRA 0x170 ;
        /*01b0*/                   EXIT ;
        /*01c0*/                   BRA 0x1c0;
"""


def _listing(names=(_B1, _F32, _I8)):
    return "\n\tcode for sm_90a\n" + "".join(
        f"\t\tFunction : {n}\n{_I8_BODY if n == _I8 else _BODY}"
        for n in names)


def test_parse_drops_nops_and_keeps_predicates():
    funcs = edge_sass.parse(_listing((_B1,)) + "        /*01d0*/    NOP;\n")
    insns = funcs[_B1]
    assert len(insns) == 29
    assert insns[6].op == "FMNMX" and insns[6].pred == "@P1"
    assert insns[2].op == "LDS" and insns[2].mods == ".U16"


def test_innermost_loops_follow_back_edges():
    insns = edge_sass.parse(_listing((_B1,)))[_B1]
    loops = edge_sass.innermost_loops(insns)
    # the BRA to itself at 0x1c0 is a loop of one instruction
    assert [(hex(b[0].addr), hex(b[-1].addr)) for b in loops] == [
        ("0x10", "0x90"), ("0xb0", "0x110"), ("0x130", "0x160"),
        ("0x170", "0x1a0"), ("0x1c0", "0x1c0")]


def test_an_outer_loop_is_not_innermost():
    listing = """
        Function : k
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/              @P0 BRA 0x10 ;
        /*0030*/              @P1 BRA 0x0 ;
"""
    loops = edge_sass.innermost_loops(edge_sass.parse(listing)["k"])
    assert [len(b) for b in loops] == [2]


def test_accumulating_adds_follow_loop_carried_registers():
    listing = """
        Function : k
        /*0000*/                   LDS R4, [R2] ;
        /*0010*/                   FADD R5, R4, R4 ;
        /*0020*/                   FFMA R6, R4, -2, 1 ;
        /*0030*/                   FFMA R7, R4, R6, R7 ;
        /*0040*/                   FADD R8, R7, R5 ;
        /*0050*/                   MOV R7, R8 ;
        /*0060*/              @P0 BRA 0x0 ;
"""
    body = edge_sass.parse(listing)["k"]
    # R7 is carried: FFMA R7 (addend R7) and FADD R8 (from R7) accumulate;
    # FADD R5 and FFMA R6 work on the loaded value only
    assert edge_sass.accumulating_adds(body) == 2


def test_edge_loops_count_shared_instructions_an_edge():
    res = edge_sass.edge_loops(edge_sass.parse(_listing((_B1,)))[_B1])
    assert [c["phase"] for c in res["loops"]] == ["A", "B"]
    a, b = res["A"], res["B"]
    assert (a["instructions"], a["shared"], a["edges"]) == (9, 3, 2)
    assert a["shared_by_opcode"] == {"LDS.64": 1, "LDS.U16": 2}
    assert a["shared_per_edge"] == 1.5
    assert (b["instructions"], b["shared"], b["edges"]) == (7, 3, 2)
    assert b["shared_by_opcode"] == {"LDS.128": 3}
    assert b["conversions"] == 0 and b["accumulating_adds"] == 2
    assert res["shared_per_edge"] == 3.0
    assert res["instructions_per_edge"] == pytest.approx(9 / 2 + 7 / 2)


def test_stores_and_conversions_are_counted():
    listing = """
        Function : k
        /*0000*/                   LDS.U16 R4, [R2] ;
        /*0010*/                   I2FP.F32.U32 R5, R4 ;
        /*0020*/                   FMNMX R6, R6, |R5|, PT ;
        /*0030*/                   FMNMX R7, R7, |R5|, PT ;
        /*0040*/                   STS [R3], R6 ;
        /*0050*/                   F2FP.BF16.F32.PACK_AB R8, RZ, R6 ;
        /*0060*/              @P0 BRA 0x0 ;
"""
    c = edge_sass.loop_counts(edge_sass.parse(listing)["k"])
    assert c["shared_by_opcode"] == {"LDS.U16": 1, "STS": 1}
    assert c["conversions"] == 2 and edge_sass.classify(c) == "A"


def test_instance_names_from_mangled_names():
    assert (edge_sass.instance_name(_B1) ==
            "decode_kernel<0, bfloat16, False, False, False>")
    assert (edge_sass.instance_name(
        "_ZN12_GLOBAL__N_113decode_kernelILi2EaLb1ELb1ELb0EEEvNS_4ArgsE") ==
        "decode_kernel<2, int8, True, True, False>")
    assert edge_sass.instance_name("_Z8split_rv") is None


def test_analyse_and_summary():
    res = edge_sass.analyse(_listing())
    assert set(res) == set(edge_sass.INSTANCES)
    line = edge_sass.summary(res)
    assert "B1 bfloat16: phase A 1.5 shared" in line and "3 in all" in line


def test_analyse_raises_without_an_instance_or_a_loop():
    with pytest.raises(RuntimeError, match="not in the listing"):
        edge_sass.analyse(_listing((_B1,)))
    no_loop = "\n\t\tFunction : {}\n        /*0000*/  EXIT ;\n"
    with pytest.raises(RuntimeError, match="no edge loop of phase A"):
        edge_sass.analyse(no_loop.format(_B1) + no_loop.format(_F32))


def test_count_raises_without_the_toolkit(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(edge_sass, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        edge_sass.count()


# B3's loops: a syndrome loop (0x10-0x80: one slot, two checks, LDS.64 +
# 2 LDS.U16, two compares, two xors), row 0's fold with the parity
# (0xa0-0x100: one check-edge, 2 FMNMX, an xor), a fold without it
# (0x120-0x170), the delta loop (0x190-0x220: one edge, its entry and two
# records, the subtract and the add carried from edge to edge through the
# bf16 rounding), and the error count (0x240-0x270: a compare, no xor)
_B3 = "_ZN12_GLOBAL__N_113decode_kernelILi0E13__nv_bfloat16Lb0ELb1ELb0EEEvNS_4ArgsE"
_B3F = "_ZN12_GLOBAL__N_113decode_kernelILi0EfLb0ELb1ELb0EEEvNS_4ArgsE"
_B3_BODY = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.64 R2, [R9] ;
        /*0020*/                   LDS.U16 R4, [R2+UR4] ;
        /*0030*/                   LDS.U16 R5, [R3+UR4] ;
        /*0040*/                   FSETP.GEU.AND P1, PT, R4, RZ, PT ;
        /*0050*/                   FSETP.GEU.AND P2, PT, R5, RZ, PT ;
        /*0060*/               @!P1 LOP3.LUT R7, R7, 0x1, RZ, 0x3c, !PT ;
        /*0070*/               @!P2 LOP3.LUT R8, R8, 0x1, RZ, 0x3c, !PT ;
        /*0080*/               @P0 BRA 0x10 ;
        /*0090*/                   BAR.RED.OR.DEFER_BLOCKING P0, 0x0, P1 ;
        /*00a0*/                   LDS.64 R2, [R9] ;
        /*00b0*/                   LDS.U16 R4, [R2+UR4] ;
        /*00c0*/                   FSETP.GEU.AND P1, PT, R4, RZ, PT ;
        /*00d0*/                   FMNMX R10, |R4|, R10, PT ;
        /*00e0*/                   FMNMX R11, |R4|, R11, PT ;
        /*00f0*/               @!P1 LOP3.LUT R7, R7, 0x1, RZ, 0x3c, !PT ;
        /*0100*/               @P0 BRA 0xa0 ;
        /*0110*/                   STS.128 [R12], R8 ;
        /*0120*/                   LDS.64 R2, [R9] ;
        /*0130*/                   LDS.U16 R4, [R2+UR4] ;
        /*0140*/                   FMNMX R10, |R4|, R10, PT ;
        /*0150*/                   FMNMX R11, |R4|, R11, PT ;
        /*0160*/                   IADD3 R9, R9, 0x8, RZ ;
        /*0170*/               @P0 BRA 0x120 ;
        /*0180*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0190*/                   LDS.128 R12, [R9] ;
        /*01a0*/                   LDS.128 R16, [R12+UR4] ;
        /*01b0*/                   LDS.128 R20, [R13+UR4] ;
        /*01c0*/                   LOP3.LUT R17, R17, 0x80000000, R24, 0x78, !PT ;
        /*01d0*/                   LOP3.LUT R21, R21, 0x80000000, R24, 0x78, !PT ;
        /*01e0*/                   FADD R28, -R17, R21 ;
        /*01f0*/                   FADD R29, R28, R30 ;
        /*0200*/                   F2FP.BF16.F32.PACK_AB R29, RZ, R29 ;
        /*0210*/                   IMAD.U32 R30, R29, 0x10000, RZ ;
        /*0220*/               @P0 BRA 0x190 ;
        /*0230*/                   STS.U16 [R5], R30 ;
        /*0240*/                   LDS.U16 R4, [R5] ;
        /*0250*/                   FSETP.GEU.AND P3, PT, R4, RZ, PT ;
        /*0260*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0270*/               @P4 BRA 0x240 ;
        /*0280*/                   EXIT ;
"""


def _layered_listing(names=(_B3, _B3F), body=_B3_BODY):
    return "\n\tcode for sm_90a\n" + "".join(
        f"\t\tFunction : {n}\n{body}" for n in names)


def test_layered_loops_are_classified_and_weighed():
    insns = edge_sass.parse(_layered_listing((_B3,)))[_B3]
    res = edge_sass.layered_loops(insns)
    assert [c["phase"] for c in res["loops"]] == [
        "syndrome", "fold", "fold", "delta"]
    syn, fold, delta = res["syndrome"], res["fold"], res["delta"]
    assert (syn["edges"], syn["shared"], syn["xors"]) == (2, 3, 2)
    assert syn["shared_per_edge"] == 1.5
    # both folds take one check-edge: the one with fewer instructions
    assert fold["start"] == "0x120" and fold["edges"] == 1
    assert fold["shared_per_edge"] == 2.0
    assert (delta["edges"], delta["shared"]) == (1, 3)
    assert delta["shared_by_opcode"] == {"LDS.128": 3}
    assert delta["conversions"] == 1
    # row 0's fold takes the parity: the syndrome loop covers row 1 of 2
    assert res["syndrome_share"] == 0.5
    assert res["shared_per_edge"] == 0.5 * 1.5 + 2.0 + 3.0
    assert res["instructions_per_edge"] == pytest.approx(
        0.5 * 8 / 2 + 6 + 10)


def test_layered_syndrome_covers_every_row_without_a_parity_fold():
    """The layered sweep before its redesign: a syndrome pass over every
    block row (xors of three inputs), a fold with no xor."""
    body = _B3_BODY.replace("0x3c", "0x96").replace(
        "@!P1 LOP3.LUT R7, R7, 0x1, RZ, 0x96, !PT ;\n        /*0100*/",
        "IADD3 R6, R6, 0x1, RZ ;\n        /*0100*/")
    insns = edge_sass.parse(_layered_listing((_B3,), body))[_B3]
    res = edge_sass.layered_loops(insns)
    assert res["syndrome_share"] == 1.0
    assert res["syndrome"]["xors"] == 2
    assert res["shared_per_edge"] == 1.5 + 2.0 + 3.0


def test_accumulating_adds_drop_an_overwritten_register():
    """R5 carries the total into the first add; once a load overwrites it,
    an add that reads R5 adds no carried value."""
    listing = """
        Function : k
        /*0000*/                   LDS R4, [R2] ;
        /*0010*/                   FADD R6, R4, R5 ;
        /*0020*/                   LDS R5, [R3] ;
        /*0030*/                   FADD R7, R4, R5 ;
        /*0040*/                   FADD R8, R6, R7 ;
        /*0050*/                   MOV R5, R8 ;
        /*0060*/              @P0 BRA 0x0 ;
"""
    body = edge_sass.parse(listing)["k"]
    # FADD R6 (carried R5) and FADD R8 (from R6) accumulate; FADD R7 not
    assert edge_sass.accumulating_adds(body) == 2


def test_analyse_layered_and_summary():
    res = edge_sass.analyse_layered(_layered_listing())
    assert set(res) == set(edge_sass.LAYERED)
    line = edge_sass.summary({**edge_sass.analyse(_listing()),
                              "layered": res})
    assert "B1 bfloat16: phase A 1.5 shared" in line
    assert "B3 bfloat16: syndrome 1.5 shared" in line
    assert "x 0.5" in line and "5.75 (18)" in line and "edge-sweep" in line


def test_analyse_layered_raises_without_an_instance_or_a_loop():
    with pytest.raises(RuntimeError, match="not in the listing"):
        edge_sass.analyse_layered(_layered_listing((_B3,)))
    no_delta = _B3_BODY.replace("FADD R29, R28, R30", "FADD R29, R28, R28")
    with pytest.raises(RuntimeError, match="no delta loop"):
        edge_sass.analyse_layered(_layered_listing(body=no_delta))


# B7's loops (csrc/split.cu, --split): split_r's fold reads a total from
# device memory an edge (0x10-0x90: one table entry from shared memory
# for two checks, two LDG totals, two edges of 2 FMNMX each), and a count
# loop with a compare and no float add (0xb0-0xe0); split_c's sum reads a
# 16-byte record an edge (0x10-0x70: an entry by LDG, two LDS.128
# records, two accumulating FADDs)
_SR = ("_ZN12_GLOBAL__N_17split_rI13__nv_bfloat16Lb0ELb1EEEvNS_8Geometry"
       "ENS_5StateIT_EEi")
_SR_GLOBAL = _SR.replace("Lb0ELb1EE", "Lb0ELb0EE")
_SR_WIDE = _SR.replace("Lb0ELb1EE", "Lb1ELb1EE")
_SC = _SR.replace("split_r", "split_c")
_SR_BODY = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.64 R2, [R9] ;
        /*0020*/                   LDG.E.U16.CONSTANT R4, desc[UR4][R2.64] ;
        /*0030*/                   LDG.E.U16.CONSTANT R5, desc[UR4][R6.64] ;
        /*0040*/                   FADD R6, R4, -R7 ;
        /*0050*/                   FMNMX R8, |R6|, R8, PT ;
        /*0060*/                   FMNMX R9, |R6|, R9, PT ;
        /*0070*/                   FMNMX R12, |R5|, R12, PT ;
        /*0080*/                   FMNMX R13, |R5|, R13, PT ;
        /*0090*/               @P0 BRA 0x10 ;
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R8 ;
        /*00b0*/                   LDS.U16 R4, [R5] ;
        /*00c0*/                   FSETP.GEU.AND P3, PT, R4, RZ, PT ;
        /*00d0*/                   IADD3 R6, R6, 0x1, RZ ;
        /*00e0*/               @P4 BRA 0xb0 ;
        /*00f0*/                   EXIT ;
"""
_SC_BODY = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R12, desc[UR4][R2.64] ;
        /*0020*/                   LDS.128 R16, [R12+UR4] ;
        /*0030*/                   LDS.128 R20, [R13+UR4] ;
        /*0040*/                   LOP3.LUT R17, R17, 0x80000000, R24, 0x78, !PT ;
        /*0050*/                   FADD R26, R26, R17 ;
        /*0060*/                   FADD R27, R27, R21 ;
        /*0070*/               @P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""


def _split_listing(bodies):
    return "\n\tcode for sm_90a\n" + "".join(
        f"\t\tFunction : {name}\n{body}" for name, body in bodies)


def _split_pair(store_names=("13__nv_bfloat16", "f")):
    """split_r and split_c in both stores, staged and not."""
    out = []
    for s in store_names:
        for r in (_SR, _SR_GLOBAL):
            name = r.replace("13__nv_bfloat16", s)
            out += [(name, _SR_BODY),
                    (name.replace("split_r", "split_c"), _SC_BODY)]
    return out


def test_split_instances_from_mangled_names():
    assert edge_sass.split_instance(_SR) == ("r", "bfloat16", False, "1")
    assert edge_sass.split_instance(_SR_WIDE) == ("r", "bfloat16", True,
                                                  "1")
    # before the redesign: split_r<S, kWide> only
    old = _SR.replace("Lb0ELb1EE", "Lb0EE").replace("13__nv_bfloat16", "f")
    assert edge_sass.split_instance(old) == ("r", "float32", False, "")
    assert edge_sass.split_instance(_B1) is None
    assert edge_sass.instance_name(_SR) is None


def test_split_fold_counts_its_global_loads():
    """The fold reads device memory: global loads do not rule it out, as
    they rule out a loop of decode.cu."""
    body = edge_sass.parse(_split_listing([(_SR, _SR_BODY)]))[_SR]
    c = edge_sass.split_loop(body, "fold")
    assert edge_sass.classify(edge_sass.loop_counts(
        edge_sass.innermost_loops(body)[0])) is None
    assert (c["instructions"], c["edges"]) == (9, 2)
    assert (c["shared_loads"], c["global_loads"]) == (1, 2)
    assert c["shared_loads_per_edge"] == 0.5
    assert c["global_loads_per_edge"] == 1.0
    assert c["instructions_per_edge"] == 4.5
    # the count loop (a compare, no add) is no edge loop of split_c
    assert edge_sass.split_loop(body, "sum") is None


def test_split_sum_counts_record_loads():
    body = edge_sass.parse(_split_listing([(_SC, _SC_BODY)]))[_SC]
    c = edge_sass.split_loop(body, "sum")
    assert (c["instructions"], c["edges"]) == (7, 2)
    assert c["shared_by_opcode"] == {"LDS.128": 2}
    assert (c["shared_loads_per_edge"], c["global_loads_per_edge"]) == (
        1.0, 0.5)
    assert edge_sass.split_loop(body, "fold") is None


def test_analyse_split_keys_each_path_and_summary():
    res = edge_sass.analyse_split(_split_listing(_split_pair()))
    assert set(res) == set(edge_sass.SPLIT)
    assert set(res["B7 split_r bfloat16"]) == {"0", "1"}
    assert res["B7 split_c float32"]["1"]["phase"] == "sum"
    line = edge_sass.split_summary(res)
    assert ("B7 split_r bfloat16 <1>: 4.5 instructions, 0.5 shared and 1 "
            "global loads an edge (2 edges a body)") in line
    assert "B7 split_c float32 <0>: 3.5 instructions" in line


def test_analyse_split_raises_without_an_instance_or_a_loop():
    """A kernel whose loops hold neither a fold nor a sum raises, as does a
    listing without the instance; the wide instances are not counted."""
    with pytest.raises(RuntimeError, match="not in the listing"):
        edge_sass.analyse_split(_split_listing(
            [(n, b) for n, b in _split_pair() if "split_c" not in n]))
    neither = _SC_BODY.replace("FADD R26, R26, R17", "FMUL R26, R25, R17")
    neither = neither.replace("FADD R27, R27, R21", "FMUL R27, R25, R21")
    pairs = [(n, neither if "split_c" in n else b)
             for n, b in _split_pair()]
    with pytest.raises(RuntimeError, match="no sum loop"):
        edge_sass.analyse_split(_split_listing(pairs))
    wide_only = [(n.replace("Lb0EL", "Lb1EL"), b) for n, b in _split_pair()]
    with pytest.raises(RuntimeError, match="not in the listing"):
        edge_sass.analyse_split(_split_listing(wide_only))


def test_count_split_raises_without_the_toolkit(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(edge_sass, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        edge_sass.count_split()


# the int8 instance in the integer domain: phase A loads a table entry
# and, through it, two totals (two edges), with minima VIMNMX and IMNMX,
# three an edge; phase B loads a table entry and, through it, two records
# (two edges), and adds the messages with IADD3 and a predicated pair
_I8_BODY = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.64 R10, [R3] ;
        /*0020*/                   IADD3 R2, R10, R40, RZ ;
        /*0030*/                   LDS.S8 R4, [R2] ;
        /*0040*/                   LDS.S8 R5, [R2+0x100] ;
        /*0050*/                   IADD3 R6, R4, -R7, RZ ;
        /*0060*/                   IABS R6, R6 ;
        /*0070*/                   VIMNMX R8, R8, R6, PT ;
        /*0080*/                   VIMNMX R9, R6, R9, !PT ;
        /*0090*/                   VIMNMX R14, R14, R9, PT ;
        /*00a0*/                   IMNMX R12, R12, R5, PT ;
        /*00b0*/                   IMNMX R13, R5, R13, !PT ;
        /*00c0*/                   IMNMX R15, R15, R13, PT ;
        /*00d0*/              @P0 BRA 0x10 ;
        /*00e0*/                   STS.128 [R2], R8 ;
        /*00f0*/                   LDS.128 R12, [R3+0x10] ;
        /*0100*/                   IADD3 R5, R12, R40, RZ ;
        /*0110*/                   LDS.128 R16, [R5] ;
        /*0120*/                   LDS.128 R24, [R13+0x10] ;
        /*0130*/                   SEL R20, R17, R18, P1 ;
        /*0140*/                   IADD3 R21, R21, R20, -R19 ;
        /*0150*/               @P2 IADD3 R22, R22, -R25, RZ ;
        /*0160*/              @!P2 IADD3 R22, R22, R25, RZ ;
        /*0170*/                   VIADD R30, R30, 0x1 ;
        /*0180*/                   IADD3 R3, R3, 0x10, RZ ;
        /*0190*/              @!P1 BRA 0xf0 ;
        /*01a0*/                   EXIT ;
"""


def test_int8_loops_count_integer_minima_and_table_loads():
    body = edge_sass.parse(f"\t\tFunction : {_I8}\n{_I8_BODY}")[_I8]
    res = edge_sass.edge_loops(body, integer=True)
    a, b = res["A"], res["B"]
    # the edges are the loads through the loop's table entry
    assert (a["mins"], a["fmnmx"], a["edges"]) == (6, 0, 2)
    assert a["instructions_per_edge"] == 6.5 and a["conversions"] == 0
    assert a["shared_per_edge"] == 1.5
    assert (b["dependent_loads"], b["edges"]) == (2, 2)
    assert b["shared_per_edge"] == 1.5 and b["instructions_per_edge"] == 5.5
    # read as a float instance, no add of phase B accumulates
    assert b["accumulating_adds"] == 0
    assert edge_sass.edge_loops(body)["B"] is None


def test_dependent_loads_follow_loaded_values():
    listing = """
        Function : k
        /*0000*/                   LDS.64 R4, [R2] ;
        /*0010*/                   IADD3 R6, R5, R3, RZ ;
        /*0020*/                   LDS.U16 R7, [R6+0x10] ;
        /*0030*/                   MOV R6, R3 ;
        /*0040*/                   LDS.U16 R8, [R6] ;
        /*0050*/                   LDS R9, [R7] ;
        /*0060*/              @P0 BRA 0x0 ;
"""
    body = edge_sass.parse(listing)["k"]
    # R6 holds a loaded value, then is overwritten from R3; R7 was loaded
    assert edge_sass.dependent_loads(body) == 2


_SP = "_ZN12_GLOBAL__N_113decode_kernelILi3EfLb0ELb0ELb0EEEvNS_4ArgsE"
_SPB = ("_ZN12_GLOBAL__N_113decode_kernelILi3E13__nv_bfloat16Lb0ELb0ELb0EEEv"
        "NS_4ArgsE")
# sum-product: an init loop (stores only), A1 (two phi of 2 MUFU: two
# edges, a store and a shared atomic), A2 (a sum: one edge), the
# iteration's __syncthreads_or, B1 (one phi: one edge), B2 (two sums a
# body: two edges) and a loop with a global load
_SP_BODY = """
        /*0000*/                   STS [R2], R3 ;
        /*0010*/              @P0 BRA 0x0 ;
        /*0020*/                   LDS R4, [R2] ;
        /*0030*/                   LDS R5, [R3] ;
        /*0040*/                   FADD R6, R4, -R5 ;
        /*0050*/                   MUFU.EX2 R7, R6 ;
        /*0060*/                   MUFU.RCP R8, R7 ;
        /*0070*/                   MUFU.EX2 R9, R6 ;
        /*0080*/                   MUFU.RCP R10, R9 ;
        /*0090*/               @P1 ATOMS.XOR RZ, [R11], R12 ;
        /*00a0*/                   STS [R3], R8 ;
        /*00b0*/              @P0 BRA 0x20 ;
        /*00c0*/                   LDS R4, [R2] ;
        /*00d0*/                   FADD R13, R13, |R4| ;
        /*00e0*/                   LOP3.LUT R14, R14, R4, RZ, 0xfc, !PT ;
        /*00f0*/              @P0 BRA 0xc0 ;
        /*0100*/                   BAR.RED.OR.DEFER_BLOCKING 0x0, P0 ;
        /*0110*/                   LDS.64 R4, [R2] ;
        /*0120*/                   LDS R5, [R3] ;
        /*0130*/                   MUFU.EX2 R7, R5 ;
        /*0140*/                   MUFU.RCP R8, R7 ;
        /*0150*/                   STS [R3], R8 ;
        /*0160*/              @P0 BRA 0x110 ;
        /*0170*/                   LDS R4, [R2] ;
        /*0180*/                   LDS R5, [R3] ;
        /*0190*/                   FADD R20, R20, R4 ;
        /*01a0*/                   FADD R21, R21, R5 ;
        /*01b0*/              @P0 BRA 0x170 ;
        /*01c0*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*01d0*/                   FADD R22, R22, R4 ;
        /*01e0*/              @P0 BRA 0x1c0 ;
        /*01f0*/                   EXIT ;
"""


def test_sum_product_loops_are_split_by_the_barrier():
    insns = edge_sass.parse(f"\t\tFunction : {_SP}\n{_SP_BODY}")[_SP]
    res = edge_sass.sum_product_loops(insns, phi_mufu=2)
    assert [(c["start"], c["phase"], c["edges"]) for c in res["loops"]] == [
        ("0x20", "A", 2), ("0xc0", "A", 1), ("0x110", "B", 1),
        ("0x170", "B", 2)]
    a, b = res["A"], res["B"]
    assert a["loops"] == 2 and b["loops"] == 2
    assert a["instructions_per_edge"] == 10 / 2 + 4 / 1
    assert a["shared_per_edge"] == 4 / 2 + 1 / 1      # the atomic is shared
    assert (a["phi_per_edge"], b["phi_per_edge"]) == (1, 1)
    assert b["instructions_per_edge"] == 6 / 1 + 5 / 2
    assert res["phi_per_edge"] == 2
    assert res["instructions_per_edge"] == pytest.approx(9 + 8.5)


def test_sum_product_keeps_an_unrolled_body_not_its_remainder():
    # A2's sum unrolled by two, and its remainder: only the first counts
    body = _SP_BODY.replace(
        "        /*00f0*/              @P0 BRA 0xc0 ;\n",
        "        /*00f0*/              @P0 BRA 0xc0 ;\n"
        "        /*00f4*/                   LDS R4, [R2] ;\n"
        "        /*00f8*/                   FADD R13, R13, R4 ;\n"
        "        /*00fc*/              @P0 BRA 0xf4 ;\n")
    insns = edge_sass.parse(f"\t\tFunction : {_SP}\n{body}")[_SP]
    res = edge_sass.sum_product_loops(insns, phi_mufu=2)
    assert len([c for c in res["loops"] if c["phase"] == "A"]) == 3
    assert res["A"]["loops"] == 2
    assert res["A"]["instructions_per_edge"] == 10 / 2 + 4 / 1


def test_sum_product_needs_the_barrier_and_both_phases():
    insns = edge_sass.parse(f"\t\tFunction : {_SP}\n{_SP_BODY}")[_SP]
    no_bar = [i for i in insns if i.op != "BAR"]
    with pytest.raises(RuntimeError, match="BAR.RED"):
        edge_sass.sum_product_loops(no_bar, phi_mufu=2)
    a_only = [i for i in insns if i.addr < 0x110]
    with pytest.raises(RuntimeError, match="phase B"):
        edge_sass.sum_product_loops(a_only, phi_mufu=2)


def test_analyse_sum_product_and_summary():
    listing = "".join(f"\t\tFunction : {n}\n{_SP_BODY}" for n in (_SP, _SPB))
    res = edge_sass.analyse_sum_product(listing, phi_mufu=2)
    assert set(res) == set(edge_sass.SUM_PRODUCT)
    line = edge_sass.summary({**edge_sass.analyse(_listing()),
                              "sum_product": res})
    assert "B5 int8: phase A 1.5 shared" in line
    assert ("B4 float32: phase A 3 shared (9 instructions, 1 phi) an edge, "
            "phase B 4 (8.5, 1 phi), 17.5 instructions and 2 phi in all"
            in line)
    with pytest.raises(RuntimeError, match="not in the listing"):
        edge_sass.analyse_sum_product(
            f"\t\tFunction : {_SP}\n{_SP_BODY}", phi_mufu=2)
