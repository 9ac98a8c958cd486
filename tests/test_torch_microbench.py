"""Kernel B9, the kernel microbenchmark's probes (``ops/microbench.py``),
its script (``scripts/kernel_microbench.py`` of the port) and the phi
instruction count (``scripts/phi_sass.py``), against the JAX package on the
CPU.

The plain version ``probe_reference`` is held to the JAX script's
``_build_probe`` in interpret mode on the same tile (``input_tile``, the
JAX script's input), for each of the seven probe bodies, which are closures
inside the JAX script's ``main()`` and so are copied here verbatim:
- the sums of buffer 0 within 1e-4 of the sum of |values| of that buffer
  (the two sum in different orders: 169,457.53 against 169,455.77 for the
  mod-511 probe at K = 3);
- the final buffers exactly, through a copy of ``_build_probe`` whose
  output is the buffers instead of the sum.
The kernel's rotations, whose index arithmetic ``source_rows`` below
mirrors, equal ``pltpu.roll`` elementwise.  The kernel itself runs only on
the card (tests/test_torch_gpu.py).
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ldpc_tpu_torch.ops import microbench
from ldpc_tpu_torch.ops.microbench import (NAMES, PROBES, SHIFT, fill_tiles,
                                           input_tile, probe,
                                           probe_reference)
from ldpc_tpu_torch.scripts import kernel_microbench, phi_sass

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
K = 3            # runs of a body in the comparisons with JAX
SUM_RTOL = 1e-4  # of the sum of |values|: the sums' orders differ


def source_rows(name: str) -> np.ndarray:
    """The row that each output row of a rotating probe reads in the kernel,
    computed as ``csrc/microbench.cu``'s ``source_row`` computes it
    (``j = i + s; if (j >= z) j -= z``); the identity for the other
    probes."""
    body, _, rows, _ = PROBES[name]
    i = np.arange(rows)
    if body == 3:
        z, s = microbench.Z, SHIFT
    elif body in (1, 2):
        z, s = rows, rows - SHIFT
    else:
        return i
    j = i + s
    return np.where(j >= z, j - z, j)

# --- the JAX script's probe bodies, verbatim (scripts/kernel_microbench.py,
# main(), :112-151) ---------------------------------------------------------
Z, ZP, TB = 511, 512, 128
f32 = jnp.float32


def p_base(bufs, it):            # abs + add: the baseline pair
    return [jnp.abs(bufs[0]) + f32(0.1)]


def p_roll(bufs, it):            # baseline + 1 static roll
    return [pltpu.roll(jnp.abs(bufs[0]) + f32(0.1), 117, axis=0)]


def p_mod_rot(bufs, it):         # baseline + exact mod-511 rot
    x = jnp.abs(bufs[0]) + f32(0.1)
    a = pltpu.roll(x, ZP - 117, axis=0)
    b = pltpu.roll(x, Z - 117, axis=0)
    i_row = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    return [jnp.where(i_row < Z - 117, a, b)]


def p_bf16(bufs, it):            # baseline + f32->bf16->f32
    y = jnp.abs(bufs[0].astype(f32)) + f32(0.1)
    return [y.astype(jnp.bfloat16)]


def p_twomin_edge(bufs, it):     # phase-A per-edge fold (no rot)
    t, m1, m2 = bufs
    v = t - m1 * f32(0.5)
    a = jnp.abs(v)
    newmin = a < m1
    m2n = jnp.where(newmin, m1, jnp.minimum(m2, a))
    m1n = jnp.minimum(m1, a)
    return [jnp.where(v < 0, -t, t), m1n, m2n]


def p_recon(bufs, it):           # phase-B recon (no rot)
    m1, m2, am = bufs
    sgn = jnp.where(m1 > f32(1.0), -f32(1.0), f32(1.0))
    mag = jnp.where(am == f32(3.0), m2, m1)
    out = sgn * mag
    return [jnp.abs(out) + f32(0.1), m2, am]


BODIES = {"abs_add_baseline": p_base, "baseline+static_roll": p_roll,
          "baseline+static_roll_1024": p_roll,
          "baseline+mod511_rot": p_mod_rot, "baseline+f32_to_bf16": p_bf16,
          "twomin_edge_no_rot": p_twomin_edge, "recon_no_rot": p_recon}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_script():
    """The JAX package's scripts/kernel_microbench.py, loaded from its
    path."""
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_microbench", ROOT / "scripts" / "kernel_microbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_probe_buffers(body, n_iters, n_bufs, dtype, rows):
    """The JAX script's ``_build_probe`` with the VMEM buffers as its
    output instead of buffer 0's sum."""
    def kernel(x_ref, out_ref):
        def loop(it, _):
            bufs = [x_ref[i] for i in range(n_bufs)]
            outs = body(bufs, it)
            for i, o in enumerate(outs):
                x_ref[i] = o
            return 0

        jax.lax.fori_loop(0, n_iters, loop, 0, unroll=False)
        out_ref[...] = x_ref[...]

    @jax.jit
    def run(x):
        return pl.pallas_call(
            kernel,
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n_bufs, rows, TB), dtype),
        )(x)

    return run


def _tile(name, t=1, tiles=1):
    _, n_bufs, rows, dtype = PROBES[name]
    return input_tile(n_bufs, rows, dtype, t, tiles, device="cpu")


def _jax(x0: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(x0.float().numpy()).astype(JAX_DTYPE[x0.dtype])


@pytest.mark.parametrize("name", NAMES)
def test_probe_sum_matches_jax(jax_script, name):
    _, n_bufs, rows, dtype = PROBES[name]
    x = _tile(name)
    with pltpu.force_tpu_interpret_mode():
        got = jax_script._build_probe(BODIES[name], K, n_bufs,
                                      JAX_DTYPE[dtype], rows)(_jax(x[0]))
    want, bufs = probe_reference(name, x, K)
    scale = float(bufs[0, 0].float().abs().sum())
    assert abs(float(np.asarray(got)[0, 0]) - float(want[0])) <= \
        SUM_RTOL * scale


@pytest.mark.parametrize("name", NAMES)
def test_probe_buffers_match_jax_exactly(name):
    _, n_bufs, rows, dtype = PROBES[name]
    x = _tile(name, t=2)
    with pltpu.force_tpu_interpret_mode():
        got = _build_probe_buffers(BODIES[name], K + 1, n_bufs,
                                   JAX_DTYPE[dtype], rows)(_jax(x[0]))
    _, want = probe_reference(name, x, K + 1)
    assert want.dtype == dtype
    np.testing.assert_array_equal(np.asarray(got).astype(np.float32),
                                  want[0].float().numpy())


def _pallas_roll(x: np.ndarray, shift: int) -> np.ndarray:
    def kernel(x_ref, o_ref):
        o_ref[...] = pltpu.roll(x_ref[...], shift, 0)

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype))(x))


@pytest.mark.parametrize("name", ["baseline+static_roll",
                                  "baseline+static_roll_1024"])
def test_rotation_equals_pltpu_roll(name):
    rows = PROBES[name][2]
    x = np.random.default_rng(3).standard_normal((rows, TB)).astype(
        np.float32)
    want = _pallas_roll(x, 117)
    np.testing.assert_array_equal(x[source_rows(name)], want)
    np.testing.assert_array_equal(
        torch.roll(torch.from_numpy(x), 117, dims=-2).numpy(), want)


def test_mod511_gather_equals_the_two_rolls_and_select():
    """The kernel's one gather, (i + 117) mod 511 with row 511 reading row
    117, gives what the Pallas body's two rolls and select give."""
    x = np.random.default_rng(4).standard_normal((ZP, TB)).astype(
        np.float32)
    a, b = _pallas_roll(x, ZP - 117), _pallas_roll(x, Z - 117)
    want = np.where(np.arange(ZP)[:, None] < Z - 117, a, b)
    rows = source_rows("baseline+mod511_rot")
    np.testing.assert_array_equal(x[rows], want)
    assert rows[Z] == 117
    np.testing.assert_array_equal(rows[:Z], (np.arange(Z) + 117) % Z)


@pytest.mark.parametrize("name", ["baseline+static_roll",
                                  "baseline+static_roll_1024",
                                  "baseline+mod511_rot"])
def test_kernel_gather_gives_the_plain_version(name):
    """One run as the kernel computes it (gather row source_rows[i], then
    abs and add) equals the plain version's (abs and add, then the rolls)."""
    x = _tile(name, t=1, tiles=2)
    _, want = probe_reference(name, x, 1)
    got = x[:, :, source_rows(name)].abs() + 0.1
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [0, 3])
@pytest.mark.parametrize("name", ["abs_add_baseline", "baseline+f32_to_bf16",
                                  "twomin_edge_no_rot"])
def test_input_tile_is_the_jax_input(name, t):
    """The JAX script's x (``slope_ns``) plus the trial index (``_time``)."""
    _, n_bufs, rows, dtype = PROBES[name]
    jdt = JAX_DTYPE[dtype]
    shape = (n_bufs, rows, TB)
    x = (jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape) % 7
         - 3).astype(jdt)
    want = np.asarray((x + jnp.asarray(t, x.dtype)).astype(x.dtype))
    got = input_tile(n_bufs, rows, dtype, t, 1, device="cpu")
    assert got.dtype == dtype and got.shape == (1, *shape)
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_tiles_are_the_same_function(name):
    """G tiles at once give each tile's G = 1 result; the tiles differ."""
    x = _tile(name, t=1, tiles=3)
    assert not torch.equal(x[0], x[1])
    sums, bufs = probe_reference(name, x, 2)
    for g in range(3):
        s1, b1 = probe_reference(name, x[g:g + 1].contiguous(), 2)
        assert torch.equal(b1[0], bufs[g])
        assert torch.equal(s1[0], sums[g])


def test_probe_on_cpu_is_the_plain_version():
    before = dict(microbench.launches)
    for name in NAMES:
        x = _tile(name)
        got, want = probe(name, x, 2), probe_reference(name, x, 2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dict(microbench.launches) == before


def test_zero_runs_return_the_input():
    x = _tile("twomin_edge_no_rot")
    sums, bufs = probe_reference("twomin_edge_no_rot", x, 0)
    assert torch.equal(bufs, x)
    assert float(sums[0]) == float(x[0, 0].sum())


def test_probe_rejects_what_it_does_not_take():
    x = _tile("abs_add_baseline")
    with pytest.raises(ValueError, match="unknown probe"):
        probe("nope", x, 1)
    with pytest.raises(ValueError, match=r"x\[G, 3, 512, 128\]"):
        probe("twomin_edge_no_rot", x, 1)
    with pytest.raises(ValueError, match="1024"):
        probe("baseline+static_roll_1024", x, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        probe("baseline+f32_to_bf16", x, 1)
    with pytest.raises(ValueError, match="n_iters"):
        probe("abs_add_baseline", x, -1)
    with pytest.raises(ValueError, match="contiguous"):
        probe("abs_add_baseline", x.transpose(2, 3).contiguous()
              .transpose(2, 3), 1)
    with pytest.raises(ValueError, match="CUDA"):
        fill_tiles("abs_add_baseline", "cpu")


def test_ops_and_shared_bytes_tables():
    assert set(microbench.OPS_PER_ELEMENT) == set(NAMES)
    for name, (_, n_bufs, _, dtype) in PROBES.items():
        size = torch.empty((), dtype=dtype).element_size()
        read_write = 2 * n_bufs * size
        want = read_write - 2 * size if name == "recon_no_rot" else \
            read_write
        assert microbench.SMEM_BYTES_PER_ELEMENT[name] == want


def test_script_on_cpu(monkeypatch, capsys):
    """The probe script at tiny K on the CPU (the plain versions): one JSON
    line with the JAX keys, the tiled slopes, the decoder's slopes and the
    op-count model; no file written."""
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(kernel_microbench, "DECODER_TRIALS", 1)
    monkeypatch.setattr(kernel_microbench, "K_FULL", (2, 4))
    monkeypatch.setattr(kernel_microbench, "TILES", (1, 2))
    monkeypatch.setattr(kernel_microbench, "DECODER_WORDS", (2,))
    res = kernel_microbench.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res
    assert res["device"] == "cpu" and res["k"] == [2, 4]
    for name in NAMES:
        assert np.isfinite(res[name])
        assert res["fill"][name]["tiles"] == 2
    for store in ("bfloat16", "float32"):
        assert np.isfinite(res[f"decoder_us_per_iter_{store}_2"])
    assert np.isfinite(res["decoder_us_per_sweep_layered_bfloat16_2"])
    m = res["model"]
    assert m["words"] == 2 and m["edges_per_word"] == 32704
    assert set(m) >= {"measured_over_model_bfloat16",
                      "measured_over_model_float32"}


def test_decoder_keys_name_the_schedule():
    key = kernel_microbench.decoder_key
    assert key("bfloat16", 128) == "decoder_us_per_iter_bfloat16"
    assert key("float32", 32768) == "decoder_us_per_iter_float32_32768"
    assert (key("bfloat16", 128, "layered") ==
            "decoder_us_per_sweep_layered_bfloat16")
    assert (key("bfloat16", 32768, "layered") ==
            "decoder_us_per_sweep_layered_bfloat16_32768")


def test_script_writes_only_with_out(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    res = kernel_microbench.main(["--skip-decoder", "--skip-primitives"])
    assert list(tmp_path.iterdir()) == []
    assert res["k"] == [2000, 42000] and "model" not in res
    out = tmp_path / "r.json"
    res = kernel_microbench.main(["--quick", "--skip-decoder",
                                  "--skip-primitives", "--out", str(out)])
    assert res["k"] == [1000, 11000]
    assert json.loads(out.read_text()) == res


def test_op_count_model():
    fill = {n: {"ps_per_element": p} for n, p in (
        ("abs_add_baseline", 1.0), ("baseline+mod511_rot", 3.0),
        ("twomin_edge_no_rot", 5.0), ("recon_no_rot", 4.0))}
    res = {"fill": fill, "decoder_us_per_iter_float32_32768": 100.0}
    m = kernel_microbench.model(res)
    want = 32768 * 32704 * (2 * 2.0 + 5.0 + 4.0) / 1e6
    assert m["us_per_iter"] == pytest.approx(want)
    assert m["measured_over_model_float32"] == pytest.approx(100.0 / want)
    assert "measured_over_model_bfloat16" not in m


def test_phi_source_is_the_fused_kernel_phi():
    src = phi_sass.phi_source()
    assert src.startswith("__device__ __forceinline__ float phi(float x) {")
    assert "-logf(tanhf(x * 0.5f))" in src and src.endswith("}\n")


def test_sass_counts_parse_a_listing():
    listing = """
	code for sm_90a
		Function : copy_only
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   S2R R0, SR_TID.X ;       /* 0x0 */
        /*0020*/                   EXIT ;                   /* 0x0 */
        /*0030*/                   BRA 0x30;                /* 0x0 */
        /*0040*/                   NOP;                     /* 0x0 */
		Function : phi_only
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   FMUL R2, R0, 0.5 ;       /* 0x0 */
        /*0020*/               @!P0 MUFU.EX2 R3, R2 ;       /* 0x0 */
        /*0030*/                   FFMA.FTZ R3, R3, R2, R2 ; /* 0x0 */
        /*0040*/                   EXIT ;                   /* 0x0 */
        /*0050*/                   NOP;                     /* 0x0 */
"""
    counts = phi_sass.sass_counts(listing)
    assert dict(counts["copy_only"]) == {"LDC": 1, "S2R": 1, "EXIT": 1,
                                         "BRA": 1}
    assert dict(counts["phi_only"]) == {"LDC": 1, "FMUL": 1, "@MUFU": 1,
                                        "FFMA": 1, "EXIT": 1}
    # an FFMA counts 2, the predicated MUFU only among the special cases
    assert phi_sass.flops(counts["phi_only"]) == (3, 1)
    assert phi_sass.flops(counts["copy_only"]) == (0, 0)


def test_phi_count_raises_without_the_toolkit(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(phi_sass, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        phi_sass.count()
