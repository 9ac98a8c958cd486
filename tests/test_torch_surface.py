"""The port covers the JAX package: every module of ``ldpc_tpu/`` has a
module at the same path in ``ldpc_tpu_torch/``, every public name of it
resolves there, and both command lines have the same subcommands with the
same option strings.

The JAX package is read with ``ast`` and never imported.  What the port
does otherwise stands in one table, ``EXCEPTIONS``, each entry with its
reason."""

import argparse
import ast
import importlib
import pathlib

import pytest

from ldpc_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "ldpc_tpu"
PORT = ROOT / "ldpc_tpu_torch"

# A module path (relative to the package) or "module::name" of the JAX
# package -> (the port's files that stand for it, the reason).  A module
# entry's public names resolve on the first of its files; an entry with no
# files has no counterpart, and neither have the names a JAX package
# re-exports from it.
EXCEPTIONS = {
    "ops/pallas_static.py": (
        ("ops/cuda_static.py", "csrc/decode.cu"),
        "the fused Pallas decode kernel and its wrapper are a CUDA kernel "
        "and its ctypes wrapper with the plain PyTorch versions"),
    "ops/pallas_split.py": (
        ("ops/cuda_split.py", "csrc/split.cu"),
        "the phase-split Pallas pair and its wrapper are two CUDA kernels "
        "and their ctypes wrapper with the plain PyTorch versions"),
    "utils/device.py::on_tpu_hardware": (
        ("utils/device.py",),
        "it tells a real TPU from Pallas's interpret mode; in the port the "
        "device's type decides (utils/device.py::resolve_device)"),
    "utils/config.py": (
        (),
        "no entry point of either package reads load_config, so each of "
        "its LDPC_TPU_<SECTION>_<FIELD> settings would change nothing "
        "(left out since 470699d)"),
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _module_name(rel: str) -> str:
    parts = list(pathlib.PurePosixPath(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["ldpc_tpu_torch", *parts])


def _public_names(path: pathlib.Path) -> list[str]:
    """The module's ``__all__``, or else its public top-level defs and
    classes."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _reexported_from_nothing(rel: str) -> set[str]:
    """The names a JAX package's ``__init__`` imports from a module that
    EXCEPTIONS gives no counterpart."""
    if not rel.endswith("__init__.py"):
        return set()
    pkg = pathlib.PurePosixPath(rel).parent
    names = set()
    for node in ast.parse((JAX / rel).read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            src = str(pkg / (node.module.replace(".", "/") + ".py"))
            if EXCEPTIONS.get(src, (None,))[0] == ():
                names |= {a.asname or a.name for a in node.names}
    return names


def _resolve(module: str, name: str):
    """``getattr`` on the port's module; a package's sub-module is imported
    first, as ``from package import submodule`` would."""
    mod = importlib.import_module(module)
    if not hasattr(mod, name) and hasattr(mod, "__path__"):
        importlib.import_module(f"{module}.{name}")
    return getattr(mod, name)


@pytest.mark.parametrize("rel", _jax_modules())
def test_the_port_has_the_module_and_its_names(rel):
    names = _public_names(JAX / rel)
    if rel in EXCEPTIONS:
        files, _ = EXCEPTIONS[rel]
        assert not (PORT / rel).exists()
        for f in files:
            assert (PORT / f).is_file(), f
        if not files:
            return
        module = _module_name(files[0])
    else:
        assert (PORT / rel).is_file(), f"ldpc_tpu_torch/{rel} is missing"
        module = _module_name(rel)
    missing = []
    skipped = _reexported_from_nothing(rel)
    for name in names:
        if f"{rel}::{name}" in EXCEPTIONS or name in skipped:
            continue
        try:
            _resolve(module, name)
        except (AttributeError, ImportError):
            missing.append(name)
    assert not missing, f"{module} lacks {missing}"


@pytest.mark.parametrize("key", EXCEPTIONS)
def test_each_exception_names_what_the_jax_package_has(key):
    """An entry of the table names a JAX module or public name, the port
    lacks it under that name, and its stand-ins exist."""
    rel, _, name = key.partition("::")
    files, reason = EXCEPTIONS[key]
    assert (JAX / rel).is_file() and reason
    if name:
        assert name in _public_names(JAX / rel)
        assert not hasattr(importlib.import_module(_module_name(rel)), name)
    else:
        assert not (PORT / rel).exists()
    for f in files:
        assert (PORT / f).is_file(), f


def _jax_cli() -> dict[str, list[tuple[str, ...]]]:
    """Subcommand -> the option strings of each ``add_argument`` call, in
    order, read from the JAX package's cli.py."""
    tree = ast.parse((JAX / "cli.py").read_text())
    parsers, options = {}, {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "add_parser"):
            sub = node.value.args[0].value
            parsers[node.targets[0].id] = sub
            options[sub] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in parsers):
            options[parsers[node.func.value.id]].append(
                tuple(a.value for a in node.args))
    return options


def _port_cli() -> dict[str, list[tuple[str, ...]]]:
    """The same, read from the port's parser (help actions left out)."""
    parser = cli.build_parser()
    subs = next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))
    return {name: [tuple(a.option_strings) or (a.dest,)
                   for a in sub._actions
                   if not isinstance(a, argparse._HelpAction)]
            for name, sub in subs.choices.items()}


def test_both_clis_have_the_same_subcommands():
    assert sorted(_port_cli()) == sorted(_jax_cli())


@pytest.mark.parametrize("command", sorted(_jax_cli()))
def test_each_subcommand_has_the_same_option_strings(command):
    assert _port_cli()[command] == _jax_cli()[command]
