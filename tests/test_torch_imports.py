"""What the port may import, and agreement between its Python functor
declarations and the CUDA sources (which are compiled only on the card's
machine, so their column counts are checked here by reading them)."""

import ast
import os
import re

import pytest

from pdp_solver_tpu_torch.ops import _build, fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pdp_solver_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "yaml", "torch.utils.cpp_extension",
             "pdp_solver_tpu")
# the one import of a forbidden module the port has: PyYAML inside
# utils/config.py load_yaml_config, which reads the shipped YAML configs
# and is on no path of the card (test_yaml_is_imported_lazily)
LAZY_YAML = os.path.join("pdp_solver_tpu_torch", "utils", "config.py")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _banned(name):
    return any(name == b or name.startswith(b + ".") for b in FORBIDDEN)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_yaml_or_jax_package(path):
    bad = {n for n in _imports(path) if _banned(n)}
    if os.path.relpath(path, ROOT) == LAZY_YAML:
        bad.discard("yaml")
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


# the training slice's modules, which the scan above must reach: the port
# keeps its own copies of the JAX package's numpy-only data modules
TRAINING_MODULES = ("fg/jsonfmt.py", "fg/generators.py", "fg/loader.py",
                    "train/loss.py", "train/checkpoint.py",
                    "train/trainer.py", "utils/training.py")


def test_scan_covers_the_training_modules():
    scanned = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert set(TRAINING_MODULES) <= scanned


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_import_torch_and_numpy_only(module):
    """Beyond the scan: the new modules import nothing outside the port,
    the standard library, numpy and torch."""
    import sys
    allowed = {"numpy", "torch", "pdp_solver_tpu_torch"}
    bad = {n for n in _imports(os.path.join(PKG, module))
           if n.split(".")[0] not in allowed
           and n.split(".")[0] not in sys.stdlib_module_names}
    assert not bad, bad


def test_yaml_is_imported_lazily():
    """utils/config.py imports yaml inside load_yaml_config only, never at
    module level, so importing the module (or any module that imports it)
    needs no PyYAML."""
    with open(os.path.join(ROOT, LAZY_YAML)) as f:
        tree = ast.parse(f.read())
    top = {a.name for node in tree.body if isinstance(node, ast.Import)
           for a in node.names}
    top |= {node.module for node in tree.body
            if isinstance(node, ast.ImportFrom)}
    assert not any(_banned(n) for n in top), top
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
              and node.name == "load_yaml_config")
    inner = {a.name for node in ast.walk(fn) if isinstance(node, ast.Import)
             for a in node.names}
    assert inner == {"yaml"}
    others = [node.name for node in tree.body
              if isinstance(node, ast.FunctionDef)
              and node.name != "load_yaml_config"
              and any(isinstance(n, (ast.Import, ast.ImportFrom))
                      for n in ast.walk(node))]
    assert not others, others


def test_cuda_sources_avoid_torch_headers():
    for path in _build.sources():
        with open(path) as f:
            assert "torch/extension.h" not in f.read(), path
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def _cuda_structs():
    """name -> {constant: value} for every functor struct in the sources."""
    out = {}
    for path in _build.sources():
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r"struct (\w+) \{(.*?)\n\};", src, re.S):
            body = m.group(2)
            name = re.search(r'return "(\w+)";', body)
            consts = re.search(r"static constexpr int ([^;]*);", body)
            if name and consts:
                vals = dict(re.findall(r"(\w+) = (\d+)", consts.group(1)))
                out[name.group(1)] = {k: int(v) for k, v in vals.items()}
    return out


def test_python_functors_match_cuda_functors():
    structs = _cuda_structs()
    for fn in fused.FUSED_FNS:
        c = structs[fn.name]
        side = {"none": 0, "var": 1}[fn.side]
        assert (c["SIDE"], c["NIN"], c["NR"], c["NE"]) == (
            side, len(fn.layout), fn.n_red, fn.n_eout), fn.name
    for fn in fused.CHAINED_FNS:
        c = structs[fn.name]
        assert (c["NIN"], c["NCRED"], c["NCOUT"], c["NBC"], c["NVRED"],
                c["NE"], c["NIRED"]) == (
            len(fn.layout), fn.n_cred, fn.n_cout, fn.n_bcast, fn.n_vred,
            fn.n_eout, fn.n_ired), fn.name
    registered = set()
    for path in _build.sources():
        with open(path) as f:
            for m in re.finditer(r"#define PDP_(FUSED|CHAINED)_FNS\(X\)(.*?)"
                                 r"\n\n", f.read(), re.S):
                registered |= set(re.findall(r"X\((\w+)\)", m.group(2)))
    assert len(registered) == len(fused.FUSED_FNS) + len(fused.CHAINED_FNS)
