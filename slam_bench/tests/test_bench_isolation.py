"""Nothing the benchmark runs loads JAX or the JAX package: the check of a
run's loaded modules compares whole top-level names, and the benchmark's
sources import neither them, nor ``chip_smoke`` or ``tools``; the reference
imports nothing of the port either."""

import ast
import sys

from conftest import ROOT

from slam_bench import harness

BENCH = ROOT / "slam_bench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_loaded_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradslam_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    for name in ("jax", "jaxlib", "flax", "gradslam_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gradslam_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["gradslam_tpu.ops", "jax.numpy"]


def test_the_benchmark_imports_no_jax_and_no_tools():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "gradslam_tpu", "chip_smoke", "tools", "bench"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "gradslam_tpu", "gradslam_tpu_torch", "slam_bench"}
        assert not bad, (path, bad)
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level > 1:
                raise AssertionError(f"{path}: imports from outside the reference")
