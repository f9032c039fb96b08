"""The surface of ``examples_torch/``: one twin for every file of
``examples/`` (nine CLIs, two tutorial scripts, two notebooks), each with its
twin's flags and defaults plus ``--device`` (default ``cuda``), none
importing JAX or the JAX package, each refusing to run without a card
unless asked for the CPU, and the notebooks cell-for-cell twins with no
outputs whose code runs on the CPU.
"""

import ast
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.test_torch_example_clis import port_env

REPO = Path(__file__).parents[1]
JAX_EXAMPLES, PORT_EXAMPLES = REPO / "examples", REPO / "examples_torch"
SCRIPTS = sorted(str(p.relative_to(JAX_EXAMPLES)) for p in JAX_EXAMPLES.rglob("*.py"))
NOTEBOOKS = sorted(str(p.relative_to(JAX_EXAMPLES)) for p in JAX_EXAMPLES.rglob("*.ipynb"))
# the twins that keep --cpu as a spelling of --device cpu
CPU_FLAG = {"e2e_pipeline.py", "train_loopclosure_ate.py"}


def _flags(path):
    """{flag: default} of every ``parser.add_argument`` call in a script."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            default = next((ast.literal_eval(k.value) for k in node.keywords if k.arg == "default"), None)
            out[node.args[0].value] = default
    return out


def _imports(source):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def _code_cells(path):
    return ["".join(c["source"]) for c in json.loads(path.read_text())["cells"] if c["cell_type"] == "code"]


def test_every_example_has_a_twin():
    assert len(SCRIPTS) == 11 and len(NOTEBOOKS) == 2, (SCRIPTS, NOTEBOOKS)
    assert sorted(str(p.relative_to(PORT_EXAMPLES)) for p in PORT_EXAMPLES.rglob("*.py")) == SCRIPTS
    assert sorted(str(p.relative_to(PORT_EXAMPLES)) for p in PORT_EXAMPLES.rglob("*.ipynb")) == NOTEBOOKS


@pytest.mark.parametrize("script", SCRIPTS)
def test_flags_are_the_twins_plus_device(script):
    jax, port = _flags(JAX_EXAMPLES / script), _flags(PORT_EXAMPLES / script)
    assert port.pop("--device") == "cuda"
    assert port == jax
    assert ("--cpu" in port) == (Path(script).name in CPU_FLAG)


@pytest.mark.parametrize("name", SCRIPTS + NOTEBOOKS)
def test_imports_neither_jax_nor_the_jax_package(name):
    path = PORT_EXAMPLES / name
    sources = _code_cells(path) if name.endswith(".ipynb") else [path.read_text()]
    modules = [m for s in sources for m in _imports(s)]
    assert "gradslam_tpu_torch" in {m.split(".")[0] for m in modules}
    bad = [m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "gradslam_tpu")]
    assert not bad, bad


DEVICE_MESSAGE = "none is available; pass device='cpu'"


def _required_args(script, tmp_path):
    if "scannet" in script:
        return ["--scannet_path", str(tmp_path), "--scannet_meta_path", str(tmp_path)]
    return ["--dataset_path", str(tmp_path)] if script in ("pointfusion.py", "icpslam.py", "evaluate_ate.py") else []


@pytest.mark.parametrize("script", SCRIPTS)
def test_without_a_card_the_default_device_is_refused(script, tmp_path, monkeypatch):
    """No CPU fallback: with no card and no ``--device cpu`` the script's
    main raises the device message before any work (run in this process,
    the card hidden from ``torch``)."""
    path = PORT_EXAMPLES / script
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [str(path), *_required_args(script, tmp_path)])
    monkeypatch.setattr(sys, "path", list(sys.path))  # each script puts the repo on it
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=DEVICE_MESSAGE):
        runpy.run_path(str(path), run_name="__main__")
    assert list(tmp_path.iterdir()) == []


def test_a_cli_without_a_card_exits_nonzero(tmp_path):
    """The same refusal as a process of its own: a non-zero exit with the
    message, nothing printed."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(PORT_EXAMPLES / "pointfusion.py"), "--dataset_path", str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode != 0 and DEVICE_MESSAGE in out.stderr, out.stderr
    assert not out.stdout and list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("notebook", NOTEBOOKS)
def test_notebooks_are_cell_for_cell_twins_that_run(notebook):
    jax, port = (json.loads((root / notebook).read_text()) for root in (JAX_EXAMPLES, PORT_EXAMPLES))
    assert [c["cell_type"] for c in port["cells"]] == [c["cell_type"] for c in jax["cells"]]
    code = [c for c in port["cells"] if c["cell_type"] == "code"]
    assert all(c["outputs"] == [] and c["execution_count"] is None for c in code)
    source = "\n".join(_code_cells(PORT_EXAMPLES / notebook))
    assert source.count('DEVICE = "cuda"') == 1
    out = subprocess.run([sys.executable, "-c", source.replace('DEVICE = "cuda"', 'DEVICE = "cpu"')],
                         capture_output=True, text=True, cwd=(PORT_EXAMPLES / notebook).parent, env=port_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("ATE-RMSE:" if "pointfusion" in notebook else "frame cloud sizes:") in out.stdout
