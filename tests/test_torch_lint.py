"""The lint gate (tools/lint.py) over the port: its package, its smoke
script and its example CLIs, which the gate's default targets leave out."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).parents[1]
PORT_TARGETS = ("gradslam_tpu_torch", "chip_smoke.py", "examples_torch")


def test_the_port_is_lint_clean():
    out = subprocess.run([sys.executable, str(REPO / "tools" / "lint.py"), *PORT_TARGETS],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1].endswith(" files, 0 problem(s)"), out.stdout
