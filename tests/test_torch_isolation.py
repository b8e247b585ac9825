"""The port and ``chip_smoke.py`` import neither ``jax`` nor ``repro``.

A subprocess blocks both (``sys.modules[name] = None`` makes any import of
them raise), then imports every module of ``repro_torch`` and
``chip_smoke.py`` (whose work sits under ``if __name__ == "__main__"``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every port test file)
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
                and sys.modules[n] is not None)
assert not leaked, leaked
print(len(mods), "modules")
"""


def test_port_imports_no_jax_and_no_repro():
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 20, res.stdout


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No CUDA card here: the script exits non-zero and prints no result,
    from the repository and from a directory holding only the script."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
