"""The port stands alone: importing every ``repro_torch`` module, or what
``chip_smoke.py`` imports, loads neither ``jax`` nor the JAX package
``repro``; importing builds no kernel."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
{extra}
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "repro") or n.startswith(("jax.", "jaxlib.", "repro.")))
assert not bad, bad
from repro_torch.kernels import build
assert build._lib is None
print(len(names))
"""


def _run(extra: str = "") -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", PROBE.format(extra=extra)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_port_modules_import_neither_jax_nor_repro():
    n = int(_run().split()[-1])
    # core, dg, kernels, runtime, configs, convert, device, models, parallel,
    # data, launch
    assert n >= 40


def test_chip_smoke_imports_neither_jax_nor_repro():
    _run(extra=f"sys.path.insert(0, {REPO!r}); import chip_smoke")


def test_port_sources_name_neither_jax_nor_repro():
    import repro_torch

    root = os.path.dirname(repro_torch.__file__)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            assert s != "import repro", (path, s)
            assert not s.startswith(("import jax", "from jax", "import repro.", "from repro.",
                                     "from repro import")), (path, s)
