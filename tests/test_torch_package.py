"""The PyTorch port stands alone: importing all of it loads no JAX and
nothing of the JAX package.  The test process has both loaded, so the check
runs in a fresh interpreter."""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m == "repro" or m.startswith("repro."))
print(json.dumps({"imported": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    imported = set(report["imported"])
    for name in ("repro_torch.core.ops", "repro_torch.kernels.partition",
                 "repro_torch.kernels._build", "repro_torch.dataflow.exchange",
                 "repro_torch.dataflow.workflows"):
        assert name in imported
