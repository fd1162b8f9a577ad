"""The PyTorch port imports no JAX: every ``immunostruct_tpu_torch`` module
imports in a fresh interpreter in which ``import jax`` fails, and neither
``jax`` nor the JAX package is loaded afterwards."""

import os
import pkgutil
import subprocess
import sys

import immunostruct_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, sys
sys.modules["jax"] = None            # any `import jax` now raises
for name in sys.argv[1:]:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m == "jax" and sys.modules[m] is not None
                or m.startswith("jax.") or m.startswith("immunostruct_tpu.")
                or m == "immunostruct_tpu")
assert not loaded, loaded
print("imported", len(sys.argv) - 1)
"""


def _modules():
    names = [immunostruct_tpu_torch.__name__]
    for info in pkgutil.walk_packages(immunostruct_tpu_torch.__path__,
                                      prefix="immunostruct_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    names = _modules()
    assert "immunostruct_tpu_torch.ops.mega" in names
    assert "immunostruct_tpu_torch.cli.serve" in names
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE, *names],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(names)}" in proc.stdout
