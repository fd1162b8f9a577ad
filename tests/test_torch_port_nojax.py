"""The PyTorch port imports no JAX and no pandas: every
``immunostruct_tpu_torch`` module imports in a fresh interpreter in which
``import jax`` (or ``import pandas``) fails, and neither ``jax`` nor the JAX
package is loaded afterwards. The card's machine has neither."""

import os
import pkgutil
import subprocess
import sys

import immunostruct_tpu_torch
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["pandas"] = None         # and so does `import pandas`
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


def _probe(names, *setup):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"     # one torch thread, as in the workers
    code = "\n".join([*setup, _PROBE])
    return subprocess.run([sys.executable, "-c", code, *names],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)


def test_every_module_imports_without_jax():
    names = _modules()
    for module in ("ops.mega", "ops.edge", "ops.segment", "ops.stack",
                   "ops.fused_layer", "cli.serve", "cli.train_IEDB_wFT",
                   "cli.train_Cancer_wFT", "cli.race_kernel_variants",
                   "cli.infer_IEDB_or_Cancer", "data.pipeline",
                   "procedures.infer", "utils.torch_import",
                   "cli.train_curriculum", "cli.infer_clinical_only",
                   "cli.featurize", "cli.convert_graphs", "cli.validate_data",
                   "procedures.clinical", "data.dedupe", "featurize.pdb",
                   "utils.export", "utils.quantize", "cli.export_model",
                   "featurize.edges", "featurize.builder", "featurize.native",
                   "data.device_pipeline", "data.device_augment",
                   "cli.common", "utils.flops", "utils.profiling",
                   "utils.attribution", "cli.profile_step",
                   "parallel.mesh", "parallel.collectives",
                   "parallel.trainer", "parallel.tensor",
                   "parallel.pipeline", "parallel.mp", "parallel.dryrun"):
        assert f"immunostruct_tpu_torch.{module}" in names
    proc = _probe(names)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(names)}" in proc.stdout


def test_the_learnability_script_runs_without_jax():
    """scripts/torch_geometric_signal.py, which chip_smoke.py imports by
    path on the card's machine: loaded and run on the CPU (its imports sit
    in its functions) with ``import jax`` and ``import pandas`` failing."""
    script = os.path.join(REPO, "scripts", "torch_geometric_signal.py")
    proc = _probe([], "import importlib.util, sys",
                  'sys.modules["jax"] = sys.modules["pandas"] = None',
                  f"spec = importlib.util.spec_from_file_location("
                  f"'torch_geometric_signal', {script!r})",
                  "module = importlib.util.module_from_spec(spec)",
                  "spec.loader.exec_module(module)",
                  "module.main(['--cpu', '--samples', '32', '--epochs', '1',"
                  " '--seeds', '0'])")
    assert proc.returncode == 0, proc.stderr
    assert "imported 0" in proc.stdout
    assert '"geometric_signal_recovered_by_structure_only"' in proc.stdout


def test_the_probe_refuses_a_pandas_import(tmp_path):
    """The probe fails a module that imports pandas."""
    (tmp_path / "uses_pandas.py").write_text("import pandas\n")
    proc = _probe(["uses_pandas"], "import sys",
                  f"sys.path.insert(0, {str(tmp_path)!r})")
    assert proc.returncode != 0 and "pandas" in proc.stderr
