"""Every port test file that runs torch pins torch's thread count: it imports
``tests/torch_threads.py``'s ``one_torch_thread`` or has an autouse fixture
of its own that calls ``torch.set_num_threads``. Under the suite's six
workers a file on torch's default threads waits on the others' cores, and
the suite outgrows its clock. The files are read, not imported."""

import ast
import glob
import os

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
PORT_FILES = sorted(glob.glob(os.path.join(TESTS, "test_torch_port_*.py")))


def runs_torch(tree: ast.Module) -> bool:
    """The source imports torch, the port's package or another port test
    module, at any depth."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        if any(n.split(".")[0] in ("torch", "immunostruct_tpu_torch")
               or n.startswith(("tests.test_torch_port_", "tests.torch_"))
               for n in names):
            return True
    return False


def _autouse(decorator: ast.expr) -> bool:
    return isinstance(decorator, ast.Call) and any(
        k.arg == "autouse" and isinstance(k.value, ast.Constant)
        and k.value.value is True for k in decorator.keywords)


def _sets_threads(fn: ast.FunctionDef) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "set_num_threads" for n in ast.walk(fn))


def pins_threads(tree: ast.Module) -> bool:
    """The module imports the shared fixture, or defines an autouse fixture
    that sets torch's thread count."""
    for node in tree.body:
        if (isinstance(node, ast.ImportFrom)
                and node.module == "tests.torch_threads"
                and any(a.name == "one_torch_thread" for a in node.names)):
            return True
        if (isinstance(node, ast.FunctionDef) and _sets_threads(node)
                and any(_autouse(d) for d in node.decorator_list)):
            return True
    return False


def test_there_are_port_files():
    assert len(PORT_FILES) > 30


@pytest.mark.parametrize("path", PORT_FILES, ids=os.path.basename)
def test_port_file_pins_torch_threads(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    if runs_torch(tree):
        assert pins_threads(tree), (
            f"{os.path.basename(path)} runs torch on its default threads: "
            "add `from tests.torch_threads import one_torch_thread  # noqa: "
            "F401`")


_HEAD = "import pytest\nimport torch\n"
_OWN = ("@pytest.fixture(autouse=True, scope='module')\n"
        "def _threads():\n    torch.set_num_threads(1)\n    yield\n")


@pytest.mark.parametrize("source,pinned", [
    (_HEAD + "def test_x():\n    pass\n", False),
    (_HEAD + _OWN.replace("autouse=True, ", ""), False),
    (_HEAD + "def helper():\n    torch.set_num_threads(1)\n", False),
    (_HEAD + "from tests.torch_threads import one_torch_thread\n", True),
    (_HEAD + _OWN, True),
], ids=["none", "not-autouse", "not-a-fixture", "shared", "own"])
def test_the_check_refuses_a_file_that_does_not_pin(source, pinned):
    tree = ast.parse(source)
    assert runs_torch(tree)
    assert pins_threads(tree) is pinned


@pytest.mark.parametrize("source", [
    "from tests.test_torch_port_train import _setup\n",
    "from tests import test_torch_port_train as t\n",
    "from tests import torch_parallel_ranks as ranks\n",
    "from immunostruct_tpu_torch.models import build_model\n",
])
def test_a_file_that_imports_the_port_runs_torch(source):
    assert runs_torch(ast.parse(source))


def test_a_file_without_torch_needs_no_pin():
    tree = ast.parse("import numpy\nfrom immunostruct_tpu import models\n"
                     "from tests.reference_impl import egnn_layer\n")
    assert not runs_torch(tree) and not pins_threads(tree)
