"""The port's host modules are copies of the JAX package's, and stay so.

For each module that the port copied whole, its AST must equal the
reference module's once the docstrings are removed and the package name
``dag_rider_tpu_torch`` reads ``dag_rider_tpu``. Comments are not part of
the AST, so they may differ. The declared seams are the only other
allowed difference, and each is named here: ``scenarios._coin_factory``
and ``scenarios.run_scenario`` take a ``device`` keyword and pass it to
the coins, so ``device`` is taken out of those two functions' signatures
and calls before the comparison. A copy cannot drift unseen.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: module path (relative to each package) -> the functions of its declared
#: seams, whose ``device`` parameter and ``device=`` keywords are the
#: port's additions
COPIES = {
    "transport/faults.py": (),
    "consensus/adversary.py": (),
    "consensus/scenarios.py": ("_coin_factory", "run_scenario"),
    "mempool/pool.py": (),
    "mempool/admission.py": (),
    "mempool/batcher.py": (),
    "mempool/__init__.py": (),
    "mempool/loadgen.py": (),
    "transport/lanebus.py": (),
    "lanes/__init__.py": (),
    "utils/checkpoint.py": (),
    "obs/export.py": (),
    "obs/report.py": (),
    "crypto/dkg.py": (),
}


class _Normalise(ast.NodeTransformer):
    def __init__(self, seams):
        self.seams = set(seams)
        self.in_seam = 0

    def _strip_docstring(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        self._strip_docstring(node)
        return self.generic_visit(node)

    def visit_ClassDef(self, node):
        self._strip_docstring(node)
        return self.generic_visit(node)

    def _visit_function(self, node):
        self._strip_docstring(node)
        seam = node.name in self.seams
        if seam:
            args = node.args
            keep = [i for i, a in enumerate(args.args) if a.arg != "device"]
            n_def = len(args.defaults)
            first_def = len(args.args) - n_def
            args.defaults = [d for j, d in enumerate(args.defaults) if first_def + j in keep]
            args.args = [args.args[i] for i in keep]
            self.in_seam += 1
        self.generic_visit(node)
        if seam:
            self.in_seam -= 1
        return node

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Call(self, node):
        if self.in_seam:
            node.keywords = [k for k in node.keywords if k.arg != "device"]
        return self.generic_visit(node)


def normalised(path: Path, seams=()) -> str:
    tree = _Normalise(seams).visit(ast.parse(path.read_text(), filename=str(path)))
    return ast.dump(tree).replace("dag_rider_tpu_torch", "dag_rider_tpu")


def test_the_normaliser_sees_a_drift():
    src = "def f(a, device=None):\n    '''doc'''\n    return g(a, device=device)\n"
    ref = "def f(a):\n    return g(a)\n"
    assert ast.dump(_Normalise(["f"]).visit(ast.parse(src))) == ast.dump(
        _Normalise(()).visit(ast.parse(ref)))
    drift = "def f(a):\n    return g(a + 1)\n"
    assert ast.dump(_Normalise(()).visit(ast.parse(drift))) != ast.dump(
        _Normalise(()).visit(ast.parse(ref)))


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_port_module_is_a_copy(rel):
    port = ROOT / "dag_rider_tpu_torch" / rel
    ref = ROOT / "dag_rider_tpu" / rel
    assert normalised(port, COPIES[rel]) == normalised(ref), (
        f"dag_rider_tpu_torch/{rel} differs from dag_rider_tpu/{rel} beyond its imports "
        f"and declared seams {COPIES[rel]}")


def test_seams_take_the_device_keyword():
    import inspect

    from dag_rider_tpu_torch.consensus import scenarios

    for fn in (scenarios._coin_factory, scenarios.run_scenario):
        assert inspect.signature(fn).parameters["device"].default is None
