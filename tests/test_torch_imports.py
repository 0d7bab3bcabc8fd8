"""The port imports no JAX and nothing of the JAX package.

Every ``.py`` file of ``dag_rider_tpu_torch/`` (and ``chip_smoke.py``,
which runs on a machine without JAX) is parsed with ``ast``; an import of
``jax``, ``jaxlib`` or ``dag_rider_tpu`` anywhere in it, lazy imports
inside functions included, fails its case. ``grpc`` is allowed: the
networked deployment (``transport/net.py``, ``transport/blobbus.py``,
``verifier/sidecar.py``, ``cluster/client.py``) imports it as the
reference does, and the card's machine has it. Then the consensus entry
point, the host modules (mempool, lanes, Byzantine suite, checkpoint,
trace export, DKG) and the node's key generation are imported and run, a
small cluster and a mempool-fronted one, in a fresh interpreter where JAX,
the JAX package and gRPC cannot be imported at all: the in-memory path
needs no gRPC. Last, the networked modules are imported, and a sidecar
answers a batch, in a fresh interpreter where only JAX and the JAX
package are blocked.

A completeness guard joins the file lists of the JAX package, the
repository's entry points (``__graft_entry__.py``, ``bench.py``) and its
``scripts/`` against the port: every one has a counterpart at the same
path in ``dag_rider_tpu_torch/`` (``__graft_entry__.py`` as
``graft_entry.py``, ``scripts/`` as the package's ``scripts/``), under one
of five declared renames, or is one of the two files named as the port
benchmark's own.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dag_rider_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dag_rider_tpu")
FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


#: reference module -> its port counterpart under another name
RENAMED = {
    "dag_rider_tpu/ops/pallas_field.py": "dag_rider_tpu_torch/ops/cuda_field.py",
    "dag_rider_tpu/ops/pallas_group.py": "dag_rider_tpu_torch/ops/cuda_group.py",
    "dag_rider_tpu/ops/pallas_group381.py": "dag_rider_tpu_torch/ops/cuda_group381.py",
    "dag_rider_tpu/verifier/tpu.py": "dag_rider_tpu_torch/verifier/cuda.py",
    "dag_rider_tpu/utils/jaxcache.py": "dag_rider_tpu_torch/utils/build.py",
}

#: reference files the port's benchmark takes on, not a bring-up slice
BENCHMARK_OWN = ("bench.py", "scripts/tpu_capture.sh")


def reference_files():
    pkg = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "dag_rider_tpu").rglob("*.py")
                 if "__pycache__" not in p.parts)
    scripts = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "scripts").iterdir()
                     if p.is_file())
    return pkg + ["__graft_entry__.py", "bench.py"] + scripts


def counterpart(rel: str) -> str:
    if rel in RENAMED:
        return RENAMED[rel]
    if rel == "__graft_entry__.py":
        return "dag_rider_tpu_torch/graft_entry.py"
    if rel.startswith("dag_rider_tpu/"):
        return "dag_rider_tpu_torch/" + rel[len("dag_rider_tpu/"):]
    return "dag_rider_tpu_torch/" + rel


def test_every_reference_module_has_a_counterpart():
    refs = reference_files()
    assert len(refs) > 100 and "scripts/cluster.py" in refs
    for rel in (*RENAMED, *BENCHMARK_OWN):
        assert rel in refs, f"a declared exception names {rel}, which is gone"
    for rel, port in RENAMED.items():  # a real rename: no module under the old name
        assert (ROOT / port).exists(), port
        assert not (ROOT / "dag_rider_tpu_torch" / rel.split("/", 1)[1]).exists(), rel
    missing = [rel for rel in refs
               if rel not in BENCHMARK_OWN and not (ROOT / counterpart(rel)).exists()]
    assert missing == [], f"no port counterpart for {missing}"


def test_the_guard_sees_what_it_must():
    assert forbidden("jax.numpy") and forbidden("jaxlib") and forbidden("dag_rider_tpu.config")
    assert not forbidden("grpc") and not forbidden("grpc.aio")
    assert not forbidden("dag_rider_tpu_torch.config") and not forbidden("numpy")
    tree = ast.parse("def f():\n    from dag_rider_tpu.ops import field\n    import jax\n")
    assert [m for m in imported_modules(tree) if forbidden(m)] == ["dag_rider_tpu.ops", "jax"]
    assert len(FILES) > 40


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in imported_modules(tree) if forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_simulator_runs_with_jax_blocked():
    code = textwrap.dedent(
        """
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "dag_rider_tpu", "grpc"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib", "dag_rider_tpu", "grpc"):
                del sys.modules[name]
        from dag_rider_tpu_torch import Config
        from dag_rider_tpu_torch.consensus.simulator import Simulation

        sim = Simulation(Config(n=4, coin="round_robin"), verifier="cpu")
        sim.submit_blocks(per_process=2)
        sim.run(max_messages=2000)
        sim.check_agreement()
        assert any(sim.deliveries)
        import dag_rider_tpu_torch.consensus.scenarios
        import dag_rider_tpu_torch.crypto.dkg
        import dag_rider_tpu_torch.lanes
        import dag_rider_tpu_torch.obs.export
        import dag_rider_tpu_torch.obs.report
        import dag_rider_tpu_torch.utils.checkpoint
        from dag_rider_tpu_torch.mempool import loadgen

        assert loadgen.smoke(n=4, seconds=0.5)["committed_tx"] > 0
        import dag_rider_tpu_torch.cluster.directory
        from dag_rider_tpu_torch import node

        assert node.load_keys(node.generate_keys(4, 2, seed="s"))[0].n == 4
        blocked = ("jax", "jaxlib", "dag_rider_tpu", "grpc")
        assert not [m for m in sys.modules if m.split(".")[0] in blocked]
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_networked_modules_run_with_jax_blocked():
    code = textwrap.dedent(
        """
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "dag_rider_tpu"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib", "dag_rider_tpu"):
                del sys.modules[name]
        import dataclasses

        import dag_rider_tpu_torch.cluster.audit
        import dag_rider_tpu_torch.cluster.runner
        import dag_rider_tpu_torch.cluster.supervisor
        import dag_rider_tpu_torch.transport.blobbus
        import dag_rider_tpu_torch.transport.net
        from dag_rider_tpu_torch.core.types import Vertex, VertexID
        from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
        from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
        from dag_rider_tpu_torch.verifier.sidecar import RemoteVerifier, VerifierSidecarServer

        reg, seeds = KeyRegistry.generate(2)
        vs = [VertexSigner(seeds[i]).sign_vertex(Vertex(id=VertexID(1, i))) for i in range(2)]
        server = VerifierSidecarServer(CPUVerifier(reg))
        try:
            remote = RemoteVerifier(server.address)
            forged = dataclasses.replace(vs[1], signature=bytes(64))
            assert remote.verify_batch(vs + [forged]) == [True, True, False]
            remote.close()
        finally:
            server.stop()
        blocked = ("jax", "jaxlib", "dag_rider_tpu")
        assert not [m for m in sys.modules if m.split(".")[0] in blocked]
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
