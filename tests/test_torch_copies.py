"""The port's host modules are copies of the JAX package's, and stay so.

For each module that the port copied whole, its AST must equal the
reference module's once the docstrings are removed and the package name
``dag_rider_tpu_torch`` reads ``dag_rider_tpu``. Comments are not part of
the AST, so they may differ. The declared seams are the only other
allowed difference, and each is named here: ``scenarios._coin_factory``
and ``scenarios.run_scenario`` take a ``device`` keyword and pass it to
the coins, so ``device`` is taken out of those two functions' signatures
and calls before the comparison. The checkers' copies (``analysis/``) have
a declared seam of their own: strings that name the port's own root
script (``STRINGS``, mapped back before the comparison). ``OWN`` names
functions whose bodies are the port's own (none today: since the port
has its own ``jitpure`` and ``shapes``, the capture checkers, ``run_static``
and the runner's ``main`` are the reference's), each pinned by a test of
its behaviour in ``tests/test_torch_analysis.py``. The networked
deployment's copies (the gRPC transport, the blob bus, the sidecar, the
node and the cluster harness) have a fourth kind, ``BLOCKS``: a stretch of
the port's source that reads the reference's stretch before parsing. The
sidecar warms its backend up without the reference's XLA cache call, the
node builds the card's verifiers where the reference builds the TPU's,
hands its coin "host" where the reference hands it None and reads a
``sync_patience`` key (a socket committee needs more anti-entropy patience
than the simulator's default) and a ``net_batch`` key (the gRPC
transport's batch mode: its ``DeliverMany`` method, ``split_batch``, the
``batch_bytes`` outbox with ``flush``, which the node's pump calls), and
the cluster runner drops from its
restored proposal queue, and through the mempool's one added method
``Mempool.drop_committed`` from its pool, what its delivery log or hint
shows committed (the reference keeps it: a kill -9 rejoin then commits a
transaction twice); each is pinned by a test of its behaviour in
``tests/test_torch_node.py``, ``tests/test_torch_net.py`` and
``tests/test_torch_cluster.py``. The three command-line scripts
(``SCRIPTS``: ``dag_rider_tpu_torch/scripts/`` against the repository's
``scripts/``) declare their usage strings (``STRINGS``) and, as
``BLOCKS``, the imports and the ``JAX_PLATFORMS``/``sys.path`` lines the
port drops (it runs as a package module and has no JAX); ``obs_report``'s
capture mode forces its knob on through ``config.env_set``, a write the
registry validates, where the reference assigns ``os.environ``
(``tests/test_torch_scripts.py`` pins the behaviour). A copy cannot drift
unseen.
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
    # the frame auth and the degradation ladder
    "transport/auth.py": (),
    "verifier/resilient.py": (),
    "verifier/cpu.py": (),
    # the networked deployment
    "transport/net.py": (),
    "transport/blobbus.py": (),
    "verifier/sidecar.py": (),
    "node.py": (),
    **{f"cluster/{m}.py": () for m in (
        "__init__", "directory", "runner", "supervisor", "client", "audit")},
    # the checkers (driderlint)
    **{f"analysis/{m}.py": () for m in (
        "core", "allowlist", "knobs", "determinism", "oracle", "metricsreg", "events",
        "flow", "locks", "release", "ladder", "races", "__init__", "__main__")},
    # host modules that were already identical copies
    # the command-line scripts (their reference lives outside the package)
    **{m: () for m in ("scripts/cluster.py", "scripts/soak.py", "scripts/obs_report.py")},
    **{m: () for m in (
        "consensus/__init__.py", "consensus/dag_state.py", "consensus/invariants.py",
        "consensus/process.py", "core/__init__.py", "core/codec.py", "core/stack.py",
        "core/types.py", "crypto/ed25519.py", "crypto/threshold.py", "epoch/__init__.py",
        "epoch/manager.py", "obs/__init__.py", "obs/flight.py", "obs/recorder.py",
        "transport/__init__.py", "transport/base.py", "transport/memory.py",
        "transport/rbc.py", "utils/metrics.py", "utils/slog.py", "verifier/pipeline.py",
        "verifier/prep.py")},
}

#: module path -> {port string: reference string}, mapped back before the
#: comparison
STRINGS = {
    "analysis/core.py": {"chip_smoke.py": "bench.py"},
    "scripts/cluster.py": {"python -m dag_rider_tpu_torch.scripts.cluster": "scripts/cluster.py"},
}

#: the copies whose reference is the repository's, not the package's
SCRIPTS = ("scripts/cluster.py", "scripts/soak.py", "scripts/obs_report.py")

_JAX_CPU = 'os.environ.setdefault("JAX_PLATFORMS", "cpu")\n'
_SYS_PATH = "sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))\n"

#: module path -> functions whose bodies are the port's own (the signature
#: is still compared)
OWN: dict = {}

#: module path -> module-level names only the port defines or imports
OWN_NAMES: dict = {}

#: the batch mode's two methods on ``GrpcTransport`` (``transport/net.py``)
_NET_BATCH_METHODS = '''    def _many_stub(self, peer: int):
        """The DeliverMany stub on ``peer``'s current channel (rebuilt when
        the channel was recycled). ValueError when the channel went away
        in between, which the caller treats as a failed attempt."""
        self._stub(peer)
        with self._lock:
            chan = self._channels.get(peer)
            if chan is None:
                raise ValueError(f"no channel to peer {peer}")
            held = self._many_stubs.get(peer)
            if held is None or held[0] is not chan:
                held = (chan, chan.unary_unary(
                    _MANY_METHOD,
                    request_serializer=bytes,  # gRPC takes bytes, not _Batch
                    response_deserializer=_identity,
                ))
                self._many_stubs[peer] = held
            return held[1]

    def flush(self) -> None:
        """Batch mode: ship every peer's queued frames, in order, as
        DeliverMany RPCs of at most ``batch_bytes`` each (a larger frame
        goes alone). A no-op when batch mode is off. Called by the owner
        thread after each pump."""
        if self._outbox is None:
            return
        with self._lock:
            box, self._outbox = self._outbox, {}
        for peer, frames in box.items():
            parts, size = [], 0
            for frame in frames:
                if parts and size + 4 + len(frame) > self._batch_bytes:
                    self._send(peer, _Batch(b"".join(parts)), attempt=0)
                    parts, size = [], 0
                parts.append(struct.pack("<I", len(frame)) + frame)
                size += 4 + len(frame)
            if parts:
                self._send(peer, _Batch(b"".join(parts)), attempt=0)

'''

#: module path -> ((port source, reference source), ...): each port
#: stretch occurs exactly once and reads the reference's before parsing
BLOCKS = {
    "scripts/cluster.py": (
        ("import json\nimport shutil\n", "import json\nimport os\nimport shutil\n"),
        ("import threading\n\nfrom dag_rider_tpu_torch import config",
         f"import threading\n\n{_JAX_CPU}\n{_SYS_PATH}\nfrom dag_rider_tpu_torch import config"),
    ),
    "scripts/soak.py": ((
        "import time\n\nfrom dag_rider_tpu_torch import node",
        f"import time\n\n{_JAX_CPU}\nfrom dag_rider_tpu_torch import node",
    ),),
    "scripts/obs_report.py": (
        ("import json\nimport sys\nfrom typing import List, Optional\n",
         f"import json\nimport os\nimport sys\nfrom typing import List, Optional\n\n"
         f"{_JAX_CPU}{_SYS_PATH}"),
        ("""    from dag_rider_tpu_torch.config import env_set

    env_set("DAGRIDER_TRACE", "1")
""", """    os.environ["DAGRIDER_TRACE"] = "1"
"""),
    ),
    "verifier/sidecar.py": ((
        """        if hasattr(backend, "warmup"):
            if warmup:
""",
        """        if hasattr(backend, "warmup"):
            from dag_rider_tpu.utils.jaxcache import enable_persistent_cache

            enable_persistent_cache()
            if warmup:
""",
    ),),
    "node.py": ((
        """            from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
            from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline

            if kind == "sharded":
                from dag_rider_tpu_torch.parallel.mesh import mesh_from_env
                from dag_rider_tpu_torch.parallel.sharded_verifier import (
                    ShardedCUDAVerifier,
                )

                base = ShardedCUDAVerifier(reg, mesh_from_env())
            else:
                base = CUDAVerifier(reg)
""",
        """            from dag_rider_tpu.utils.jaxcache import enable_persistent_cache
            from dag_rider_tpu.verifier.pipeline import VerifierPipeline
            from dag_rider_tpu.verifier.tpu import TPUVerifier

            enable_persistent_cache()
            if kind == "sharded":
                from dag_rider_tpu.parallel.mesh import mesh_from_env
                from dag_rider_tpu.parallel.sharded_verifier import (
                    ShardedTPUVerifier,
                )

                base = ShardedTPUVerifier(reg, mesh_from_env())
            else:
                base = TPUVerifier(reg)
""",
    ), (
        """            sync_patience=int(cfg.get("sync_patience", 8)),
""",
        "",
    ), (
        """            msm = "host"
            msm_kind = cfg.get("coin_msm", "host")
""",
        """            msm = None
            msm_kind = cfg.get("coin_msm", "host")
""",
    ), (
        """
#: the largest DeliverMany RPC a node sends with "net_batch" on; gRPC's
#: default receive limit is 4 MiB
NET_BATCH_BYTES = 1 << 20
""",
        "",
    ), (
        """            batch_bytes=NET_BATCH_BYTES if cfg.get("net_batch") else 0,
""",
        "",
    ), (
        """        self.net.flush()
""",
        "",
    )),
    "transport/net.py": (
        ("""_SUBMIT_METHOD = f"/{_SERVICE}/Submit"
_MANY_METHOD = f"/{_SERVICE}/DeliverMany"
""", """_SUBMIT_METHOD = f"/{_SERVICE}/Submit"
"""),
        ("""

class _Batch(bytes):
    \"\"\"The body of one DeliverMany RPC: ``u32 length || frame`` entries.
    A type of its own so that a retry goes out as the batch it was.\"\"\"


def split_batch(body: bytes):
    \"\"\"The frames of a DeliverMany body, in order. A truncated entry (a
    Byzantine peer's malformed bytes) ends the list: what came before it
    is kept, the rest is dropped.\"\"\"
    frames, off = [], 0
    while off + 4 <= len(body):
        (size,) = struct.unpack_from("<I", body, off)
        off += 4
        if off + size > len(body):
            break
        frames.append(body[off:off + size])
        off += size
    return frames
""", ""),
        ("""        if handler_call_details.method == _MANY_METHOD:

            def many(request: bytes, context) -> bytes:
                for frame in split_batch(request):
                    self._sink(frame)
                return b"\\x01"

            return grpc.unary_unary_rpc_method_handler(
                many,
                request_deserializer=_identity,
                response_serializer=_identity,
            )
""", ""),
        ("""        log=None,
        batch_bytes: int = 0,
    ):
""", """        log=None,
    ):
"""),
        ("""        #: batch mode (module docstring): peer -> frames queued since the
        #: last flush; None when off
        self._batch_bytes = int(batch_bytes)
        self._outbox: Optional[Dict[int, list]] = {} if batch_bytes > 0 else None
        self._many_stubs: Dict[int, Tuple[grpc.Channel, Callable]] = {}
""", ""),
        (_NET_BATCH_METHODS, ""),
        ("""        if (
            self._outbox is not None
            and attempt == 0
            and not isinstance(payload, _Batch)
        ):
            with self._lock:
                self._outbox.setdefault(peer, []).append(payload)
            return
""", ""),
        ("""            stub = (
                self._many_stub(peer)
                if isinstance(payload, _Batch)
                else self._stub(peer)
            )
            fut = stub.future(payload, timeout=self._rpc_timeout_s)
""", """            fut = self._stub(peer).future(payload, timeout=self._rpc_timeout_s)
"""),
    ),
    "cluster/runner.py": (
        ("""        self._drop_committed_blocks()
        self._reinject()
""", """        self._reinject()
"""),
        ("""    def _drop_committed_blocks(self) -> None:
        \"\"\"Take out of the restored proposal queue every transaction a
        delivery log shows committed, before the pump (which owns the
        queue) starts: the queue is checkpointed with the node, and
        holds the same hazard as the mempool (see
        :meth:`Mempool.drop_committed`).\"\"\"
        committed = read_delivered_txs(self.files["delivery_log"])
        committed |= read_hint(self.files["delivered_hint"])
        queue = self.node.process.blocks_to_propose
        kept = []
        for block in queue:
            if isinstance(block, Block):
                txs = tuple(tx for tx in block.transactions if tx not in committed)
                if not txs:
                    continue
                if len(txs) < len(block.transactions):
                    block = Block(txs)
            kept.append(block)
        queue.clear()
        queue.extend(kept)

""", ""),
        ("""        covered |= read_hint(self.files["delivered_hint"])
        if self.node.mempool is not None:
            self.node.mempool.drop_committed(covered)
        try:""", """        covered |= read_hint(self.files["delivered_hint"])
        try:"""),
    ),
    "mempool/__init__.py": ((
        """
    def drop_committed(self, committed) -> int:
        \"\"\"Take out of the pool every pending transaction that
        ``committed`` (a set of payloads) holds, with its latency stamp;
        returns how many left. A node restored from a checkpoint can hold
        one that its previous incarnation proposed and the cluster
        committed; if it then jumps past that commit by state transfer it
        never delivers it itself, and would batch it a second time.\"\"\"
        with self._lock:
            gone = [e.tx for e in self.pool.pending() if e.tx in committed]
            for tx in gone:
                self.pool._remove(tx)
                self._inflight.pop(tx, None)
            return len(gone)
""", ""),
    ),
}


class _Normalise(ast.NodeTransformer):
    def __init__(self, seams, strings=None, own=(), own_names=()):
        self.seams = set(seams)
        self.in_seam = 0
        self.strings = strings or {}
        self.own = set(own)
        self.own_names = set(own_names)

    def _strip_docstring(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        self._strip_docstring(node)
        node.body = [
            st for st in node.body
            if not (isinstance(st, (ast.Assign, ast.AnnAssign)) and {
                t.id for t in (st.targets if isinstance(st, ast.Assign) else [st.target])
                if isinstance(t, ast.Name)} & self.own_names)
        ]
        return self.generic_visit(node)

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            for port, ref in self.strings.items():
                node.value = node.value.replace(port, ref)
        return node

    def visit_ImportFrom(self, node):
        if self.own_names:
            node.names = [a for a in node.names if a.name not in self.own_names]
        return node

    def visit_ClassDef(self, node):
        self._strip_docstring(node)
        return self.generic_visit(node)

    def _visit_function(self, node):
        self._strip_docstring(node)
        if node.name in self.own:
            node.body = [ast.Pass()]
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


def with_blocks(source: str, blocks=()) -> str:
    """``source`` with each declared port stretch read as the reference's;
    a stretch that is missing or occurs twice fails."""
    for port, ref in blocks:
        assert source.count(port) == 1, f"declared block occurs {source.count(port)} times"
        source = source.replace(port, ref)
    return source


def normalised(path: Path, seams=(), strings=None, own=(), own_names=(), blocks=()) -> str:
    tree = _Normalise(seams, strings, own, own_names).visit(
        ast.parse(with_blocks(path.read_text(), blocks), filename=str(path)))
    return ast.dump(tree).replace("dag_rider_tpu_torch", "dag_rider_tpu")


def test_the_normaliser_sees_a_drift():
    src = "def f(a, device=None):\n    '''doc'''\n    return g(a, device=device)\n"
    ref = "def f(a):\n    return g(a)\n"
    assert ast.dump(_Normalise(["f"]).visit(ast.parse(src))) == ast.dump(
        _Normalise(()).visit(ast.parse(ref)))
    drift = "def f(a):\n    return g(a + 1)\n"
    assert ast.dump(_Normalise(()).visit(ast.parse(drift))) != ast.dump(
        _Normalise(()).visit(ast.parse(ref)))


def test_the_normaliser_maps_only_declared_seams():
    """A declared string maps back, a declared own function's body and a
    declared own name drop out; anything else still differs."""
    def norm(src, **kw):
        return ast.dump(_Normalise((), **kw).visit(ast.parse(src)))

    ref = "from m import h\nX = 1\ndef f():\n    return 'bench.py'\ndef g():\n    return 1\n"
    port = ("from m import OWN, h\nX = 1\nOWN = 2\ndef f():\n    return 'chip_smoke.py'\n"
            "def g():\n    return OWN\n")
    seams = {"strings": {"chip_smoke.py": "bench.py"}, "own": ("g",), "own_names": ("OWN",)}
    assert norm(port, **seams) == norm(ref, own=("g",))
    assert norm(port, strings={"chip_smoke.py": "bench.py"}, own=("g",)) != norm(ref, own=("g",))
    assert norm(port.replace("return 'chip", "return 'a_chip"), **seams) != norm(ref, own=("g",))


def test_a_declared_block_maps_back_only_where_it_stands():
    ref = "def f():\n    x = None\n    return g(x)\n"
    port = "def f():\n    x = 'host'\n    return g(x)\n"
    block = (("    x = 'host'\n", "    x = None\n"),)
    assert ast.dump(ast.parse(with_blocks(port, block))) == ast.dump(ast.parse(ref))
    with pytest.raises(AssertionError):
        with_blocks(port.replace("'host'", "'device'"), block)
    with pytest.raises(AssertionError):
        with_blocks(port + port.replace("def f", "def h"), block)


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_port_module_is_a_copy(rel):
    port = ROOT / "dag_rider_tpu_torch" / rel
    ref = ROOT / rel if rel in SCRIPTS else ROOT / "dag_rider_tpu" / rel
    own = OWN.get(rel, ())
    assert normalised(port, COPIES[rel], STRINGS.get(rel), own, OWN_NAMES.get(rel, ()),
                      BLOCKS.get(rel, ())) == normalised(ref, own=own), (
        f"dag_rider_tpu_torch/{rel} differs from its reference {ref} beyond its imports "
        f"and declared seams {COPIES[rel]}")


def test_seams_take_the_device_keyword():
    import inspect

    from dag_rider_tpu_torch.consensus import scenarios

    for fn in (scenarios._coin_factory, scenarios.run_scenario):
        assert inspect.signature(fn).parameters["device"].default is None
