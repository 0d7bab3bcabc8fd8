"""The port's driver entry points: the flagship verify step and the
multi-card dry run.

Port twin of the repository root's ``__graft_entry__.py``:

- :func:`entry` hands back the flagship forward step, one DAG round's
  batched Ed25519 verification on the fixed-key comb path, as a callable
  with its example arguments on the card;
- :func:`dryrun_multichip` runs the reference's four multi-chip paths (the
  round step, ``ShardedMSM``, the sharded comb verifier, and the
  depth-2 verify pipeline over it) on a :class:`~dag_rider_tpu_torch.
  parallel.mesh.Mesh` and checks each.

The reference re-execs itself into a process with virtual CPU devices;
the port does not. Its mesh is what the caller asks for:
``device="cpu"`` gives a mesh of CPU entries (the tests), the default
spans the visible cards and raises when there are fewer than asked for,
and one card runs the dry run only through an explicit
``mesh=virtual_mesh(n)``. There is no quiet clamp and no quiet CPU path.

Run it as ``python -m dag_rider_tpu_torch.graft_entry`` (the flagship
step, then the dry run over 8 cards), with ``--dryrun-only`` for the dry
run alone, ``--mesh virtual`` for 8 entries of one card, and ``--device
cpu`` for the plain torch versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

#: the command's dry-run mesh width (the reference's ``dryrun_multichip(8)``)
DRYRUN_DEVICES = 8


def example_batch(
    n_nodes: int = 4,
    batch: int = 16,
    comb: bool = False,
    device: Optional[torch.device | str] = None,
):
    """A real prepared verify batch: ``batch // 2`` signed vertices of an
    ``n_nodes`` committee, padded to ``batch`` rows by the verifier's host
    prep. Returns ``(verifier, arrays, vertices)``.

    The keys are ``KeyRegistry.generate(n_nodes)``, which is deterministic,
    so the arrays are the reference's ``_example_batch`` byte for byte:
    ``comb=True`` gives the packed (u8 [batch, 131], i32 [batch, 23]) pair
    (u8 [batch, 67] under ``DAGRIDER_COMB_BITS=8``), the default the nine
    windowed arrays that the round step consumes. The prep is host work;
    ``device`` is where the verifier would dispatch (``cuda`` unless the
    caller names another)."""
    from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
    from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

    reg, seeds = KeyRegistry.generate(n_nodes)
    signers = [VertexSigner(s) for s in seeds]
    vs = []
    for j in range(batch // 2):
        i = j % n_nodes
        v = Vertex(
            id=VertexID(2 + j // n_nodes, i),
            block=Block((f"tx-{j}".encode(),)),
            strong_edges=tuple(VertexID(1 + j // n_nodes, s) for s in range(3)),
        )
        vs.append(signers[i].sign_vertex(v))
    verifier = CUDAVerifier(reg, comb=comb, device=device)
    return verifier, verifier._prepare(vs, batch), vs


def entry(device: Optional[torch.device | str] = None):
    """``(fn, example_args)``: the flagship forward step, one DAG round's
    batched Ed25519 verification dispatch on the fixed-key comb path.

    ``fn`` is ``verifier.cuda.device_verify_comb`` (``device_verify_comb8``
    under ``DAGRIDER_COMB_BITS=8``); the arguments are the two transfer
    arrays of :func:`example_batch` and the verifier's comb tables, on its
    device (``cuda`` unless the caller names ``"cpu"``; no card and no
    ``"cpu"`` raises). On a card ``fn(*args)`` launches
    ``tree_sum_xyzt_kernel`` and ``finish_kernel`` once each, and building
    the tables here launches ``key_bases_kernel`` and
    ``key_entries_kernel``; on CPU tensors ``fn`` runs their plain torch
    versions. The reference pins its ``impl="jnp"`` tree so that XLA can
    compile-check the step on any backend; the port has no such pin: the
    device of the arguments decides the route."""
    verifier, (u8, i32), _ = example_batch(comb=True, device=device)
    tables, b_tab = verifier.comb_tables()
    return verifier._comb_fn(), (verifier._put(u8), verifier._put(i32), tables, b_tab)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(
    n_devices: int,
    mesh=None,
    device: Optional[torch.device | str] = None,
) -> dict:
    """The reference's four multi-chip paths over an ``n_devices`` mesh,
    each checked; returns a record of what was checked and prints one
    ``dryrun_multichip OK: ...`` line.

    ``mesh`` defaults to ``make_mesh(n_devices)`` over the visible cards
    (raising when fewer are visible), or ``n_devices`` CPU entries with
    ``device="cpu"``; a given mesh must have ``n_devices`` entries.

    1. the round step (``make_round_step(mesh, quorum=3)``) on the
       windowed example batch and the seeded wave tensors; its accept mask
       must be ``CPUVerifier``'s over the batch's vertices, padding
       rejected;
    2. ``ShardedMSM(mesh)`` over ``n_devices`` doubled generators, equal to
       the host ``g1_msm``;
    3. ``ShardedCUDAVerifier`` on the comb path accepts every signature;
    4. a ``VerifierPipeline(sv, depth=2, warmup=True)`` over it: the warm-up
       dispatched the bucket once, a dispatch ran one shard on every mesh
       entry (the verifier's shard gauges), and the pipeline's mask is the
       synchronous one."""
    from dag_rider_tpu_torch.crypto import bls12381 as bls
    from dag_rider_tpu_torch.parallel.mesh import make_mesh
    from dag_rider_tpu_torch.parallel.msm import ShardedMSM
    from dag_rider_tpu_torch.parallel.round_step import make_round_step
    from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier
    from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
    from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline

    if mesh is None:
        kind = torch.device(device).type if device is not None else "cuda"
        mesh = make_mesh(n_devices, device=kind)
    if mesh.size != n_devices:
        raise ValueError(f"a mesh of {mesh.size} entries for a dry run over {n_devices}")

    n_nodes = 4
    batch = max(16, n_devices)
    if batch % n_devices:
        batch += n_devices - batch % n_devices
    step = make_round_step(mesh, quorum=3)
    example, args, vs = example_batch(n_nodes=n_nodes, batch=batch, device=mesh.devices[0])
    want = CPUVerifier(example.registry).verify_batch(vs)
    rng = np.random.default_rng(0)
    strong_wave = rng.random((3, n_nodes, n_nodes)) < 0.8
    exists_r4 = np.ones(n_nodes, dtype=bool)
    accept, commit, votes = step(*args, strong_wave, exists_r4, 1)
    _check(tuple(accept.shape) == (batch,), f"round step accept shape {tuple(accept.shape)}")
    _check(tuple(votes.shape) == (n_nodes,), f"round step votes shape {tuple(votes.shape)}")
    _check(accept.tolist() == want + [False] * (batch - len(vs)),
           "round step accept mask differs from CPUVerifier's")

    # second path: the sharded G1 MSM, one point per entry, against the
    # host group law
    pts: List[tuple] = []
    acc_pt = bls.G1_GEN
    for _ in range(n_devices):
        pts.append(acc_pt)
        acc_pt = bls.g1_double(acc_pt)
    ks = list(range(3, 3 + n_devices))
    got = ShardedMSM(mesh)(ks, pts)
    _check(got == bls.g1_msm(ks, pts), "sharded MSM diverged from the host oracle")

    # third path: the comb verify program (the flagship step) sharded
    # batch-parallel over the mesh, its key tables replicated per device
    sv = ShardedCUDAVerifier(example.registry, mesh, comb=True)
    comb_mask = sv.verify_batch(vs)
    _check(comb_mask == want and all(comb_mask),
           "sharded comb verify rejected a valid signature")

    # fourth path: the async seam over the mesh, warmed up at the bucket,
    # then dispatch/resolve through the depth-2 pipeline
    sv.fixed_bucket = batch
    pipe = VerifierPipeline(sv, depth=2, warmup=True)
    size = sv._round_bucket(batch)
    _check(sv._warm == {size}, f"sharded warmup dispatched {sorted(sv._warm)}, not {size}")
    pending = sv.dispatch_batch(vs)
    _check(sv.mesh_devices == mesh.size and sv.last_shard_batch * mesh.size == size
           and tuple(pending.mask.shape) == (size,),
           f"sharded dispatch did not span the mesh ({sv.mesh_devices} entries of "
           f"{sv.last_shard_batch} rows for {size})")
    _check(sv.resolve_batch(pending) == comb_mask, "sharded dispatch mask differs")
    pipe_mask = pipe.verify_batch(vs)
    _check(pipe_mask == comb_mask, "pipelined sharded mask differs from the sync mask")
    record = {
        "mesh": repr(mesh),
        "batch": batch,
        "accept": accept.cpu(),
        "commit": bool(commit),
        "votes": votes.cpu(),
        "msm": got,
        "msm_points": n_devices,
        "comb_mask": comb_mask,
        "pipeline_mask": pipe_mask,
        "async_shards": sv.mesh_devices,
        "shard_batch": sv.last_shard_batch,
    }
    print(
        f"dryrun_multichip OK: mesh={mesh!r}, batch={batch}, "
        f"accepted={int(accept.sum())}, commit={bool(commit)}, msm_points={n_devices}, "
        f"sharded_comb_verified={len(comb_mask)}, async_shards={sv.mesh_devices}"
    )
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    from dag_rider_tpu_torch.parallel.mesh import virtual_mesh

    ap = argparse.ArgumentParser(prog="python -m dag_rider_tpu_torch.graft_entry")
    ap.add_argument("--dryrun-only", action="store_true", help="run only the dry run")
    ap.add_argument(
        "--mesh", choices=("cards", "virtual"), default="cards",
        help="'cards': one entry a visible card (raises when fewer than 8 are visible); "
        "'virtual': 8 entries of one card",
    )
    ap.add_argument("--device", default=None, help="'cpu' for the plain torch versions")
    args = ap.parse_args(argv)
    if not args.dryrun_only:
        fn, fargs = entry(args.device)
        print("entry OK:", int(fn(*fargs).sum()))
    mesh = virtual_mesh(DRYRUN_DEVICES, args.device or "cuda") if args.mesh == "virtual" else None
    dryrun_multichip(DRYRUN_DEVICES, mesh=mesh, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
