"""The port's driver entry points against the repository's ``__graft_entry__.py``.

``dag_rider_tpu_torch/graft_entry.py`` on the CPU (the kernels' plain
torch versions), against the JAX package, all exact (uint8 and int32
arrays byte for byte, bool masks bit for bit):

- ``example_batch`` is the reference's ``_example_batch`` for the comb
  layout (4-bit and 8-bit) and the windowed one;
- ``entry(device="cpu")``'s ``fn(*args)`` is the reference ``entry()``'s
  ``fn`` under ``jax.jit``;
- ``dryrun_multichip(8, device="cpu")``'s round step (accept, commit,
  votes) is the JAX ``make_round_step(make_mesh(8), quorum=3)`` on the same
  numpy inputs (``tests/test_torch_parallel.py``'s shapes: the compile is
  shared), its MSM the JAX package's host ``g1_msm``, and its sharded and
  pipelined masks the JAX ``CPUVerifier``'s;
- without a card, ``entry()`` and ``dryrun_multichip(8)`` raise, and so
  does a mesh narrower than asked for.

One case needs the card (``cuda`` marker; it skips here): ``entry()``'s
step on the card equals its plain version, with exactly one
``tree_sum_xyzt`` and one ``finish_check`` launch. The JAX imports sit
inside the fixtures, so that case runs on a machine without JAX:

    python -m pytest tests/test_torch_entry.py -m cuda -p no:xdist --noconftest
"""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu_torch import graft_entry as G
from dag_rider_tpu_torch.verifier import cuda as vcuda


@pytest.mark.parametrize("comb, bits", [(True, "4"), (True, "8"), (False, "4")],
                         ids=["comb4", "comb8", "windowed"])
def test_example_batch_is_the_references_byte_for_byte(monkeypatch, comb, bits):
    import __graft_entry__ as ref

    monkeypatch.setenv("DAGRIDER_COMB_BITS", bits)
    _, want, want_vs = ref._example_batch(comb=comb)
    ver, got, vs = G.example_batch(comb=comb, device="cpu")
    assert ver.device == torch.device("cpu")
    assert len(got) == len(want) == (2 if comb else 9)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        assert g.tobytes() == w.tobytes()
    if comb:
        assert got[0].shape == ((16, 131) if bits == "4" else (16, 67))
    assert [v.signature for v in vs] == [v.signature for v in want_vs]
    assert [v.signing_bytes() for v in vs] == [v.signing_bytes() for v in want_vs]


@pytest.fixture(scope="module")
def jax_entry():
    import jax

    import __graft_entry__ as ref

    fn, args = ref.entry()
    return np.asarray(jax.jit(fn)(*args)), [np.asarray(a) for a in args[:2]]


def test_entry_equals_the_references_step(jax_entry):
    want, (u8, i32) = jax_entry
    fn, args = G.entry(device="cpu")
    assert fn is vcuda.device_verify_comb
    assert [tuple(a.shape) for a in args] == [(16, 131), (16, 23), (4 * 64 * 16, 88),
                                              (64 * 16, 88)]
    assert all(a.device.type == "cpu" for a in args)
    assert args[0].numpy().tobytes() == u8.tobytes() and args[1].numpy().tobytes() == i32.tobytes()
    got = fn(*args)
    assert got.dtype == torch.bool and (got.numpy() == want).all()
    assert got.tolist() == [True] * 8 + [False] * 8


def test_entry_takes_the_eight_bit_step(monkeypatch):
    monkeypatch.setenv("DAGRIDER_COMB_BITS", "8")
    ver, _, _ = G.example_batch(comb=True, device="cpu")
    assert ver._comb_fn() is vcuda.device_verify_comb8 and ver.u8_cols == 67


@pytest.fixture(scope="module")
def dryrun():
    return G.dryrun_multichip(8, device="cpu")


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's first path on the JAX package's 8 virtual CPU
    devices, on the dry run's numpy inputs, and its host oracles."""
    import jax.numpy as jnp

    import __graft_entry__ as ref
    from dag_rider_tpu.crypto import bls12381 as jbls
    from dag_rider_tpu.parallel.mesh import make_mesh
    from dag_rider_tpu.parallel.round_step import make_round_step
    from dag_rider_tpu.verifier.cpu import CPUVerifier

    verifier, args, vs = ref._example_batch(n_nodes=4, batch=16)
    rng = np.random.default_rng(0)
    strong_wave = rng.random((3, 4, 4)) < 0.8
    exists_r4 = np.ones(4, dtype=bool)
    step = make_round_step(make_mesh(8), quorum=3)
    accept, commit, votes = step(*(jnp.asarray(a) for a in args), jnp.asarray(strong_wave),
                                 jnp.asarray(exists_r4), jnp.int32(1))
    pts, acc = [], jbls.G1_GEN
    for _ in range(8):
        pts.append(acc)
        acc = jbls.g1_double(acc)
    return {
        "accept": np.asarray(accept), "commit": bool(commit), "votes": np.asarray(votes),
        "msm": jbls.g1_msm(list(range(3, 11)), pts),
        "mask": CPUVerifier(verifier.registry).verify_batch(vs),
    }


def test_dryrun_round_step_equals_jax(dryrun, jax_dryrun):
    assert dryrun["batch"] == 16 and dryrun["mesh"].startswith("Mesh(batch: cpu")
    assert (dryrun["accept"].numpy() == jax_dryrun["accept"]).all()
    assert dryrun["commit"] == jax_dryrun["commit"]
    assert (dryrun["votes"].numpy() == jax_dryrun["votes"]).all()
    assert int(dryrun["accept"].sum()) == 8


def test_dryrun_msm_and_masks_equal_the_references_oracles(dryrun, jax_dryrun):
    assert dryrun["msm_points"] == 8 and dryrun["msm"] == jax_dryrun["msm"]
    assert dryrun["comb_mask"] == dryrun["pipeline_mask"] == jax_dryrun["mask"] == [True] * 8
    assert (dryrun["async_shards"], dryrun["shard_batch"]) == (8, 2)


def test_no_card_and_no_cpu_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(Exception, match="no CUDA device"):
        G.entry()
    with pytest.raises(Exception, match="no CUDA device"):
        G.dryrun_multichip(8)
    with pytest.raises(Exception, match="no CUDA device"):
        G.main(["--dryrun-only", "--mesh", "virtual"])


def test_fewer_cards_than_asked_raises(monkeypatch):
    """On a machine with one card, the dry run over 8 without an explicit
    mesh raises (no clamp); a mesh of the wrong width raises too."""
    from dag_rider_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="8 devices asked for, 1 visible"):
        G.dryrun_multichip(8)
    with pytest.raises(ValueError, match="a mesh of 2 entries for a dry run over 8"):
        G.dryrun_multichip(8, mesh=M.make_mesh(2, device="cpu"))


@pytest.mark.cuda
def test_entry_on_the_card_equals_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    from dag_rider_tpu_torch.ops import cuda_group as CG

    fn, args = G.entry()
    assert all(a.is_cuda for a in args)
    want = fn(*(a.cpu() for a in args))
    torch.cuda.synchronize()
    CG.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    assert got.cpu().tolist() == want.tolist() == [True] * 8 + [False] * 8
    assert CG.LAUNCHES == {"padd_xx": 0, "tree_sum_xyzt": 1, "finish_check": 1, "pow22523": 0}
    assert CG.TABLE_LAUNCHES == {"key_tables": 0, "key_tables8": 0}
