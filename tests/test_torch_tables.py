"""The comb key-table builds' entry points on the CPU.

``cuda_group.key_tables`` and ``key_tables8`` (and ``comb.build_key_tables``
and ``build_key_tables8`` over them) launch two kernels on a CUDA tensor,
the window bases and then the entries (``tests/test_torch_cuda.py`` holds
them to the plain build on the card). On a CPU tensor they run the plain
build and launch nothing. Here: their argument checks, the plain route,
and the plain builds against the JAX package's ``build_key_tables`` and
``build_key_tables8`` limb for limb, at the key counts of
``tests/test_torch_group.py`` (8 keys) and ``tests/test_torch_comb8.py``
(4 keys and the base point B), whose JAX programs the persistent
compilation cache already holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.ops import comb as JC
from dag_rider_tpu_torch.crypto import ed25519
from dag_rider_tpu_torch.ops import comb, cuda_group as CG, field as F
from dag_rider_tpu_torch.verifier.base import KeyRegistry
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

WRAPPERS = {4: CG.key_tables, 8: CG.key_tables8}
SHAPES = {4: (comb.WINDOWS, comb.ENTRIES), 8: (comb.WINDOWS8, comb.ENTRIES8)}


@pytest.fixture(scope="module")
def keys():
    """{bits: the affine limbs (x, y, t) of the keys built, int32 [n, 22]}:
    eight registry keys for the 4-bit build; the first four and B, as the
    8-bit verifier builds them, for the 8-bit build."""
    ver = CUDAVerifier(KeyRegistry.generate(8)[0], device="cpu")
    four = [np.ascontiguousarray(a) for a in (ver._a_x, ver._a_y, ver._a_t)]
    bx, by, _, bt = ed25519.B
    eight = [np.concatenate([a[:4], F.to_limbs(c)[None]]) for a, c in zip(four, (bx, by, bt))]
    return {4: four, 8: eight}


@pytest.fixture(scope="module")
def built(keys):
    """{bits: flat rows from the wrapper on CPU tensors, and the launches
    booked meanwhile}."""
    out = {}
    for bits, wrapper in WRAPPERS.items():
        CG.reset_launches()
        flat = wrapper(*(torch.from_numpy(a) for a in keys[bits]))
        out[bits] = (flat, {**CG.LAUNCHES, **CG.TABLE_LAUNCHES})
    return out


def _bad(case: str, good: torch.Tensor):
    """(a_x, a_y, a_t) with one defect, and the exception it raises."""
    if case == "dtype":
        return (good.long(), good, good), TypeError
    if case == "limbs":
        return (good[:, :21], good, good), ValueError
    if case == "one_dim":
        return (good[0], good[0], good[0]), ValueError
    if case == "key_counts":
        return (good, good[:2], good), ValueError
    if case == "no_keys":
        return (good[:0], good[:0], good[:0]), ValueError
    if case == "device":
        meta = good.to("meta")
        return (meta, meta, meta), ValueError
    assert case == "mixed_devices"
    return (good, good.to("meta"), good), ValueError


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize(
    "case", ["dtype", "limbs", "one_dim", "key_counts", "no_keys", "device", "mixed_devices"]
)
def test_key_table_wrappers_reject_bad_arguments(keys, bits, case):
    args, exc = _bad(case, torch.from_numpy(keys[bits][0]))
    CG.reset_launches()
    with pytest.raises(exc):
        WRAPPERS[bits](*args)
    assert not any(CG.TABLE_LAUNCHES.values())


@pytest.mark.parametrize("bits", [4, 8])
def test_cpu_build_takes_the_plain_route_and_launches_nothing(keys, built, bits):
    flat, launches = built[bits]
    assert not any(launches.values()), launches
    n, (windows, entries) = len(keys[bits][0]), SHAPES[bits]
    assert flat.shape == (n * windows * entries, 88) and flat.dtype == torch.int32
    plain = {4: comb.build_key_tables_plain, 8: comb.build_key_tables8_plain}[bits]
    assert torch.equal(flat, plain(*(torch.from_numpy(a) for a in keys[bits])).reshape(-1, 88))
    # the comb entry point is a view of the same rows
    build = {4: comb.build_key_tables, 8: comb.build_key_tables8}[bits]
    tables = build(*(torch.from_numpy(a) for a in keys[bits]))
    assert tables.shape == (n, windows, entries, 4, 22)
    assert torch.equal(tables.reshape(-1, 88), flat)


@pytest.mark.parametrize("bits", [4, 8])
def test_plain_builds_equal_jax_limb_for_limb(keys, built, bits):
    jax_build = {4: JC.build_key_tables, 8: JC.build_key_tables8}[bits]
    want = np.asarray(jax_build(*(jnp.asarray(a) for a in keys[bits])))
    assert want.shape == (len(keys[bits][0]), *SHAPES[bits], 4, 22)
    assert np.array_equal(built[bits][0].numpy(), want.reshape(-1, 88))
