"""The port's dense DAG kernels against the JAX package's, exactly.

Every device function of ``dag_rider_tpu_torch/ops/dag_kernels.py`` runs on
CPU tensors and is held against its JAX twin on the same numpy inputs: the
Figure-1 fixture (``tests/fixtures.py``) and three seeded random DAGs at
n = 16; the numpy twins against both. The reference cases of
``tests/test_dag_kernels.py`` (the reference's TestPath subtests and the
quorum, admission and wave-commit cases) run again on the port as cases of
one parametrised test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dag_rider_tpu.ops import dag_kernels as J
from dag_rider_tpu_torch.ops import dag_kernels as T
from fixtures import N, ROUNDS, figure1_tensors

DAGS = ["figure1", "random0", "random1", "random2"]


def _dag(name):
    """(exists [R, n], strong [R, n, n], weak [R, n, R, n]) as numpy bool."""
    if name == "figure1":
        return figure1_tensors()
    rng = np.random.default_rng(int(name[-1]))
    rounds, n = 6, 16
    exists = rng.random((rounds, n)) < 0.85
    strong = (rng.random((rounds, n, n)) < 0.4) & exists[:, :, None]
    strong[1:] &= exists[:-1][:, None, :]
    strong[0] = False
    weak = np.zeros((rounds, n, rounds, n), dtype=bool)
    for _ in range(6):
        r = int(rng.integers(2, rounds))
        weak[r, rng.integers(n), rng.integers(0, r - 1), rng.integers(n)] = True
    return exists, strong, weak


@pytest.fixture(scope="module", params=DAGS)
def dag(request):
    return _dag(request.param)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == np.bool_
    assert (port == ref).all()


def test_reach_chain(dag):
    _, strong, _ = dag
    for lo in (1, 2):
        stack = strong[lo:][::-1]  # top round first
        _eq(T.reach_chain(_t(stack)), J.reach_chain(jnp.asarray(stack)))
        _eq(T.reach_chain_np(stack), J.reach_chain(jnp.asarray(stack)))
    _eq(T.reach_chain(_t(strong[3:4])), J.reach_chain(jnp.asarray(strong[3:4])))


def test_round_complete(dag):
    exists, _, _ = dag
    for row in exists:
        for q in (1, 3, int(row.sum()), int(row.sum()) + 1):
            got = T.round_complete(_t(row), quorum=q)
            assert bool(got) == bool(J.round_complete(jnp.asarray(row), quorum=q))
            assert T.round_complete_np(row, quorum=q) == bool(got)


def test_admission_mask(dag):
    exists, strong, weak = dag
    r = exists.shape[0] - 1
    weak_pred = weak[r]  # [n, R, n]
    args = (strong[r], exists[r - 1], weak_pred, exists)
    want = J.admission_mask(*(jnp.asarray(a) for a in args))
    _eq(T.admission_mask(*(_t(a) for a in args)), want)
    _eq(T.admission_mask_np(*args), want)


def test_strong_edge_quorum(dag):
    _, strong, _ = dag
    for q in (1, 3, 6):
        want = J.strong_edge_quorum(jnp.asarray(strong[2]), quorum=q)
        _eq(T.strong_edge_quorum(_t(strong[2]), quorum=q), want)
        _eq(T.strong_edge_quorum_np(strong[2], quorum=q), want)


def test_wave_commit_votes(dag):
    exists, strong, _ = dag
    wave = strong[[4, 3, 2]]
    n = exists.shape[1]
    for leader in range(n):
        for q in (1, 3):
            jc, jv = J.wave_commit_votes(
                jnp.asarray(wave), jnp.asarray(exists[4]), jnp.int32(leader), quorum=q)
            tc, tv = T.wave_commit_votes(_t(wave), _t(exists[4]), leader, quorum=q)
            _eq(tv, jv)
            assert bool(tc) == bool(jc)
            host = T.reach_chain_np(wave)[:, leader] & exists[4]
            assert (tv.numpy() == host).all()


def test_leader_reach(dag):
    _, strong, _ = dag
    stack = strong[[4, 3, 2, 1]]
    for hi in range(stack.shape[1]):
        want = J.leader_reach(jnp.asarray(stack), jnp.int32(hi))
        _eq(T.leader_reach(_t(stack), hi), want)
        _eq(T.leader_reach(_t(stack), torch.tensor(hi)), want)
        _eq(T.leader_reach_np(stack, hi), want)


def test_closure_from(dag):
    _, strong, _ = dag
    rounds, n = strong.shape[:2]
    for r in range(rounds):
        for i in range(0, n, max(1, n // 4)):
            seeds = np.zeros((rounds, n), dtype=bool)
            seeds[r, i] = True
            _eq(T.closure_from(_t(seeds), _t(strong)),
                J.closure_from(jnp.asarray(seeds), jnp.asarray(strong)))


def test_closure_from_full(dag):
    _, strong, weak = dag
    rounds, n = strong.shape[:2]
    for r in range(rounds):
        seeds = np.zeros((rounds, n), dtype=bool)
        seeds[r, :: max(1, n // 3)] = True
        _eq(T.closure_from_full(_t(seeds), _t(strong), _t(weak)),
            J.closure_from_full(jnp.asarray(seeds), jnp.asarray(strong), jnp.asarray(weak)))


def test_pairwise_reach(dag):
    _, strong, _ = dag
    _eq(T.pairwise_reach(_t(strong)), J.pairwise_reach(jnp.asarray(strong)))


# -- the reference cases of tests/test_dag_kernels.py, on the port -----------


def _path(frm, to, strong_only):
    _, strong, weak = figure1_tensors()
    seeds = torch.zeros((ROUNDS, N), dtype=torch.bool)
    seeds[frm] = True
    if strong_only:
        reached = T.closure_from(seeds, _t(strong))
    else:
        reached = T.closure_from_full(seeds, _t(strong), _t(weak))
    return bool(reached[to])


def _case(name):
    exists, strong, _ = figure1_tensors()
    s = _t(strong)
    if name == "strong_path_consecutive_rounds":
        return _path((3, 0), (2, 2), True)
    if name == "strong_path_separated_by_two_rounds":
        return _path((3, 2), (1, 3), True)
    if name == "weak_path":
        return _path((4, 0), (2, 3), False)
    if name == "hybrid_path":
        return _path((4, 0), (1, 0), False)
    if name == "no_path_exists":
        return not _path((3, 2), (2, 3), False)
    if name == "reach_chain_single_hop":
        return T.reach_chain(s[3:4])[0].tolist() == [True, False, True, False]
    if name == "reach_chain_two_hops":
        reach = T.reach_chain(s[[3, 2]])
        return bool(reach[2].all()) and reach[0].tolist() == [True] * 4
    if name == "round_complete":
        return bool(T.round_complete(torch.tensor([1, 1, 1, 0]).bool(), quorum=3)) and not bool(
            T.round_complete(torch.tensor([1, 1, 0, 0]).bool(), quorum=3))
    if name == "strong_edge_quorum":
        pred = torch.tensor([[1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]]).bool()
        return T.strong_edge_quorum(pred, quorum=3).tolist() == [True, False, True]
    if name == "admission_mask":
        ex = exists.copy()
        ex[3, :] = [True, False, True, True]
        pred = torch.tensor([[True, True, False, False], [True, False, True, True]])
        weak_pred = torch.zeros((2, ROUNDS, N), dtype=torch.bool)
        weak_pred[1, 1, 2] = True
        first = T.admission_mask(pred, _t(ex[3]), weak_pred, _t(ex)).tolist()
        ex[1, 2] = False
        second = T.admission_mask(pred, _t(ex[3]), weak_pred, _t(ex)).tolist()
        return first == [False, True] and second == [False, False]
    if name == "wave_commit_votes":
        commit, votes = T.wave_commit_votes(s[[4, 3, 2]], _t(exists[4]), 0, quorum=3)
        commit1, _ = T.wave_commit_votes(s[[4, 3, 2]], _t(exists[4]), 0, quorum=1)
        return not bool(commit) and votes.tolist() == [True, False, False, False] and bool(commit1)
    if name == "leader_reach":
        return T.leader_reach(s[[3, 2]], 0).tolist() == [True] * 4
    if name == "closure_from_genesis_anchoring":
        ok = True
        for i in range(N):
            seeds = torch.zeros((ROUNDS, N), dtype=torch.bool)
            seeds[1, i] = True
            ok &= T.closure_from(seeds, s)[0].tolist() == [True, True, True, False]
        return ok
    if name == "closure_matches_pairwise_chain":
        chains = T.pairwise_reach(s)
        ok = True
        for r in range(ROUNDS):
            for i in range(N):
                seeds = torch.zeros((ROUNDS, N), dtype=torch.bool)
                seeds[r, i] = True
                ok &= bool((T.closure_from(seeds, s)[0] == chains[r][i]).all())
        return ok
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "strong_path_consecutive_rounds", "strong_path_separated_by_two_rounds", "weak_path",
    "hybrid_path", "no_path_exists", "reach_chain_single_hop", "reach_chain_two_hops",
    "round_complete", "strong_edge_quorum", "admission_mask", "wave_commit_votes",
    "leader_reach", "closure_from_genesis_anchoring", "closure_matches_pairwise_chain",
])
def test_reference_case_on_the_port(name):
    assert _case(name)
