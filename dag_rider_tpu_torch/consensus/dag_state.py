"""Host-side DAG state with dense numpy mirrors.

The port's copy of ``dag_rider_tpu/consensus/dag_state.py``.

The authoritative per-process DAG. Replaces the reference's
``dag [][]vertex`` array-of-rounds plus linear scans
(``process/process.go:76, 374-384``) with:

- a ``(round, source) -> Vertex`` map for payload access, and
- dense boolean mirrors ``exists[R, n]`` / ``strong[R, n, n]`` — the exact
  tensors the device kernels (:mod:`dag_rider_tpu_torch.ops.dag_kernels`) consume,
  so shipping a round/wave to the TPU is a zero-copy slice, and the dense
  encoding doubles as the checkpoint format (SURVEY.md §5: the reference has
  no serialization at all).

Weak edges are kept sparse host-side (they are rare and round-skipping);
ordering/reachability queries use vectorized frontier propagation over the
dense mirrors + sparse weak lists — O(rounds * n) bitmap work per query
instead of the reference's per-edge full-DAG scans.

Memory bounding: the reference grows its DAG forever
(``process.go:72-85``) and so did rounds 1-3 here. :meth:`prune_below`
retires everything under a caller-chosen floor — dense rows shift down so
row index = ``round - base_round``, vertices/weak entries are dropped, and
the window's capacity is reused instead of doubling forever. All public
methods keep speaking ABSOLUTE round numbers; with ``base_round == 0``
(pruning disabled, the default) every code path is bit-identical to the
unbounded behavior. The *policy* for choosing the floor (the deterministic
GC/ordering-exclusion rule that makes pruning safe across processes) lives
in the Process.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from dag_rider_tpu_torch.config import Config
from dag_rider_tpu_torch.core.types import Vertex, VertexID


class DagState:
    """One process's view of the DAG (rounds x sources)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.n = cfg.n
        self._capacity = max(cfg.max_rounds, 8)
        #: absolute round of dense row 0; rounds below are retired.
        self.base_round = 0
        self.exists = np.zeros((self._capacity, self.n), dtype=bool)
        self.strong = np.zeros((self._capacity, self.n, self.n), dtype=bool)
        #: dense mirror of ``weak``'s key set: has_weak[row, src] is True
        #: iff weak[(base+row, src)] exists. Weak edges are rare, and the
        #: closure sweeps were paying a dict probe per ACTIVE source per
        #: round (~1M probes per n=256 bench window) to discover that.
        self.has_weak = np.zeros((self._capacity, self.n), dtype=bool)
        # weak[(r, i)] -> tuple of (r2, j) targets, r2 < r-1 (absolute).
        self.weak: Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]] = {}
        self.vertices: Dict[VertexID, Vertex] = {}
        #: per-round {source: Vertex} mirror of `vertices` (fast
        #: round_size / vertices_in_round without dense-row scans)
        self._round_vertices: Dict[int, Dict[int, Vertex]] = {}
        self.max_round = 0
        #: lowest round inserted since the owner last consumed this marker
        #: (consumer: Process._weak_edges_for's truncated sweep — 0 means
        #: "sweep everything", the cold-start/restore-safe default).
        self.insert_min_round = 0
        #: vertices dropped by prune_below (metrics/tests)
        self.pruned_count = 0

    def reset(self) -> None:
        """Empty every mirror (used by checkpoint restore before
        re-inserting in round order — keeps the mirrors' consistency
        logic in one place instead of field-poking from callers)."""
        self.vertices.clear()
        self._round_vertices.clear()
        self.exists[:] = False
        self.strong[:] = False
        self.has_weak[:] = False
        self.weak.clear()
        self.base_round = 0
        self.max_round = 0
        self.insert_min_round = 0
        self.pruned_count = 0

    # -- growth / retirement ----------------------------------------------

    def _ensure_capacity(self, rnd: int) -> None:
        row = rnd - self.base_round
        if row < self._capacity:
            return
        new_cap = self._capacity
        while new_cap <= row:
            new_cap *= 2
        exists = np.zeros((new_cap, self.n), dtype=bool)
        strong = np.zeros((new_cap, self.n, self.n), dtype=bool)
        has_weak = np.zeros((new_cap, self.n), dtype=bool)
        exists[: self._capacity] = self.exists
        strong[: self._capacity] = self.strong
        has_weak[: self._capacity] = self.has_weak
        self.exists, self.strong, self.has_weak = exists, strong, has_weak
        self._capacity = new_cap

    def prune_below(self, floor: int) -> int:
        """Retire every vertex with ``round < floor``; returns the count.

        Dense rows shift down in place (capacity is *reused*, so a pruned
        long-running DAG stops growing), vertex payloads and weak entries
        below the floor are dropped, and ``base_round`` becomes ``floor``.
        Callers own the safety argument — the Process only passes floors
        under its deterministic ordering-exclusion horizon (cfg.gc_depth),
        below which no delivery can ever happen at any correct process.
        """
        if floor <= self.base_round:
            return 0
        floor = min(floor, self.max_round + 1)
        shift = floor - self.base_round
        live = self._capacity - shift
        if live > 0:
            # .copy(): numpy overlapping slice assignment is not defined
            self.exists[:live] = self.exists[shift:].copy()
            self.strong[:live] = self.strong[shift:].copy()
            self.has_weak[:live] = self.has_weak[shift:].copy()
        self.exists[max(live, 0) :] = False
        self.strong[max(live, 0) :] = False
        self.has_weak[max(live, 0) :] = False
        removed = 0
        for r in [r for r in self._round_vertices if r < floor]:
            for v in self._round_vertices.pop(r).values():
                del self.vertices[v.id]
                removed += 1
        for key in [k for k in self.weak if k[0] < floor]:
            del self.weak[key]
        self.base_round = floor
        if self.max_round < floor:
            self.max_round = floor
        if self.insert_min_round < floor:
            self.insert_min_round = floor
        self.pruned_count += removed
        return removed

    # -- mutation ----------------------------------------------------------

    def insert(self, v: Vertex) -> None:
        """Add a vertex whose predecessors are already present.

        Admission policy (who may call this, and when) lives in the Process;
        this container only maintains the mirrors.
        """
        vid = v.id
        r, s = vid.round, vid.source
        if r < self.base_round:
            raise ValueError(f"vertex {vid} is below the pruned floor")
        self._ensure_capacity(r)
        if vid in self.vertices:
            raise ValueError(f"vertex {vid} already present")
        sr, ss, wr, ws = v.edge_arrays()
        # The admission gate (Process.on_message) already proved the edge
        # rounds for vertices that passed it — its memo on the vertex
        # skips the redundant re-scan on this hot path.
        g = v.__dict__.get("_gate")
        if (g is None or g[1]) and sr.size and (sr != r - 1).any():
            raise ValueError(
                f"strong edges from {vid} must target round {r - 1}"
            )
        self.vertices[vid] = v
        rv = self._round_vertices.get(r)
        if rv is None:
            rv = self._round_vertices[r] = {}
        rv[s] = v
        row = r - self.base_round
        self.exists[row, s] = True
        # one fancy-index write instead of ~2f+1 numpy scalar stores
        self.strong[row, s, ss] = True
        if wr.size:
            self.weak[(r, s)] = tuple(zip(wr.tolist(), ws.tolist()))
            self.has_weak[row, s] = True
        if r > self.max_round:
            self.max_round = r
        if r < self.insert_min_round:
            self.insert_min_round = r

    def insert_many(
        self,
        vs: List[Vertex],
        trusted: bool = False,
        prepped: Optional[tuple] = None,
    ) -> None:
        """Batch :meth:`insert` for vertices of ONE round.

        The vectorized drain admits whole per-round groups at once; this
        pays the dense-mirror bookkeeping (capacity check, row lookup,
        fancy-index writes) once per *group* instead of once per vertex,
        and the dict mirrors land as C-level bulk ``update`` calls — the
        interpreted per-vertex stores were ~40% of this method in the
        n=256 profile. By default it validates the whole batch before
        mutating anything, so a bad vertex leaves the mirrors untouched.
        ``trusted=True`` skips that pass: the vector drain calls it only
        with vertices it just proved (one round group, presence-filtered
        against the mirrors, edge gate memoized by edges_valid).

        ``prepped = (srcs, flats)`` threads batch geometry the drain
        already computed: the per-vertex source list and the per-vertex
        FLAT strong-row indices (``source * n + strong_cols``, memoized
        cluster-wide on each shared vertex object), under the
        caller-proved guarantee that NO vertex in ``vs`` carries weak
        edges. The strong mirror then lands as one 1-D scatter into the
        round's row block — no per-vertex edge walk, no ``np.repeat``.
        """
        if not vs:
            return
        r = vs[0].id.round
        if r < self.base_round:
            raise ValueError(f"vertex {vs[0].id} is below the pruned floor")
        if not trusted:
            seen = set()
            for v in vs:
                vid = v.id
                if vid.round != r:
                    raise ValueError(
                        f"insert_many needs one round, got {vid.round} != {r}"
                    )
                if vid in self.vertices or vid in seen:
                    raise ValueError(f"vertex {vid} already present")
                seen.add(vid)
                sr, _, _, _ = v.edge_arrays()
                g = v.__dict__.get("_gate")
                if (g is None or g[1]) and sr.size and (sr != r - 1).any():
                    raise ValueError(
                        f"strong edges from {vid} must target round {r - 1}"
                    )
        self._ensure_capacity(r)
        row = r - self.base_round
        rv = self._round_vertices.get(r)
        if rv is None:
            rv = self._round_vertices[r] = {}
        self.vertices.update((v.id, v) for v in vs)
        if prepped is not None:
            srcs, flats = prepped
            rv.update(zip(srcs, vs))
            self.exists[row, srcs] = True
            flat = np.concatenate(flats) if len(flats) > 1 else flats[0]
            if flat.size:
                # one 1-D scatter into the round's (n, n) row block.
                # strong is always a base C-contiguous allocation (see
                # _ensure_capacity / prune_below, which copy in place),
                # so the reshape is a writable view, never a copy.
                self.strong[row].reshape(-1)[flat] = True
        else:
            srcs = [v.id.source for v in vs]
            rv.update(zip(srcs, vs))
            arrs = [
                v.__dict__.get("_edge_arrays") or v.edge_arrays()
                for v in vs
            ]
            lens = np.fromiter(
                (a[1].size for a in arrs), dtype=np.intp, count=len(vs)
            )
            cols = [a[1] for a in arrs]
            cat = np.concatenate(cols) if len(cols) > 1 else cols[0]
            weak = self.weak
            for s, a in zip(srcs, arrs):
                wr = a[2]
                if wr.size:
                    weak[(r, s)] = tuple(zip(wr.tolist(), a[3].tolist()))
                    self.has_weak[row, s] = True
            self.exists[row, srcs] = True
            if cat.size:
                self.strong[row, np.repeat(srcs, lens), cat] = True
        if r > self.max_round:
            self.max_round = r
        if r < self.insert_min_round:
            self.insert_min_round = r

    # -- queries -----------------------------------------------------------

    def present(self, vid: VertexID) -> bool:
        """Membership — the reference's ``present`` full-DAG scan
        (``process/process.go:373-384``), here O(1).

        Dict lookup, not the dense mirror: ``exists`` is only ever set by
        :meth:`insert`, which also fills ``vertices``, so the two agree —
        and a numpy scalar index costs ~8x a (hash-cached) dict probe,
        on the hottest call in the 64-node consensus profile."""
        return vid in self.vertices

    def get(self, vid: VertexID) -> Optional[Vertex]:
        return self.vertices.get(vid)

    def round_size(self, rnd: int) -> int:
        return len(self._round_vertices.get(rnd, ()))

    def quorum_frontier(self, quorum: int) -> int:
        """Highest round whose vertex count reaches ``quorum`` (0 when
        only genesis does). Round fills are monotone downward —
        admission requires >= quorum strong edges into every prior
        round — so a backward scan from ``max_round`` stops at the
        first hit. The pipelined wave pass uses this to bound which
        wave instances can possibly have quorum votes yet."""
        for r in range(self.max_round, 0, -1):
            if self.round_size(r) >= quorum:
                return r
        return 0

    def vertices_in_round(self, rnd: int) -> List[Vertex]:
        """Vertices of one round in ascending-source order (the
        deterministic order proposals and total-order delivery rely on).
        Served from the per-round dict mirror — the dense-row scan built
        a VertexID per occupied slot on one of the hottest query paths."""
        d = self._round_vertices.get(rnd)
        if not d:
            return []
        return [d[s] for s in sorted(d)]

    def closure(
        self, seeds: Iterable[VertexID], strong_only: bool = False
    ) -> np.ndarray:
        """Causal history of a seed set as a bool bitmap whose row index
        is ``round - base_round`` (absolute round with pruning off).

        Vectorized frontier propagation round-by-round (the host twin of
        :func:`dag_rider_tpu_torch.ops.dag_kernels.closure_from`); weak edges are
        applied from the sparse map. Replaces the reference's per-target BFS
        ``path`` (``process/process.go:89-148``). Propagation stops at the
        pruned floor: retired rounds report nothing.
        """
        base = self.base_round
        R = self.max_round + 1 - base
        reached = np.zeros((R, self.n), dtype=bool)
        top = -1
        for s in seeds:
            if not self.present(s):
                raise KeyError(f"seed {s} not in DAG")
            reached[s.round - base, s.source] = True
            top = max(top, s.round)
        for r in range(top, max(base, 0), -1):
            row = reached[r - base]
            if not row.any():
                continue
            # strong: one vector-matrix product per round.
            reached[r - base - 1] |= row @ self.strong[r - base]
            if not strong_only:
                # has_weak prefilter: only sources that actually carry
                # weak edges get the dict probe (weak edges are rare)
                for i in np.flatnonzero(row & self.has_weak[r - base]):
                    for (r2, j) in self.weak.get((r, i), ()):
                        if r2 >= base:
                            reached[r2 - base, j] = True
        return reached

    def closure_stopped(
        self, seed: VertexID, stop_mask: np.ndarray
    ) -> np.ndarray:
        """Causal history of ``seed``, pruning propagation at vertices
        where ``stop_mask`` is True. Rows of both bitmaps are indexed by
        ``round - base_round`` (the caller's delivered mask is kept
        base-aligned by Process.maybe_prune).

        Sound ONLY for a causally-closed stop set (callers pass the
        delivered bitmap, and delivery is whole-history-at-a-time):
        anything reachable solely through a stopped vertex is itself in
        the stop set, so pruning there loses no *unstopped* vertex.
        Steady-state wave commits touch only the few undelivered rounds
        at the top instead of rescanning the full DAG depth, and the
        early-exit fires once no unstopped vertex remains at or below
        the sweep round.
        """
        base = self.base_round
        R = seed.round + 1 - base
        reached = np.zeros((R, self.n), dtype=bool)
        reached[seed.round - base, seed.source] = True
        for r in range(seed.round, max(base, 0), -1):
            row = r - base
            act = reached[row] & ~stop_mask[row]
            if act.any():
                reached[row - 1] |= act @ self.strong[row]
                # has_weak prefilter — see closure()
                for i in np.flatnonzero(act & self.has_weak[row]):
                    for (r2, j) in self.weak.get((r, i), ()):
                        if r2 >= base:
                            reached[r2 - base, j] = True
            elif not (reached[:row] & ~stop_mask[:row]).any():
                break
        return reached

    def path(
        self, frm: VertexID, to: VertexID, strong_only: bool = False
    ) -> bool:
        """Is there a (strong-)path from ``frm`` down to ``to``?

        Mirrors the reference API ``path(from, to, strongPath)``
        (``process/process.go:89``): edges point from higher rounds to lower,
        so a path exists iff ``to`` is in ``frm``'s causal history.
        """
        if not self.present(frm) or not self.present(to):
            return False
        if frm == to:
            return True
        if to.round >= frm.round:
            return False
        reached = self.closure([frm], strong_only=strong_only)
        return bool(reached[to.round - self.base_round, to.source])

    # -- dense views for device kernels ------------------------------------

    def strong_stack(self, hi: int, lo: int) -> np.ndarray:
        """strong adjacency chain for rounds (lo, hi], top round first —
        the input format of :func:`ops.dag_kernels.reach_chain`."""
        if not 0 <= lo < hi:
            raise ValueError(f"need 0 <= lo < hi, got lo={lo}, hi={hi}")
        if lo < self.base_round:
            raise ValueError(
                f"rounds <= {self.base_round} are pruned; asked for lo={lo}"
            )
        base = self.base_round
        return self.strong[hi - base : lo - base : -1]

    def dense_snapshot(self, rounds: Optional[int] = None):
        """(exists, strong) trimmed to ``rounds`` rows (rows start at
        ``base_round``) — checkpoint payload and device-dispatch input."""
        R = (self.max_round + 1 - self.base_round) if rounds is None else rounds
        return self.exists[:R].copy(), self.strong[:R].copy()
