"""Block builder: packs pooled transactions into ``Block`` payloads.

The port's copy of ``dag_rider_tpu/mempool/batcher.py``.

DAG-Rider a_bcasts one block per vertex, so the bytes a vertex carries
are decided here. Two triggers, whichever fires first:

- **size** — the pool holds at least ``batch_bytes`` of payload: ship a
  full block (throughput mode; fill fraction ~1.0);
- **deadline** — the oldest pending transaction has waited
  ``batch_deadline_ms``: ship whatever is there (latency mode; bounds
  client-perceived commit latency at low load).

Packing is round-robin across client lanes (TransactionPool.take), so
block space is shared fairly under contention. The fill fraction of
every built block is recorded — persistently low fill with high
latency means the deadline is too tight for the offered load; high
fill with deep pools means ``batch_bytes`` is too small.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from dag_rider_tpu_torch.config import MempoolConfig
from dag_rider_tpu_torch.core.types import Block
from dag_rider_tpu_torch.mempool.pool import TransactionPool

#: fill-fraction sample window (mirrors utils.metrics.SAMPLE_WINDOW's
#: bounded-deque rule without importing the metrics module here)
_FILL_WINDOW = 4096


class BlockBatcher:
    """Size-or-deadline block builder over one TransactionPool."""

    def __init__(self, cfg: MempoolConfig, pool: TransactionPool) -> None:
        self.cfg = cfg
        self.pool = pool
        #: the EFFECTIVE deadline: starts at the configured value and is
        #: retuned live by Mempool when cfg.adaptive_deadline is on (the
        #: configured batch_deadline_ms stays the ceiling)
        self.deadline_ms = float(cfg.batch_deadline_ms)
        self.blocks_built = 0
        self.txs_packed = 0
        self.fill_fractions: Deque[float] = deque(maxlen=_FILL_WINDOW)

    def ready(self, now: float) -> bool:
        if not len(self.pool):
            return False
        if self.pool.depth_bytes >= self.cfg.batch_bytes:
            return True
        return self.pool.oldest_age(now) * 1e3 >= self.deadline_ms

    def build(self, now: float, force: bool = False) -> Optional[Block]:
        """One block if a trigger fired (or ``force`` and non-empty)."""
        if not force and not self.ready(now):
            return None
        txs = self.pool.take(self.cfg.batch_bytes, self.cfg.max_batch_txs)
        if not txs:
            return None
        self.blocks_built += 1
        self.txs_packed += len(txs)
        self.fill_fractions.append(
            min(1.0, sum(len(t) for t in txs) / self.cfg.batch_bytes)
        )
        return Block(tuple(txs))

    def drain(
        self,
        now: float,
        force: bool = False,
        limit: Optional[int] = None,
    ) -> List[Block]:
        """Every block whose trigger has fired, up to ``limit``. The
        triggers are re-checked against the REMAINING pool before each
        build: several client lanes that independently aged past the
        deadline each earn their own partial block in one call (the old
        size-only re-check spent the deadline trigger on the first
        build, so lane 2's overdue traffic waited a full extra drain
        cycle — the one-partial-per-drain bug). Termination: build()
        always takes at least one transaction, so the pool strictly
        shrinks. ``force`` flushes everything regardless of triggers
        (but still honors ``limit``)."""
        out: List[Block] = []
        while limit is None or len(out) < limit:
            if not force and out and not self.ready(now):
                break
            block = self.build(now, force=force)
            if block is None:
                break
            out.append(block)
        return out

    def mean_fill(self) -> float:
        if not self.fill_fractions:
            return 0.0
        return sum(self.fill_fractions) / len(self.fill_fractions)
