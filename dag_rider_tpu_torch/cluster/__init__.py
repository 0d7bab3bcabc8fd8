"""Multi-process cluster harness.

Every prior round hardened the engine inside ONE simulator process; this
package runs the full stack as N separate OS processes over real sockets
and proves it survives violent failure:

- :mod:`directory` — workspace layout, address allocation (UDS or TCP),
  committee key dealing, per-node runner config files;
- :mod:`runner` — the per-node OS-process entrypoint
  (``python -m dag_rider_tpu_torch.cluster.runner --config node0.json``): one
  :class:`dag_rider_tpu_torch.node.Node` with a durable submit WAL, a
  line-buffered delivery log, the client Submit front door, and clean
  SIGTERM shutdown with a final state report;
- :mod:`supervisor` — boots the processes, injects process-level faults
  (kill -9 at seeded times, restart-from-checkpoint), and gathers logs,
  final reports, and flight-recorder dumps;
- :mod:`client` — the over-the-wire load generator: seeded open-loop
  traffic through the gRPC Submit door, recording per-transaction
  accepted stamps for the zero-loss audit;
- :mod:`audit` — post-hoc invariant checking over the per-node logs
  (commit-order agreement, uniqueness, zero loss of accepted
  transactions, liveness) via :mod:`dag_rider_tpu_torch.consensus.invariants`.

The crash-durability contract: a transaction is only acknowledged to a
client after it is (a) admitted by the node's mempool AND (b) appended to
that node's line-buffered submit WAL — data a kill -9 cannot un-write.
On restart the runner re-injects WAL transactions not already covered by
its delivery log, its restored checkpoint state, or the supervisor's
cluster-wide delivered hint, so every acknowledged transaction is either
already committed or back in flight. The audit then proves the stronger
end-to-end property: accepted ⊆ delivered ∪ retained across the cluster.
"""

from dag_rider_tpu_torch.cluster.directory import ClusterSpec, build_cluster

__all__ = ["ClusterSpec", "build_cluster"]
