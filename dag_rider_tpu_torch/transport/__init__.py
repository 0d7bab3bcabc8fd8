from dag_rider_tpu_torch.transport.base import Handler, Transport
from dag_rider_tpu_torch.transport.faults import FaultPlan, FaultyTransport
from dag_rider_tpu_torch.transport.memory import InMemoryTransport
from dag_rider_tpu_torch.transport.rbc import RbcTransport

__all__ = [
    "Handler",
    "Transport",
    "FaultPlan",
    "FaultyTransport",
    "InMemoryTransport",
    "RbcTransport",
]
