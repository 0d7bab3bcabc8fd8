from dag_rider_tpu_torch.consensus.coin import CommonCoin, FixedCoin, RoundRobinCoin
from dag_rider_tpu_torch.consensus.dag_state import DagState
from dag_rider_tpu_torch.consensus.process import Process
from dag_rider_tpu_torch.consensus.simulator import RandomizedScheduler, Simulation

__all__ = [
    "CommonCoin",
    "FixedCoin",
    "RoundRobinCoin",
    "DagState",
    "Process",
    "RandomizedScheduler",
    "Simulation",
]
