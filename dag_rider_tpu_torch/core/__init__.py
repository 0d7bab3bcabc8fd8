from dag_rider_tpu_torch.core.stack import Stack
from dag_rider_tpu_torch.core.types import Block, BroadcastMessage, Vertex, VertexID

__all__ = ["Stack", "Block", "BroadcastMessage", "Vertex", "VertexID"]
