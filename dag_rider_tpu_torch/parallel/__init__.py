"""Device meshes, the sharded verifier, the sharded MSM and the round step
(the port of ``dag_rider_tpu/parallel/``)."""

from dag_rider_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_from_env, virtual_mesh
from dag_rider_tpu_torch.parallel.msm import ShardedMSM
from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier

__all__ = ["Mesh", "make_mesh", "mesh_from_env", "virtual_mesh", "ShardedMSM",
           "ShardedCUDAVerifier"]
