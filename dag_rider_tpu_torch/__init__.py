"""dag_rider_tpu_torch — the PyTorch/CUDA port of dag_rider_tpu.

DAG-Rider (Byzantine atomic broadcast) with its device paths on an NVIDIA
H100: a whole DAG round of Ed25519 vertex signatures checked in one batched
dispatch (fixed-key comb verification), returning the accept mask to host
consensus; and the BLS12-381 G1 multi-scalar multiplication that combines
threshold shares into the common coin and sums vertex signatures into
round certificates. The consensus host layer is a copy of the JAX
package's, so the port's own ``Simulation`` runs the protocol with those
device paths in the loop. Layers, mirroring the JAX package's names:

- ``core``      — the vertex data model, certificates, wire messages, the
  wire codec and the generic stack
- ``transport`` — the broadcast seam, the in-memory broker and the Bracha
  reliable-broadcast stage
- ``consensus`` — the DAG state, the DAG-Rider process (Algorithms 1-3),
  the invariant checkers, the deterministic ``Simulation``, and the
  common coins (``ThresholdCoin`` with its MSM seam)
- ``epoch``     — epoch boundaries and seeded key rotation
- ``crypto``    — host RFC 8032 Ed25519, host BLS12-381 (keys, signatures,
  pairings) and the (f+1)-of-n threshold scheme
- ``ops``       — the limb fields, the groups, the comb path, the G1 MSM,
  the hand-written CUDA kernels (``cuda_group``, ``cuda_field``,
  ``cuda_group381``) with their plain torch versions, and the numpy twin
  of the leader-reach query
- ``verifier``  — ``CPUVerifier`` (host oracle), ``CUDAVerifier``,
  ``CertVerifier`` (round certificates) and the depth-K
  ``VerifierPipeline``
- ``obs``       — causal tracing and the flight recorder
- ``utils``     — metrics, structured events, and nvcc build-on-first-use
  of ``csrc/*.cu``
- ``config``    — ``Config`` and the port's own ``DAGRIDER_*`` knob registry

The package imports torch and numpy, never jax and nothing of
``dag_rider_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from dag_rider_tpu_torch.config import Config
from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID

__version__ = "0.1.0"

__all__ = ["Config", "Block", "Vertex", "VertexID", "__version__"]
