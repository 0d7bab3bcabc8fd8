"""dag_rider_tpu_torch — the PyTorch/CUDA port of dag_rider_tpu.

The port's slices are the system's device paths on an NVIDIA H100: a
whole DAG round of Ed25519 vertex signatures checked in one batched
dispatch (fixed-key comb verification), returning the accept mask to host
consensus; and the BLS12-381 G1 multi-scalar multiplication that combines
threshold shares into the common coin and sums vertex signatures into
round certificates. Layers, mirroring the JAX package's names:

- ``crypto``    — host RFC 8032 Ed25519, host BLS12-381 (keys, signatures,
  pairings) and the (f+1)-of-n threshold scheme
- ``core``      — the vertex data model and the round certificate
- ``consensus`` — the common coins (``ThresholdCoin`` with its MSM seam)
- ``ops``       — the limb fields, the groups, the comb path, the G1 MSM,
  and the hand-written CUDA kernels (``cuda_group``, ``cuda_field``,
  ``cuda_group381``) with their plain torch versions
- ``verifier``  — ``CPUVerifier`` (host oracle), ``CUDAVerifier`` and
  ``CertVerifier`` (round certificates)
- ``utils``     — nvcc build-on-first-use of ``csrc/*.cu``

The package imports torch and numpy, never jax and nothing of
``dag_rider_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
