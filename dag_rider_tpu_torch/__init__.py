"""dag_rider_tpu_torch — the PyTorch/CUDA port of dag_rider_tpu.

The port's first slice is the system's device path: a whole DAG round of
Ed25519 vertex signatures checked in one batched dispatch on an NVIDIA
H100 (fixed-key comb verification), returning the accept mask to host
consensus. Layers, mirroring the JAX package's names:

- ``crypto``    — host RFC 8032 Ed25519 (the oracle and the signer)
- ``core``      — the vertex data model the verifier signs and checks
- ``ops``       — the limb field, the group, the comb path, and the
  hand-written CUDA kernels (``cuda_group``, ``cuda_field``) with their
  plain torch versions
- ``verifier``  — ``CPUVerifier`` (host oracle) and ``CUDAVerifier``
- ``utils``     — nvcc build-on-first-use of ``csrc/*.cu``

The package imports torch and numpy, never jax and nothing of
``dag_rider_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
