"""Host cryptography: RFC 8032 Ed25519, BLS12-381, the threshold scheme and
the DKG."""

from dag_rider_tpu_torch.crypto import ed25519

__all__ = ["ed25519"]
