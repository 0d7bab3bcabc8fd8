"""The batched Verifier seam: the host oracle, the card's verifier (import
``verifier.cuda`` for it), the round-certificate verifier (``verifier.cert``),
the depth-K window, the degradation ladder and the chaos harness. The names
below import no card module."""

from dag_rider_tpu_torch.verifier.base import (
    KeyRegistry,
    Verifier,
    VerifierUnavailableError,
    VertexSigner,
)
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier, NullVerifier
from dag_rider_tpu_torch.verifier.faults import (
    VerifierFaultInjector,
    VerifierFaultPlan,
)
from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline
from dag_rider_tpu_torch.verifier.resilient import ResilientVerifier

__all__ = [
    "KeyRegistry",
    "Verifier",
    "VertexSigner",
    "CPUVerifier",
    "NullVerifier",
    "VerifierPipeline",
    "ResilientVerifier",
    "VerifierUnavailableError",
    "VerifierFaultInjector",
    "VerifierFaultPlan",
]
