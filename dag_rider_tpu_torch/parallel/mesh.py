"""Device meshes for the sharded verifier and the sharded MSM.

Port of ``dag_rider_tpu/parallel/mesh.py``. The JAX mesh is one process
over many devices with one named "batch" axis; here a :class:`Mesh` is an
ordered tuple of ``torch.device`` entries, driven by one process, with no
``torch.distributed`` and no NCCL: verification needs no collective, and
the MSM's one gather is a copy of the per-shard partial sums to the first
entry. Consensus traffic stays on the host, as in the reference.

- :func:`make_mesh` spans the first n visible cards; ``device="cpu"``
  gives n CPU entries, the counterpart of the JAX package's virtual CPU
  devices, for tests.
- :func:`mesh_from_env` reads ``DAGRIDER_MESH`` (unset: every visible
  card; on the CPU, 8 entries) and clamps a request above the visible
  card count with a warning, as the reference does.
- :func:`virtual_mesh` gives k entries of one device: the split, the
  per-shard programs and the fold run as on k cards, on one. It is never a
  default; only a caller that names it gets it, and its ``repr`` says so.

``shard_map``, ``batch_sharding`` and ``replicated`` are JAX spellings with
no counterpart: the verifier and the MSM place their shards themselves
(:func:`split_rows`, :func:`gather_rows`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import torch

from dag_rider_tpu_torch import config

#: CPU entries of an unsized CPU mesh: the JAX package's tests run their
#: mesh on 8 virtual CPU devices (tests/conftest.py)
CPU_DEVICES = 8


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one axis, ``"batch"``; the first
    entry is where results gather. ``virtual`` marks a mesh of several
    entries of one device."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "batch"
    virtual: bool = False

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        kind = "virtual " if self.virtual else ""
        return f"{kind}Mesh({self.axis_name}: {', '.join(str(d) for d in self.devices)})"


def _visible(device: str) -> int:
    if device == "cpu":
        return CPU_DEVICES
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' for a CPU mesh"
        )
    return torch.cuda.device_count()


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> Mesh:
    """A mesh over the first ``n_devices`` visible cards (default: all).
    With ``device="cpu"``: ``n_devices`` CPU entries (default 8). Raises on
    a machine without a card unless the caller asks for the CPU, and when
    more cards are asked for than are visible."""
    device = torch.device(device).type
    have = _visible(device)
    n = have if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if device == "cpu":
        return Mesh(tuple(torch.device("cpu") for _ in range(n)))
    if n > have:
        raise ValueError(f"{n} devices asked for, {have} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def mesh_from_env(device: str = "cuda") -> Mesh:
    """The mesh of ``verifier="sharded"`` deployments: ``DAGRIDER_MESH``
    entries, unset meaning every visible card. A request above the visible
    count clamps to it with a warning (the reference's behaviour). With
    ``device="cpu"``: ``DAGRIDER_MESH`` CPU entries, 8 when unset."""
    want = config.env_opt_int("DAGRIDER_MESH")
    device = torch.device(device).type
    if device == "cpu":
        return make_mesh(CPU_DEVICES if want is None else want, device="cpu")
    have = _visible(device)
    if want is None:
        want = have
    if want > have:
        warnings.warn(
            f"DAGRIDER_MESH={want} but only {have} device(s) visible; "
            f"clamping the mesh to {have}",
            stacklevel=2,
        )
        want = have
    return make_mesh(want, device=device)


def virtual_mesh(k: int, device="cuda") -> Mesh:
    """k entries of one device (``cuda`` is the current card): the mesh's
    split, per-shard programs and fold on one device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        _visible("cuda")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if k < 1:
        raise ValueError(f"a mesh needs at least one entry, got {k}")
    return Mesh(tuple(dev for _ in range(k)), virtual=True)


def split_rows(x, k: int) -> List:
    """A [B, ...] batch (tensor or numpy array) as k row slices in order;
    B must be a multiple of k (the verifier pads its dispatches so)."""
    if x.shape[0] % k:
        raise ValueError(f"{x.shape[0]} rows do not split over {k} shards")
    step = x.shape[0] // k
    return [x[i * step : (i + 1) * step] for i in range(k)]


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The row slices of :func:`split_rows`, back in order on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=0)
