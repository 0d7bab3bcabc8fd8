"""CUDA Verifier backend — one DAG round per device dispatch on the H100.

Port of ``dag_rider_tpu/verifier/tpu.py`` (``TPUVerifier``) in 4-bit comb
mode. The work split is the reference's: all ordering stays on the host,
the device returns only accept bits.

- host (:meth:`CUDAVerifier._prepare`): byte parsing, the s < L
  malleability check, the R.y < p canonicity check, the SHA-512 challenge
  k, and packing of one padded dispatch into ``u8[B, 131]`` (s and k
  nibbles, R sign, prevalid, key valid) + ``i32[B, 23]`` (key index, R.y
  limbs) — byte-identical to the JAX ``_prepare(comb=True)``;
- device (:func:`device_verify_comb`): the comb gather, the 6-level tree
  of padd kernels, and the finish kernel (R decompression, R + [k]A, the
  projective equality).

Batches pad to power-of-two buckets (padded rows are structurally invalid
and come out False). :meth:`dispatch_batch` enqueues on the current CUDA
stream and returns at once; :meth:`resolve_batch` waits on the dispatch's
event. That pair lets ``verifier.pipeline.VerifierPipeline`` and
``consensus.simulator.Simulation`` drive this verifier by duck typing. Vertices are any
objects with ``.source``, ``.signature`` and ``.signing_bytes()``.
"""

from __future__ import annotations

import hashlib
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dag_rider_tpu_torch.crypto import ed25519
from dag_rider_tpu_torch.ops import comb, field
from dag_rider_tpu_torch.verifier.base import (
    KeyRegistry,
    Verifier,
    VerifierUnavailableError,
)

_MIN_BUCKET = 16
U8_COLS = 131
I32_COLS = 23


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


_BIT_POW = (1 << np.arange(field.LIMB_BITS, dtype=np.int32)).astype(np.int32)


def bytes_to_limbs_batch(raw: np.ndarray) -> np.ndarray:
    """uint8[B, 32] little-endian -> int32[B, 22] 12-bit limbs, vectorized
    (one unpackbits + one matvec)."""
    bits = np.unpackbits(raw, axis=-1, bitorder="little")  # [B, 256]
    pad = field.LIMBS * field.LIMB_BITS - bits.shape[-1]  # 264 - 256
    bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    grouped = bits.reshape(*raw.shape[:-1], field.LIMBS, field.LIMB_BITS)
    return grouped.astype(np.int32) @ _BIT_POW


_L_BYTES_LE = np.frombuffer(ed25519.L.to_bytes(32, "little"), dtype=np.uint8)
_P_BYTES_LE = np.frombuffer(field.P_INT.to_bytes(32, "little"), dtype=np.uint8)


def _lex_lt(rows: np.ndarray, bound_le: np.ndarray) -> np.ndarray:
    """Batched ``int(row, little) < int(bound, little)`` over uint8[B, 32]:
    the most significant differing byte decides; equal rows are not less."""
    be = rows[:, ::-1]
    bound_be = bound_le[::-1]
    diff = be != bound_be
    first = np.argmax(diff, axis=1)  # 0 when no byte differs
    rows_idx = np.arange(be.shape[0])
    return diff.any(axis=1) & (be[rows_idx, first] < bound_be[first])


def nibbles_batch(raw: np.ndarray) -> np.ndarray:
    """uint8[B, 32] little-endian scalar bytes -> int32[B, 64] nibble
    windows (nib[2i] = byte[i] & 0xF, nib[2i+1] = byte[i] >> 4)."""
    out = np.empty((*raw.shape[:-1], 64), dtype=np.int32)
    out[..., 0::2] = raw & 0xF
    out[..., 1::2] = raw >> 4
    return out


class CombInputs(NamedTuple):
    """Per-row inputs of :func:`comb.comb_verify_core`, unpacked on the
    device from the two transfer arrays (gather indices as int64)."""

    s_nibbles: torch.Tensor  # int64 [B, 64]
    k_nibbles: torch.Tensor  # int64 [B, 64]
    key_idx: torch.Tensor  # int64 [B]
    a_valid: torch.Tensor  # bool [B]
    r_y: torch.Tensor  # int32 [B, 22]
    r_sign: torch.Tensor  # int32 [B]
    prevalid: torch.Tensor  # bool [B]


def unpack(u8: torch.Tensor, i32: torch.Tensor) -> CombInputs:
    """(u8 [B, 131], i32 [B, 23]) -> :class:`CombInputs`."""
    return CombInputs(
        s_nibbles=u8[:, :64].long(),
        k_nibbles=u8[:, 64:128].long(),
        key_idx=i32[:, 0].long(),
        a_valid=u8[:, 130].bool(),
        r_y=i32[:, 1:].contiguous(),
        r_sign=u8[:, 128].int(),
        prevalid=u8[:, 129].bool(),
    )


def device_verify_comb(
    u8: torch.Tensor,
    i32: torch.Tensor,
    key_tables: torch.Tensor,
    b_table: torch.Tensor,
) -> torch.Tensor:
    """Unpack the two transfer arrays (see :meth:`CUDAVerifier._prepare`)
    and run the comb verify core on their device -> bool [B]."""
    x = unpack(u8, i32)
    return comb.comb_verify_core(
        x.s_nibbles, x.k_nibbles, x.key_idx, key_tables, b_table,
        x.a_valid, x.r_y, x.r_sign, x.prevalid,
    )


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and
    there is no card — there is no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise VerifierUnavailableError(
            "no CUDA device available; pass device='cpu' for the plain torch path"
        )
    return dev


class Pending(NamedTuple):
    """Handle of one enqueued dispatch: the device mask, the real row
    count, the event recorded after the dispatch (None on the CPU), and
    the host clock when the device work was enqueued."""

    mask: torch.Tensor
    count: int
    event: Optional[torch.cuda.Event]
    t_enqueue: float


class CUDAVerifier(Verifier):
    """Batched Ed25519 verification on the H100 (fixed-key comb path).

    ``device`` defaults to ``cuda``; ``device="cpu"`` runs the same
    program through the kernels' plain torch versions (the tests)."""

    #: When set, every dispatch pads to exactly this bucket and
    #: :meth:`verify_rounds` chunks larger merges into it.
    fixed_bucket: Optional[int] = None

    def __init__(
        self, registry: KeyRegistry, device: Optional[torch.device | str] = None
    ):
        self.device = resolve_device(device)
        self.registry = registry
        n = registry.n
        self._a_x = np.zeros((n, field.LIMBS), dtype=np.int32)
        self._a_y = np.zeros((n, field.LIMBS), dtype=np.int32)
        self._a_t = np.zeros((n, field.LIMBS), dtype=np.int32)
        self._a_valid = np.zeros(n, dtype=bool)
        for i, pk in enumerate(registry.public_keys):
            pt = ed25519.point_decompress(pk) if len(pk) == 32 else None
            if pt is None:
                continue
            x, y, _, t = pt  # Z == 1 from decompress
            self._a_x[i] = field.to_limbs(x)
            self._a_y[i] = field.to_limbs(y)
            self._a_t[i] = field.to_limbs(t)
            self._a_valid[i] = True
        self._tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        #: host-prep / device seconds of the most recent dispatch
        #: (prep on the host; enqueue to mask-on-host for the device)
        self.last_prepare_s = 0.0
        self.last_dispatch_s = 0.0

    # -- host-side batch preparation ------------------------------------

    def _prepare(
        self, vertices: Sequence, size: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host prep of one padded dispatch of ``size`` rows -> (u8
        [size, 131], i32 [size, 23]). Rows >= len(vertices) are padding:
        structurally invalid and zero-filled.

        Structural checks, the s < L compare and the R.y < p compare are
        batched numpy; only the SHA-512 challenge walks the rows."""
        sig_raw = np.zeros((size, 64), dtype=np.uint8)
        pk_raw = np.zeros((size, 32), dtype=np.uint8)
        k_raw = np.zeros((size, 32), dtype=np.uint8)
        src = np.zeros(size, dtype=np.int64)
        structural = np.zeros(size, dtype=bool)
        msgs: List[bytes] = []
        for j, v in enumerate(vertices[:size]):
            pk = self.registry.key_of(v.source)
            sig = v.signature
            if pk is None or sig is None or len(sig) != 64 or len(pk) != 32:
                msgs.append(b"")
                continue
            sig_raw[j] = np.frombuffer(sig, dtype=np.uint8)
            pk_raw[j] = np.frombuffer(pk, dtype=np.uint8)
            src[j] = v.source
            structural[j] = True
            msgs.append(v.signing_bytes())
        s_raw = sig_raw[:, 32:]
        r_raw = sig_raw[:, :32].copy()
        s_lt_l = _lex_lt(s_raw, _L_BYTES_LE)
        r_sign = (r_raw[:, 31] >> 7).astype(np.int32)
        r_raw[:, 31] &= 0x7F
        r_lt_p = _lex_lt(r_raw, _P_BYTES_LE)
        prevalid = structural & s_lt_l & r_lt_p
        # k = SHA-512(R || A || M) mod L per valid row
        for j in np.flatnonzero(prevalid):
            digest = hashlib.sha512(
                sig_raw[j, :32].tobytes() + pk_raw[j].tobytes() + msgs[j]
            ).digest()
            k = int.from_bytes(digest, "little") % ed25519.L
            k_raw[j] = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
        u8 = np.empty((size, U8_COLS), dtype=np.uint8)
        i32 = np.empty((size, I32_COLS), dtype=np.int32)
        u8[:, :64] = nibbles_batch(np.where(prevalid[:, None], s_raw, 0))
        u8[:, 64:128] = nibbles_batch(k_raw)
        u8[:, 128] = r_sign
        u8[:, 129] = prevalid
        u8[:, 130] = self._a_valid[src] & prevalid
        i32[:, 0] = src
        i32[:, 1:] = bytes_to_limbs_batch(r_raw)
        return u8, i32

    def comb_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(key tables [n * 64 * 16, 88], base table [64 * 16, 88]) on the
        device, flat for the gather. The key tables are built on the device
        once per verifier (``comb.build_key_tables``)."""
        if self._tables is None:
            dev = self.device
            built = comb.build_key_tables(
                torch.as_tensor(self._a_x, device=dev),
                torch.as_tensor(self._a_y, device=dev),
                torch.as_tensor(self._a_t, device=dev),
            )
            b_tab = torch.as_tensor(comb.base_table_xyzt(), device=dev)
            self._tables = (
                built.reshape(-1, 4 * field.LIMBS),
                b_tab.reshape(-1, 4 * field.LIMBS),
            )
        return self._tables

    # -- dispatch -----------------------------------------------------------

    def _size_for(self, count: int) -> int:
        if self.fixed_bucket and count <= self.fixed_bucket:
            return int(self.fixed_bucket)
        return _bucket(count)

    def prepare_batch(self, vertices: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """The host arrays of one dispatch of ``vertices`` (bucket-padded)."""
        return self._prepare(vertices, self._size_for(len(vertices)))

    def dispatch_batch(self, vertices: Sequence) -> Pending:
        """Host prep + device enqueue, no sync. Returns a handle for
        :meth:`resolve_batch`."""
        t0 = time.perf_counter()
        u8, i32 = self.prepare_batch(vertices)
        t1 = time.perf_counter()
        self.last_prepare_s = t1 - t0
        tables, b_tab = self.comb_tables()
        mask = device_verify_comb(
            torch.from_numpy(u8).to(self.device),
            torch.from_numpy(i32).to(self.device),
            tables,
            b_tab,
        )
        event = None
        if mask.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(mask.device))
        return Pending(mask, len(vertices), event, t1)

    def resolve_batch(self, pending: Pending) -> List[bool]:
        """Blocking half: wait on the dispatch's event, then the mask as
        per-vertex host bools."""
        mask, count, event, t_enqueue = pending
        if event is not None:
            event.synchronize()
        out = mask[:count].cpu().tolist()
        self.last_dispatch_s = time.perf_counter() - t_enqueue
        return out

    def verify_batch(self, vertices: Sequence) -> List[bool]:
        if not vertices:
            return []
        return self.resolve_batch(self.dispatch_batch(vertices))

    def verify_rounds(self, rounds: Sequence[Sequence]) -> List[List[bool]]:
        """Verify several DAG rounds in one merged padded dispatch (chunks
        of ``fixed_bucket`` when set and exceeded, all enqueued before the
        first is resolved); the mask is split back per round."""
        lens = [len(r) for r in rounds]
        flat = [v for r in rounds for v in r]
        if not flat:
            return [[] for _ in rounds]
        cap = self.fixed_bucket
        if cap and len(flat) > cap:
            chunks = [flat[i : i + cap] for i in range(0, len(flat), cap)]
        else:
            chunks = [flat]
        pending = [self.dispatch_batch(ch) for ch in chunks]
        mask = [m for p in pending for m in self.resolve_batch(p)]
        out, pos = [], 0
        for ln in lens:
            out.append(mask[pos : pos + ln])
            pos += ln
        return out
