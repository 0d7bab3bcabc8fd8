"""CUDA Verifier backend — one DAG round per device dispatch on the H100.

Port of ``dag_rider_tpu/verifier/tpu.py`` (``TPUVerifier``): the comb
path, the windowed oracle path (``comb=False``), and the whole host half.
The work split is the reference's: all ordering stays on the host, the
device returns only accept bits.

- host (:meth:`CUDAVerifier._prepare`): byte parsing, the s < L
  malleability check, the R.y < p canonicity check, the SHA-512 challenge
  k (one native C++ batch call a row block, ``utils/native.py``; hashlib
  when ``DAGRIDER_NATIVE=0``), and packing of one padded dispatch into
  ``u8[B, 131]`` (s and k nibbles, R sign, prevalid, key valid; 8-bit
  windows: ``u8[B, 67]`` with the raw scalar bytes) + ``i32[B, 23]`` (key
  index, R.y limbs) — byte-identical to the JAX ``_prepare(comb=True)``.
  Row blocks fill a reusable staging slot through the parallel prep
  engine (``verifier/prep.py``);
- device (:func:`device_verify_comb`, :func:`device_verify_comb8`): the
  comb gather, the one-launch tree of padd kernels, and the finish kernel
  (R decompression, R + [k]A, the projective equality);
- the windowed path (``comb=False``, the differential oracle): host prep
  packs the reference's nine arrays (nibbles, the key's limbs, flags) and
  :func:`device_verify_windowed` runs ``ops/windowed.py`` (the padd and
  pow22523 kernels, the walk from a CUDA graph; ``curve.verify_core`` on
  the CPU).

Batches pad to power-of-two buckets (padded rows are structurally invalid
and come out False). :meth:`dispatch_batch` is composed of
:meth:`prep_batch` (host only: numpy and the native call, safe on the prep
engine's seam thread) and :meth:`dispatch_prepped` (the copies and the
launches on the calling thread's current CUDA stream, no sync);
:meth:`resolve_batch` waits on the dispatch's event. The chunk-streaming
:meth:`verify_rounds` keeps a depth-K window with prep running ahead and
contains a prep, dispatch or resolve fault (salvage, fresh staging slots,
quarantine). ``verifier.pipeline.VerifierPipeline`` and
``consensus.simulator.Simulation`` drive the same halves by duck typing.
Vertices are any objects with ``.source``, ``.signature`` and
``.signing_bytes()``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dag_rider_tpu_torch import config
from dag_rider_tpu_torch.crypto import ed25519
from dag_rider_tpu_torch.ops import comb, field, windowed
from dag_rider_tpu_torch.utils import native
from dag_rider_tpu_torch.verifier.base import (
    KeyRegistry,
    Verifier,
    VerifierUnavailableError,
)
from dag_rider_tpu_torch.verifier.prep import PrepEngine

_MIN_BUCKET = 16
U8_COLS = 131
U8_COLS8 = 67
I32_COLS = 23


def _native_enabled() -> bool:
    """Native challenge hashing on by default; DAGRIDER_NATIVE=0 (or
    false/no/off) takes the hashlib route."""
    return config.env_flag("DAGRIDER_NATIVE")


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


def unpack8(u8: torch.Tensor, i32: torch.Tensor) -> CombInputs:
    """(u8 [B, 67], i32 [B, 23]) of the 8-bit layout -> :class:`CombInputs`
    whose digit fields hold the raw scalar bytes (int64 [B, 32])."""
    return CombInputs(
        s_nibbles=u8[:, :32].long(),
        k_nibbles=u8[:, 32:64].long(),
        key_idx=i32[:, 0].long(),
        a_valid=u8[:, 66].bool(),
        r_y=i32[:, 1:].contiguous(),
        r_sign=u8[:, 64].int(),
        prevalid=u8[:, 65].bool(),
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


def device_verify_comb8(
    u8: torch.Tensor,
    i32: torch.Tensor,
    key_tables: torch.Tensor,
    b_table: torch.Tensor,
) -> torch.Tensor:
    """8-bit-window twin of :func:`device_verify_comb`: u8 carries the raw
    scalar bytes (32 + 32) instead of nibble digits."""
    x = unpack8(u8, i32)
    return comb.comb_verify_core8(
        x.s_nibbles, x.k_nibbles, x.key_idx, key_tables, b_table,
        x.a_valid, x.r_y, x.r_sign, x.prevalid,
    )


def device_verify_windowed(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    a_x: torch.Tensor,
    a_y: torch.Tensor,
    a_t: torch.Tensor,
    a_valid: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    prevalid: torch.Tensor,
) -> torch.Tensor:
    """The windowed path's device program over the nine prep arrays of
    ``_prepare(comb=False)`` -> bool [B] (``ops/windowed.py``: the kernels
    on a card, ``curve.verify_core`` on the CPU)."""
    one = field.const("ONE", a_x.device).expand_as(a_x)
    return windowed.verify(
        s_nibbles, k_nibbles, (a_x, a_y, one, a_t), a_valid, r_y, r_sign, prevalid
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


class PreppedBatch(NamedTuple):
    """Handle between the prep_batch/dispatch_prepped halves of a
    dispatch: the host transfer arrays (a staging-ring slot), the padded
    size, the real row count, and the prep wall seconds (booked at
    dispatch time, on the dispatching thread)."""

    args: tuple
    size: int
    count: int
    prep_s: float


class Pending(NamedTuple):
    """Handle of one enqueued dispatch: the device mask, the real row
    count, the event recorded after the dispatch (None on the CPU), and
    the host clock when the device work was enqueued."""

    mask: torch.Tensor
    count: int
    event: Optional[torch.cuda.Event]
    t_enqueue: float


class CUDAVerifier(Verifier):
    """Batched Ed25519 verification on the H100.

    ``device`` defaults to ``cuda``; ``device="cpu"`` runs the same
    program through the kernels' plain torch versions (the tests).
    ``comb`` None reads ``DAGRIDER_COMB`` (default on): the fixed-key comb
    path; ``comb=False`` is the windowed path, the reference's
    differential oracle, with the same accept masks.
    ``DAGRIDER_COMB_BITS`` picks 4-bit (the default) or 8-bit comb windows.
    ``DAGRIDER_PALLAS_GROUP=0`` raises: the device decides the route."""

    def __init__(
        self,
        registry: KeyRegistry,
        comb: Optional[bool] = None,
        device: Optional[torch.device | str] = None,
    ):
        if not config.env_flag("DAGRIDER_PALLAS_GROUP"):
            # the reference's 0 pins its jnp group ops on a TPU; the port
            # has no plain route on the card
            raise ValueError(
                "DAGRIDER_PALLAS_GROUP=0 has no port route: the device of the "
                "tensors decides (a CPU tensor takes the plain torch version, "
                "a CUDA tensor launches the kernel); leave it unset or 1"
            )
        if comb is None:
            comb = config.env_flag("DAGRIDER_COMB")
        self._comb = bool(comb)
        bits_env = config.env_choice("DAGRIDER_COMB_BITS")
        self._comb_bits = int(bits_env) if bits_env else 4
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
        # reusable host staging rings per padded size — see _stage()
        self._staging: dict = {}
        self._staging_idx: dict = {}
        # padded sizes warmup() has dispatched once
        self._warm: set = set()
        # parallel host-prep engine (verifier/prep.py), built lazily by
        # _prep() so a prep_workers override set after construction
        # still takes effect on first use
        self._prep_engine: Optional[PrepEngine] = None
        from dag_rider_tpu_torch.verifier.pipeline import default_depth

        #: in-flight window depth for the chunk-streaming verify_rounds
        #: path (and the default for wrapping VerifierPipelines)
        self.pipeline_depth = default_depth()
        #: cumulative seconds spent in warmup()
        self.warmup_compile_s = 0.0

    @property
    def u8_cols(self) -> int:
        """Columns of the u8 transfer array: 131 (4-bit) or 67 (8-bit)."""
        return U8_COLS8 if self._comb_bits == 8 else U8_COLS

    # -- host-side batch preparation ------------------------------------

    def _prep_block(
        self,
        vertices: Sequence,
        lo: int,
        hi: int,
        dest: Tuple[np.ndarray, np.ndarray],
    ) -> None:
        """Host prep of rows [lo, hi) of one padded dispatch, written
        straight into ``dest``'s (u8, i32) rows. Every computation here is
        row-local — parsing, the s < L and R.y < p compares, the challenge
        hash, the packing — so any row-block partition of [0, size) gives
        the bytes of one full-range call (the invariant the parallel prep
        engine rides). Rows >= len(vertices) are padding: structurally
        invalid and zero-filled. The numpy kernels and the native
        challenge batch release the GIL, so concurrent blocks overlap."""
        rows = hi - lo
        sig_raw = np.zeros((rows, 64), dtype=np.uint8)
        pk_raw = np.zeros((rows, 32), dtype=np.uint8)
        k_raw = np.zeros((rows, 32), dtype=np.uint8)
        src = np.zeros(rows, dtype=np.int64)
        structural = np.zeros(rows, dtype=bool)
        msgs: List[bytes] = []
        for j in range(lo, min(hi, len(vertices))):
            v = vertices[j]
            jl = j - lo
            pk = self.registry.key_of(v.source)
            sig = v.signature
            if pk is None or sig is None or len(sig) != 64 or len(pk) != 32:
                msgs.append(b"")
                continue
            sig_raw[jl] = np.frombuffer(sig, dtype=np.uint8)
            pk_raw[jl] = np.frombuffer(pk, dtype=np.uint8)
            src[jl] = v.source
            structural[jl] = True
            msgs.append(v.signing_bytes())
        s_raw = sig_raw[:, 32:]
        r_raw = sig_raw[:, :32].copy()
        s_lt_l = _lex_lt(s_raw, _L_BYTES_LE)
        r_sign = (r_raw[:, 31] >> 7).astype(np.int32)
        r_raw[:, 31] &= 0x7F
        r_lt_p = _lex_lt(r_raw, _P_BYTES_LE)
        prevalid = structural & s_lt_l & r_lt_p
        # k = SHA-512(R || A || M) mod L per valid row: one native batch
        # call for the block, or hashlib row by row (the same bytes)
        idx = np.flatnonzero(prevalid)
        if len(idx):
            k_raw[idx] = native.challenges(
                sig_raw[idx, :32], pk_raw[idx], [msgs[j] for j in idx],
                use_native=_native_enabled(),
            )
        if not self._comb:
            s_nib, k_nib, a_x, a_y, a_t, valid, r_y, r_sg, pv = dest
            s_nib[lo:hi] = nibbles_batch(np.where(prevalid[:, None], s_raw, 0))
            k_nib[lo:hi] = nibbles_batch(k_raw)
            a_x[lo:hi] = self._a_x[src]
            a_y[lo:hi] = self._a_y[src]
            a_t[lo:hi] = self._a_t[src]
            valid[lo:hi] = self._a_valid[src] & prevalid
            r_y[lo:hi] = bytes_to_limbs_batch(r_raw)
            r_sg[lo:hi] = r_sign
            pv[lo:hi] = prevalid
            return
        u8, i32 = dest
        u8 = u8[lo:hi]
        i32 = i32[lo:hi]
        if self._comb_bits == 8:
            u8[:, :32] = np.where(prevalid[:, None], s_raw, 0)
            u8[:, 32:64] = k_raw
            u8[:, 64] = r_sign
            u8[:, 65] = prevalid
            u8[:, 66] = self._a_valid[src] & prevalid
        else:
            u8[:, :64] = nibbles_batch(np.where(prevalid[:, None], s_raw, 0))
            u8[:, 64:128] = nibbles_batch(k_raw)
            u8[:, 128] = r_sign
            u8[:, 129] = prevalid
            u8[:, 130] = self._a_valid[src] & prevalid
        i32[:, 0] = src
        i32[:, 1:] = bytes_to_limbs_batch(r_raw)

    def _prepare(
        self,
        vertices: Sequence,
        size: int,
        out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Tuple[np.ndarray, ...]:
        """Host prep of one padded dispatch of ``size`` rows -> (u8
        [size, 131 or 67], i32 [size, 23]) on the comb path; on the
        windowed path the reference's nine arrays (s and k nibbles
        [size, 64], the key's x, y, t limbs [size, 22], key valid, R.y limbs,
        R sign, prevalid), freshly allocated. Every row and column is
        overwritten, so the comb path's caller may hand in a reused staging
        pair (``out``). The rows fill through the prep engine: one block
        when ``prep_workers`` is 1 or the dispatch is small, else up to
        ``prep_workers`` row blocks filled concurrently into the same
        arrays; the partition is invisible in the bytes."""
        if not self._comb:
            limbs = (size, field.LIMBS)
            dest = (
                np.empty((size, 64), dtype=np.int32),
                np.empty((size, 64), dtype=np.int32),
                np.empty(limbs, dtype=np.int32),
                np.empty(limbs, dtype=np.int32),
                np.empty(limbs, dtype=np.int32),
                np.empty(size, dtype=bool),
                np.empty(limbs, dtype=np.int32),
                np.empty(size, dtype=np.int32),
                np.empty(size, dtype=bool),
            )
        elif out is not None:
            dest = out
        else:
            dest = (
                np.empty((size, self.u8_cols), dtype=np.uint8),
                np.empty((size, I32_COLS), dtype=np.int32),
            )
        eng = self._prep()
        eng.run_blocks(
            lambda lo, hi: self._prep_block(vertices, lo, hi, dest),
            eng.plan(size),
        )
        return dest

    def comb_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(key tables, base table) on the device, flat for the gather:
        4-bit [n * 64 * 16, 88] and [64 * 16, 88]; 8-bit [n * 32 * 256, 88]
        and [32 * 256, 88]. Built on the device once per verifier (the
        8-bit base table in the same build as the keys, as key n)."""
        if self._tables is None:
            dev = self.device
            rows = 4 * field.LIMBS
            if self._comb_bits == 8:
                bx, by, _, bt = ed25519.B
                limbs = [
                    torch.as_tensor(
                        np.concatenate([a, field.to_limbs(c)[None]]), device=dev
                    )
                    for a, c in ((self._a_x, bx), (self._a_y, by), (self._a_t, bt))
                ]
                built = comb.build_key_tables8(*limbs)
                self._tables = (
                    built[:-1].reshape(-1, rows),
                    built[-1].reshape(-1, rows),
                )
            else:
                built = comb.build_key_tables(
                    torch.as_tensor(self._a_x, device=dev),
                    torch.as_tensor(self._a_y, device=dev),
                    torch.as_tensor(self._a_t, device=dev),
                )
                b_tab = torch.as_tensor(comb.base_table_xyzt(), device=dev)
                self._tables = (built.reshape(-1, rows), b_tab.reshape(-1, rows))
        return self._tables

    def _stage(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Reusable (u8, i32) host staging pair for one dispatch.

        A ring of pipeline_depth + 2 slots instead of a fresh np.empty per
        dispatch. The host-to-device copies in :meth:`dispatch_prepped` are
        synchronous from pageable memory, so a slot is free again as soon
        as its dispatch returns; the ring still keeps the reference's
        discipline (every window keeps at most pipeline_depth dispatches
        in flight and at most 2 preps ahead, so a slot's previous dispatch
        has resolved before the slot comes around again)."""
        ring = self._staging.get(size)
        if (
            ring is None
            or ring[0][0].shape[1] != self.u8_cols
            or len(ring) < self.pipeline_depth + 2
        ):
            ring = [
                (
                    np.empty((size, self.u8_cols), dtype=np.uint8),
                    np.empty((size, I32_COLS), dtype=np.int32),
                )
                for _ in range(self.pipeline_depth + 2)
            ]
            self._staging[size] = ring
            self._staging_idx[size] = 0
        i = self._staging_idx[size]
        self._staging_idx[size] = (i + 1) % len(ring)
        return ring[i]

    def reset_staging(self) -> None:
        """Re-arm the staging ring after a poisoned window: the ring
        cursor no longer matches the in-flight count once a dispatch or
        resolve failed, so the old ring is dropped, not rewritten, and the
        next _stage() builds fresh slots."""
        self._staging.clear()
        self._staging_idx.clear()

    # -- dispatch seam hooks ---------------------------------------------
    # dispatch_prepped and warmup route every placement decision through
    # these overridables, as the reference's do, so a multi-card subclass
    # inherits the prep/staging/containment machinery unchanged. The mask
    # stays a pure function of (vertex bytes, registry) under every
    # override.

    def _round_bucket(self, b: int) -> int:
        """Final padded-size adjustment (the identity on one card)."""
        return int(b)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host staging array -> device input (a synchronous copy: the
        slot is not read again after this returns)."""
        return torch.from_numpy(arr).to(self.device)

    def _comb_tables_dev(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(key_tables, b_table) placed where the dispatch needs them."""
        return self.comb_tables()

    def _comb_fn(self):
        """The comb entry point for this verifier's window width."""
        return device_verify_comb8 if self._comb_bits == 8 else device_verify_comb

    def _windowed_dispatch(self, args: tuple) -> torch.Tensor:
        """The ``comb=False`` oracle path's device call over the nine prep
        arrays."""
        return device_verify_windowed(*(self._put(a) for a in args))

    def _note_dispatch(self, size: int, count: int) -> None:
        """Per-dispatch gauge hook (a multi-card subclass books shard
        balance)."""

    def _enqueue(self, args: tuple, count: int) -> Pending:
        """Copy one prepped batch to the device and launch its program on
        the current stream, no sync."""
        t0 = time.perf_counter()
        if self._comb:
            u8, i32 = args
            tables, b_tab = self._comb_tables_dev()
            mask = self._comb_fn()(self._put(u8), self._put(i32), tables, b_tab)
        else:
            mask = self._windowed_dispatch(args)
        event = None
        if mask.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(mask.device))
        return Pending(mask, count, event, t0)

    def warmup(self, bucket: Optional[int] = None) -> float:
        """Make the first real dispatch at ``bucket`` rows (default: the
        fixed bucket, else the smallest) pay nothing once: build the CUDA
        libraries (nvcc) on the card, build the comb tables, load the
        native challenge library when ``DAGRIDER_NATIVE`` is on, and run
        one all-padding dispatch at that size, which books none of the
        ``total_*`` counters. The counterpart of the reference's AOT
        compile. Returns the seconds spent (cumulative in
        ``warmup_compile_s``); 0.0 when the size is already warm, and on
        the windowed path, which is never on the hot path (as in the
        reference)."""
        if not self._comb:
            return 0.0
        size = self._round_bucket(int(bucket or self.fixed_bucket or _MIN_BUCKET))
        if size in self._warm:
            return 0.0
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from dag_rider_tpu_torch.ops import cuda_group, cuda_group381

            cuda_group.lib()
            cuda_group381.lib()
        self._comb_tables_dev()
        if _native_enabled():
            native.load()
        pending = self._enqueue(self._prepare([], size), 0)
        if pending.event is not None:
            pending.event.synchronize()
        self._warm.add(size)
        dt = time.perf_counter() - t0
        self.warmup_compile_s += dt
        return dt

    #: host-prep / device seconds of the most recent dispatch (prep on the
    #: host; enqueue to mask on the host for the device)
    last_prepare_s: float = 0.0
    last_dispatch_s: float = 0.0

    #: Cumulative verifier-seam accounting across a whole run: wall
    #: seconds in host prep and in resolve, over how many dispatches and
    #: signatures (warmup() books none of them).
    total_prepare_s: float = 0.0
    total_dispatch_s: float = 0.0
    total_dispatches: int = 0
    total_sigs_dispatched: int = 0

    #: When set, every dispatch pads to exactly this bucket and
    #: :meth:`verify_rounds` chunks larger merges into it.
    fixed_bucket: Optional[int] = None

    #: False forces every consumer (Simulation.run, the chunk-streaming
    #: verify_rounds, a wrapping VerifierPipeline) onto the synchronous
    #: depth-1 dispatch-then-resolve shape.
    pipeline_enabled: bool = True

    #: Next-tier verifier for chunks quarantined out of a poisoned
    #: window; None = one serial retry on this verifier, then fail closed
    #: for that chunk.
    quarantine_verifier: Optional[Verifier] = None

    #: Fault-containment gauges: windows poisoned by a prep, dispatch or
    #: resolve exception, chunks re-verified in quarantine, and quarantine
    #: retries that failed too (those chunks read all-False).
    poisoned_windows: int = 0
    quarantined_chunks: int = 0
    quarantine_rejected: int = 0

    #: Requested worker count for the parallel host-prep engine. None
    #: defers to DAGRIDER_PREP_WORKERS (default 1 = serial). A new value
    #: rebuilds the engine on the next prep — reassign between runs only.
    prep_workers: Optional[int] = None

    def _prep(self) -> PrepEngine:
        """The verifier's prep engine, (re)built lazily so a
        ``prep_workers`` override picked up between runs takes effect."""
        want = int(self.prep_workers) if self.prep_workers is not None else None
        eng = self._prep_engine
        if eng is None or (want is not None and eng.workers != want):
            if eng is not None:
                eng.close()
            eng = self._prep_engine = PrepEngine(want)
        return eng

    def prep_stats(self) -> dict:
        """Gauges of the parallel host-prep engine; ``parallel_fraction``
        is the share of prepped rows that took the row-block pool."""
        eng = self._prep()
        return {
            "workers": eng.workers,
            "last_blocks": eng.last_blocks,
            "parallel_fraction": eng.parallel_fraction(),
            "rows_total": eng.rows_total,
            "rows_parallel": eng.rows_parallel,
            "serial_retries": eng.serial_retries,
        }

    def _size_for(self, count: int) -> int:
        if self.fixed_bucket and count <= self.fixed_bucket:
            return self._round_bucket(int(self.fixed_bucket))
        return self._round_bucket(_bucket(count))

    def prepare_batch(self, vertices: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """The host arrays of one dispatch of ``vertices`` (bucket-padded),
        freshly allocated (not a staging slot)."""
        return self._prepare(vertices, self._size_for(len(vertices)))

    def prep_batch(self, vertices: Sequence) -> PreppedBatch:
        """Host half of :meth:`dispatch_batch`: bucket selection,
        staging-slot claim, and the (possibly row-parallel) _prepare. No
        torch work, so it may run on the prep engine's seam thread
        (:meth:`prep_batch_async`); the seam serializes preps FIFO, so
        ring slots are claimed strictly in chunk order."""
        size = self._size_for(len(vertices))
        t0 = time.perf_counter()
        out = self._stage(size) if self._comb else None
        args = self._prepare(vertices, size, out=out)
        return PreppedBatch(args, size, len(vertices), time.perf_counter() - t0)

    def prep_batch_async(self, vertices: Sequence):
        """:meth:`prep_batch` queued on the engine's FIFO seam thread;
        returns a Future of the PreppedBatch. Callers keep at most 2 preps
        outstanding and submit a new one only after the window drained
        below depth (see _stage())."""
        return self._prep().submit(self.prep_batch, vertices)

    def dispatch_prepped(self, prepped: PreppedBatch) -> Pending:
        """Device half of :meth:`dispatch_batch`: copy and launch an
        already-prepped batch, no sync. Books the prep accounting carried
        in the handle, so counters change only on the dispatching thread."""
        args, size, count, prep_s = prepped
        self.last_prepare_s = prep_s
        self.total_prepare_s += prep_s
        self.total_dispatches += 1
        self.total_sigs_dispatched += count
        self._note_dispatch(size, count)
        return self._enqueue(args, count)

    def dispatch_batch(self, vertices: Sequence) -> Pending:
        """Host prep + device enqueue, no sync. Returns a handle for
        :meth:`resolve_batch`."""
        return self.dispatch_prepped(self.prep_batch(vertices))

    # -- fault containment --------------------------------------------------

    def _quarantine(self, vertices: Sequence) -> List[bool]:
        """Re-verify a chunk out of a poisoned window exactly once: on the
        next tier when one is wired (quarantine_verifier), else a fresh
        serial dispatch on this verifier. A second failure rejects the
        chunk — fail closed, never fail open."""
        self.quarantined_chunks += 1
        vs = list(vertices)
        try:
            if self.quarantine_verifier is not None:
                return self.quarantine_verifier.verify_batch(vs)
            return self._resolve_timed(self.dispatch_batch(vs))
        except Exception:  # noqa: BLE001 — second failure fail-closes
            self.quarantine_rejected += 1
            return [False] * len(vs)

    def _contain_stream(self, inflight, chunk: Sequence, failed_first: bool) -> List[bool]:
        """Contain a fault in the chunk-streaming window: salvage every
        in-flight entry (resolve it; a second fault quarantines that chunk
        too), re-arm the staging ring, then quarantine the failing chunk.
        Returns the masks in FIFO chunk order — ``failed_first`` is True
        for a resolve fault (the failed chunk was the oldest, already
        popped) and False for a prep/dispatch fault (the failed chunk
        never entered the window, so salvaged chunks come first)."""
        self.poisoned_windows += 1
        salvaged = []  # (mask-or-None, chunk) in FIFO order
        while inflight:
            h, ch = inflight.popleft()
            try:
                salvaged.append((self._resolve_timed(h), ch))
            except Exception:  # noqa: BLE001 — quarantined after reset
                salvaged.append((None, ch))
        self.reset_staging()
        out: List[bool] = []
        if failed_first:
            out.extend(self._quarantine(chunk))
        for m, ch in salvaged:
            out.extend(m if m is not None else self._quarantine(ch))
        if not failed_first:
            out.extend(self._quarantine(chunk))
        return out

    def _resolve_stream(self, inflight) -> List[bool]:
        """Resolve the oldest in-flight chunk, containing a resolve fault."""
        h, ch = inflight.popleft()
        try:
            return self._resolve_timed(h)
        except Exception:  # noqa: BLE001 — contained, not propagated
            return self._contain_stream(inflight, ch, failed_first=True)

    def verify_rounds(self, rounds: Sequence[Sequence]) -> List[List[bool]]:
        """Verify several DAG rounds in one merged padded dispatch; the
        mask is split back per round.

        Merges larger than ``fixed_bucket`` stream their chunks through a
        depth-K window (K = pipeline_depth; 1 when pipeline_enabled is
        off): chunk k+1's host prep overlaps chunk k's device execution,
        and with the window open, prep runs ahead on the prep engine's
        seam thread (at most 2 preps outstanding). Chunk boundaries and
        FIFO resolve order are fixed, so the mask is byte-identical. A
        prep/dispatch/resolve exception is contained, not propagated: the
        window is salvaged, the staging ring re-armed, and the failing
        chunk quarantined — the merge always returns a full mask."""
        lens = [len(r) for r in rounds]
        flat = [v for r in rounds for v in r]
        if not flat:
            return [[] for _ in rounds]
        cap = self.fixed_bucket
        if cap and len(flat) > cap:
            depth = self.pipeline_depth if self.pipeline_enabled else 1
            chunks = [flat[i : i + cap] for i in range(0, len(flat), cap)]
            inflight: deque = deque()  # (pending handle, chunk) FIFO
            mask: List[bool] = []
            if depth > 1 and len(chunks) > 1:
                # when prep(j) claims ring slot j mod (depth + 2), the
                # slot's previous claimant (chunk j - depth - 2) has
                # already resolved: at most 2 preps are outstanding, and a
                # new one is queued only after the window drained below
                # depth and the current chunk dispatched
                preps: deque = deque()
                nxt = 0
                while nxt < len(chunks) and len(preps) < 2:
                    preps.append((self.prep_batch_async(chunks[nxt]), chunks[nxt]))
                    nxt += 1
                while preps:
                    fut, chunk = preps.popleft()
                    try:
                        prepped = fut.result()
                    except Exception:  # noqa: BLE001 — prep fault
                        mask.extend(self._contain_stream(inflight, chunk, failed_first=False))
                        prepped = None
                    if prepped is not None:
                        while len(inflight) >= depth:
                            mask.extend(self._resolve_stream(inflight))
                        try:
                            inflight.append((self.dispatch_prepped(prepped), chunk))
                        except Exception:  # noqa: BLE001 — dispatch fault
                            mask.extend(
                                self._contain_stream(inflight, chunk, failed_first=False)
                            )
                    if nxt < len(chunks):
                        preps.append((self.prep_batch_async(chunks[nxt]), chunks[nxt]))
                        nxt += 1
            else:
                for chunk in chunks:
                    while len(inflight) >= depth:
                        mask.extend(self._resolve_stream(inflight))
                    try:
                        inflight.append((self.dispatch_batch(chunk), chunk))
                    except Exception:  # noqa: BLE001 — prep/dispatch fault
                        mask.extend(self._contain_stream(inflight, chunk, failed_first=False))
            while inflight:
                mask.extend(self._resolve_stream(inflight))
        else:
            mask = self.verify_batch(flat)
        out, pos = [], 0
        for ln in lens:
            out.append(mask[pos : pos + ln])
            pos += ln
        return out

    def resolve_batch(self, pending: Pending) -> List[bool]:
        """Blocking half: wait on the dispatch's event, then the mask as
        per-vertex host bools."""
        if pending.event is not None:
            pending.event.synchronize()
        out = pending.mask[: pending.count].cpu().tolist()
        self.last_dispatch_s = time.perf_counter() - pending.t_enqueue
        return out

    def _resolve_timed(self, pending: Pending) -> List[bool]:
        """resolve_batch plus the resolve wall in ``total_dispatch_s`` (the
        share of device time the host waited for; verify_batch and the
        chunk-streaming verify_rounds resolve through here)."""
        t0 = time.perf_counter()
        out = self.resolve_batch(pending)
        self.total_dispatch_s += time.perf_counter() - t0
        return out

    def verify_batch(self, vertices: Sequence) -> List[bool]:
        if not vertices:
            return []
        return self._resolve_timed(self.dispatch_batch(vertices))
