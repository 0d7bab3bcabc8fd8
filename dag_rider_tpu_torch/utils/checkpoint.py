"""Checkpoint / resume for a Process.

The port's copy of ``dag_rider_tpu/utils/checkpoint.py``.

The reference keeps all state in memory with no serialization (SURVEY.md
§5 "checkpoint/resume: absent"); a crashed reference process loses its DAG
and cannot rejoin. Here the DAG's dense tensor encoding doubles as the
checkpoint format (SURVEY.md §7): ``exists``/``strong`` go into one
compressed ``.npz``, vertex payloads/signatures ride the canonical wire
codec (core/codec.py), and scalar cursors (round, decided_wave, delivered
log) go into a JSON manifest. A resumed process continues from the exact
commit point: delivered_log, buffered vertices and pending blocks are all
restored, so no vertex is a_delivered twice across a crash.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Optional

import numpy as np

from dag_rider_tpu_torch.core import codec
from dag_rider_tpu_torch.core.types import Block, VertexID

MANIFEST = "manifest.json"
TENSORS = "dag.npz"
VERTICES = "vertices.bin"
MEMPOOL = "mempool.json"


class CorruptCheckpointError(ValueError):
    """A checkpoint directory failed validation before restore touched
    the process: torn manifest (kill -9 mid-save on a pre-atomic-rename
    layout), sidecar hash mismatch, or undecodable vertex bytes. The
    caller's process is guaranteed untouched — the node runtime treats
    this as "no usable checkpoint", starts empty, and recovers via the
    snapshot-sync rejoin path."""


def present(path: str) -> bool:
    """Does ``path`` hold *something that claims to be* a checkpoint?

    Distinct from :func:`latest_round` (which answers None for both
    "absent" and "unreadable"): the node runtime must distinguish a
    first boot (no manifest — start empty silently) from a torn or
    corrupt checkpoint (manifest present but restore fails — bump the
    ``checkpoint_corrupt`` counter so operators see the data loss)."""
    return os.path.exists(os.path.join(path, MANIFEST))


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_atomic(path: str, writer) -> str:
    """Write via ``writer(fh)`` to ``path + ".tmp"``, fsync, rename into
    place. Returns the sha256 hex of the written bytes. A kill -9 at any
    point leaves either the previous file or the new one — never a torn
    hybrid (os.replace is atomic on POSIX)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        writer(fh)
        fh.flush()
        os.fsync(fh.fileno())
    digest = _file_sha256(tmp)
    os.replace(tmp, path)
    return digest


def save(process, path: str, *, mempool=None) -> None:
    """Write a consistent snapshot of ``process`` into directory ``path``.

    Must be called from the process's own thread (the state machine is
    synchronous — SURVEY.md D4's fix keeps all mutation on one thread, so
    a call between step()s sees a consistent state).

    ``mempool``: a :class:`dag_rider_tpu_torch.mempool.Mempool`
    whose pending (accepted-but-not-yet-batched) transactions ride a
    sibling ``mempool.json`` — restart must lose no accepted
    transaction. Batched-but-undelivered payloads are already covered
    by ``blocks_to_propose`` / the DAG payloads in this snapshot, so
    pool + manifest together account for every accepted byte.
    """
    os.makedirs(path, exist_ok=True)
    exists, strong = process.dag.dense_snapshot()

    # Sidecars first, each atomically (tmp + fsync + rename), manifest
    # LAST: the manifest rename is the commit point. A kill -9 anywhere
    # in this sequence leaves either the previous complete checkpoint or
    # the new one — the only torn window is "new sidecars under the old
    # manifest", which the manifest's sidecar hashes detect at restore
    # (CorruptCheckpointError -> node starts empty and rejoins via
    # snapshot sync; accepted transactions are covered by the WAL, not
    # the checkpoint, so this loses no data).
    def _write_tensors(fh):
        np.savez_compressed(fh, exists=exists, strong=strong)

    def _write_vertices(fh):
        for v in process.dag.vertices.values():
            payload = codec.encode_vertex(v)
            fh.write(struct.pack("<I", len(payload)))
            fh.write(payload)
        # buffered (not yet admitted) vertices, tagged separately
        for v in process.buffer:
            payload = codec.encode_vertex(v)
            fh.write(struct.pack("<I", len(payload) | 0x80000000))
            fh.write(payload)

    hashes = {
        TENSORS: _write_atomic(os.path.join(path, TENSORS), _write_tensors),
        VERTICES: _write_atomic(
            os.path.join(path, VERTICES), _write_vertices
        ),
    }
    if mempool is not None:
        pool_state = mempool.checkpoint_state()

        def _write_mempool(fh):
            fh.write(json.dumps(pool_state).encode())

        hashes[MEMPOOL] = _write_atomic(
            os.path.join(path, MEMPOOL), _write_mempool
        )
    manifest = {
        "version": 1,
        "index": process.index,
        "n": process.cfg.n,
        "round": process.round,
        "decided_wave": process.decided_wave,
        # GC window cursors (absent in older manifests -> defaults):
        # the vertex payloads above only cover rounds >= base_round, so a
        # pruned node's checkpoint is automatically compacted to the live
        # window.
        "base_round": process.dag.base_round,
        "delivered_trimmed": process.delivered_trimmed,
        "delivered_log": [
            [vid.round, vid.source] for vid in process.delivered_log
        ],
        "waves_tried": sorted(process._waves_tried),
        "pending_waves": sorted(process._pending_waves),
        "blocks_to_propose": [
            [tx.hex() for tx in b.transactions]
            for b in process.blocks_to_propose
        ],
        # Certificate-path books: settled rounds must survive
        # a restart or a resumed aggregator would re-gossip certificates
        # (harmless but noisy) and a resumed receiver would re-pool
        # settled rounds. Banked span certs ride the canonical cert
        # codec as hex so a mid-epoch span aggregator resumes banking
        # instead of silently abandoning the epoch. Absent in older
        # manifests -> empty defaults.
        "cert_done": sorted(process._cert_done),
        "certs_sent": sorted(process._certs_sent),
        "spans_sent": sorted(process._spans_sent),
        "span_done": sorted(process._span_done),
        "span_bank": {
            str(e): [
                codec.encode_certificate(bank[r]).hex() for r in sorted(bank)
            ]
            for e, bank in process._span_bank.items()
        },
        "metrics": process.metrics.snapshot(),
        # Epoch reconfiguration cursor: epoch id, chained
        # seed, pending boundary + op batch. None/absent (pre-epoch
        # manifests) restores as static membership / epoch 0.
        "epoch": process.epoch_state(),
    }
    # Lane state: certified batch bytes + sequence cursor. A
    # crash between certification and delivery must not lose the payload
    # — the carrier ref in the DAG snapshot only names the digest; the
    # bytes live in the lane store. Pending (mid-dissemination) blocks
    # need no lane entry: ``blocks_to_propose`` above serialized their
    # original transactions, so restore degrades them to the inline
    # path. Absent in pre-lanes manifests -> lanes restore empty.
    if getattr(process, "lanes", None) is not None:
        manifest["lanes"] = process.lanes.checkpoint_state()
    # Sidecar digests: restore verifies these before touching the
    # process, so "old manifest over new sidecars" (or bit rot) is
    # detected instead of silently restoring a frankenstate.
    manifest["sha256"] = hashes

    def _write_manifest(fh):
        fh.write(json.dumps(manifest).encode())

    _write_atomic(os.path.join(path, MANIFEST), _write_manifest)


def restore(process, path: str, *, mempool=None) -> None:
    """Load a snapshot into a freshly constructed (same cfg/index) Process.

    The process must not have been started; its genesis-only DAG is
    replaced wholesale by the checkpointed one.

    ``mempool``: re-admits the checkpoint's pending transaction set
    (see :func:`save`); older checkpoints have no
    ``mempool.json`` and restore cleanly with an empty pool.

    Raises :class:`CorruptCheckpointError` (a ValueError subclass) when
    the directory fails validation — torn/unparseable manifest, sidecar
    hash mismatch, undecodable vertex bytes, out-of-bounds cursors. All
    validation runs BEFORE the process is mutated: on any raise the
    caller's (genesis-only) process is untouched and safe to run empty.
    """
    try:
        with open(os.path.join(path, MANIFEST)) as fh:
            manifest = json.load(fh)
        if not isinstance(manifest, dict):
            raise ValueError("manifest is not an object")
    except (OSError, ValueError) as exc:
        raise CorruptCheckpointError(
            f"unreadable checkpoint manifest in {path}: {exc}"
        ) from exc
    try:
        n_claim, idx_claim = manifest["n"], manifest["index"]
    except KeyError as exc:
        raise CorruptCheckpointError(
            f"checkpoint manifest missing key {exc}"
        ) from exc
    if n_claim != process.cfg.n or idx_claim != process.index:
        raise ValueError(
            "checkpoint is for a different committee/process: "
            f"n={n_claim} index={idx_claim}"
        )
    # Sidecar integrity gate (absent in older manifests): a
    # kill -9 between sidecar and manifest renames leaves the OLD
    # manifest naming hashes the NEW sidecars no longer match.
    for name, want in (manifest.get("sha256") or {}).items():
        side = os.path.join(path, str(name))
        try:
            got = _file_sha256(side)
        except OSError as exc:
            raise CorruptCheckpointError(
                f"checkpoint sidecar {name} unreadable: {exc}"
            ) from exc
        if got != want:
            raise CorruptCheckpointError(
                f"checkpoint sidecar {name} hash mismatch "
                f"(manifest {want[:12]}.., file {got[:12]}..)"
            )
    try:
        with open(os.path.join(path, VERTICES), "rb") as fh:
            data = fh.read()
        offset = 0
        admitted, buffered = [], []
        while offset < len(data):
            (tag,) = struct.unpack_from("<I", data, offset)
            offset += 4
            ln = tag & 0x7FFFFFFF
            v, _ = codec.decode_vertex(data[offset : offset + ln])
            offset += ln
            (buffered if tag & 0x80000000 else admitted).append(v)
    except (OSError, struct.error, ValueError, IndexError) as exc:
        raise CorruptCheckpointError(
            f"checkpoint vertex log undecodable: {exc}"
        ) from exc
    # Cursor/bounds validation BEFORE any mutation (the raise-after-
    # reset path would otherwise leave the caller's process torn).
    try:
        base_claim = int(manifest.get("base_round", 0))
        round_claim = int(manifest["round"])
        wave_claim = int(manifest["decided_wave"])
        delivered_claim = [
            (int(r), int(s)) for r, s in manifest["delivered_log"]
        ]
        # epoch cursor: dry-parse before any mutation so a
        # torn epoch section fails the whole restore atomically
        epoch_claim = manifest.get("epoch")
        if epoch_claim is not None:
            int(epoch_claim.get("epoch", 0))
            bytes.fromhex(epoch_claim.get("seed") or "")
            for wave, kind, target, nonce, payload in epoch_claim.get(
                "pending_ops", []
            ):
                int(wave), str(kind), int(target), int(nonce)
                bytes.fromhex(payload)
    except (KeyError, TypeError, ValueError, AttributeError) as exc:
        raise CorruptCheckpointError(
            f"checkpoint manifest cursors invalid: {exc}"
        ) from exc
    top_claim = max(
        [base_claim] + [v.round for v in admitted], default=base_claim
    )
    n = process.cfg.n
    for r, s in delivered_claim:
        if not (0 <= s < n) or r < base_claim or r > top_claim:
            raise CorruptCheckpointError(
                f"corrupt checkpoint: delivered entry ({r}, {s}) out of "
                f"bounds for n={n}, base_round={base_claim}"
            )
    del round_claim, wave_claim  # validated for type only
    # Rebuild the DAG in round order so insert()'s invariants hold. The
    # admission gate re-runs for every round>=1 vertex: the hot paths
    # (dense-mirror fancy indexing in dag.insert / _drain_buffer) rely on
    # gate-validated edge bounds, and a corrupted or crafted checkpoint
    # must fail safe (vertex dropped) rather than alias numpy indices.
    process.dag.reset()
    process.dag.base_round = manifest.get("base_round", 0)
    process.dag.max_round = process.dag.base_round
    process.delivered_trimmed = manifest.get("delivered_trimmed", 0)
    for v in sorted(admitted, key=lambda v: (v.round, v.source)):
        if v.round >= 1 and not process.edges_valid(v):
            process.log.event(
                "restore_drop_invalid", round=v.round, source=v.source
            )
            continue
        process.dag.insert(v)
        if v.round >= 1:
            process._note_seen(v)
            process._observe_coin_share(v)
    for v in buffered:
        if not process.edges_valid(v):
            process.log.event(
                "restore_drop_invalid", round=v.round, source=v.source
            )
            continue
        process._admit_to_buffer(v)
        process._note_seen(v)
    process.round = manifest["round"]
    process.decided_wave = manifest["decided_wave"]
    process._waves_tried = set(manifest["waves_tried"])
    # A wave pending on an unready coin at save time must re-enter
    # _try_wave after restore, or its direct commit is silently skipped.
    # Older manifests lack the key; recompute
    # conservatively: every tried-but-undecided wave re-arms (re-trying a
    # decided wave is a no-op — _try_wave guards on decided_wave).
    process._pending_waves = set(
        manifest.get(
            "pending_waves",
            [
                w
                for w in manifest["waves_tried"]
                if w > manifest["decided_wave"]
            ],
        )
    )
    # Bounds were pre-validated against the manifest's claimed window;
    # re-check against the dense state actually built (an edges_valid
    # drop can shrink max_round below the claim — a delivered entry
    # pointing past it would alias a numpy index into a silent order
    # divergence, so fail loudly instead).
    base = process.dag.base_round
    log = []
    for r, s in delivered_claim:
        if r > process.dag.max_round:
            raise CorruptCheckpointError(
                f"corrupt checkpoint: delivered entry ({r}, {s}) beyond "
                f"restored window top {process.dag.max_round}"
            )
        log.append(VertexID(r, s))
    process.delivered_log = log
    process._rebuild_delivered_mask()
    # A reliable-broadcast stage's slot floor must follow the restored
    # window, or replayed frames for retired rounds regrow its books
    # until the next wave decision prunes.
    tp_prune = getattr(process.transport, "prune_below", None)
    if tp_prune is not None:
        tp_prune(process.dag.base_round)
    process.blocks_to_propose.clear()
    for txs in manifest["blocks_to_propose"]:
        process.blocks_to_propose.append(
            Block(tuple(bytes.fromhex(tx) for tx in txs))
        )
    process._cert_done = set(manifest.get("cert_done", []))
    process._certs_sent = set(manifest.get("certs_sent", []))
    process._spans_sent = set(manifest.get("spans_sent", []))
    process._span_done = set(manifest.get("span_done", []))
    span_bank = {}
    for e, rows in manifest.get("span_bank", {}).items():
        bank = {}
        for hx in rows:
            c, _ = codec.decode_certificate(bytes.fromhex(hx))
            bank[c.round] = c
        span_bank[int(e)] = bank
    process._span_bank = span_bank
    # Lane store: entries are re-hashed on load (corrupt bytes dropped,
    # recovered later via fetch-on-miss). Pre-lanes manifests carry no
    # "lanes" key and restore with an empty store.
    if getattr(process, "lanes", None) is not None:
        process.lanes.restore_state(manifest.get("lanes"))
    if mempool is not None:
        mp_path = os.path.join(path, MEMPOOL)
        if os.path.exists(mp_path):
            with open(mp_path) as fh:
                mempool.restore_state(json.load(fh))
    # Epoch cursor last: restoring it rotates the coin schedule, which
    # must see the already-restored decided/wave state. Pre-epoch
    # manifests carry no key and leave the manager at epoch 0.
    process.restore_epoch_state(manifest.get("epoch"))


# ---------------------------------------------------------------------------
# Peer state transfer (snapshot sync) — the elastic-recovery path for a node
# that fell below the cluster's GC horizon (anti-entropy sync is refused for
# pruned windows; see Process._serve_sync / _on_sync_nack).
#
# Trust model: the donor is UNTRUSTED. The snapshot carries only
# self-certifying data — the donor's live vertex window (every round>=1
# vertex is Ed25519-signed by its author) plus the window floor. The
# receiver verifies every signature, re-runs the admission gate, and
# REPLAYS consensus locally (coin shares ride on the vertices), so
# decided/delivered state is recomputed, never imported. A lying floor
# (higher than honest) would shrink the window below gc_depth and is
# rejected; a censored window breaks admission/quorum chains and fails the
# same check — the caller then tries another peer.
# ---------------------------------------------------------------------------


def snapshot_bytes(process) -> bytes:
    """Serialize the live DAG window for peer state transfer.

    May be called from a serving thread (the Snapshot RPC handler) while
    the pump thread mutates the DAG: the vertex objects are immutable, so
    the only hazard is the dict changing size mid-copy — retried with a
    base-cursor consistency check (a single C-level ``list()`` copy per
    attempt keeps the race window tiny)."""
    for _ in range(8):
        base = process.dag.base_round
        try:
            vertices = list(process.dag.vertices.values())
        except RuntimeError:  # resized mid-iteration: retry
            continue
        top = process.dag.max_round
        if process.dag.base_round != base:
            continue  # pruned mid-copy: the window moved, retry
        head_obj = {
            "version": 1,
            "n": process.cfg.n,
            "base_round": base,
            "max_round": top,
        }
        # Epoch cursor: the joiner must land on the donor's
        # epoch + chained seed or its rotated coin keys diverge from the
        # survivors'. Omitted entirely pre-epoch, so epoch-less
        # snapshots stay byte-identical to the previous format.
        _es = getattr(process, "epoch_state", None)
        epoch_state = _es() if _es is not None else None
        if epoch_state is not None:
            head_obj["epoch"] = epoch_state
        head = json.dumps(head_obj).encode()
        out = [struct.pack("<I", len(head)), head]
        for v in vertices:
            if v.round < base:
                continue  # retired while copying
            payload = codec.encode_vertex(v)
            out.append(struct.pack("<I", len(payload)))
            out.append(payload)
        return b"".join(out)
    return b""  # persistently racing prunes: refuse this request


# -- span-attested snapshot envelope -----------------------------
#
# Layout: magic, u32 span count, then each span certificate u32-length-
# prefixed in the canonical cert codec, then the plain snapshot blob.
# A plain (un-enveloped) blob is still accepted everywhere — attestation
# is an overlay, exactly like the span path it reuses: the receiver pays
# ONE combined pairing check per span and may then admit every vertex
# whose digest the verified span restates WITHOUT a per-vertex signature
# check (the quorum already BLS-co-signed those digests), instead of
# replaying the window vertex by vertex.

SNAP_ATTEST_MAGIC = b"DRsnapA1"


def wrap_attested(blob: bytes, spans) -> bytes:
    """Envelope ``blob`` with its attesting span-certificate chain."""
    out = [SNAP_ATTEST_MAGIC, struct.pack("<I", len(spans))]
    for s in spans:
        enc = codec.encode_span_certificate(s)
        out.append(struct.pack("<I", len(enc)))
        out.append(enc)
    out.append(blob)
    return b"".join(out)


def unwrap_attested(data: bytes):
    """Split an attested envelope into (spans, inner blob).

    Plain blobs pass through as ``(None, data)``. A magic-prefixed blob
    that does not parse cleanly — truncated span section, trailing
    garbage inside a span, short header — raises ValueError: a torn
    envelope must refuse wholesale, never degrade to "unattested"."""
    if not data.startswith(SNAP_ATTEST_MAGIC):
        return None, data
    off = len(SNAP_ATTEST_MAGIC)
    if off + 4 > len(data):
        raise ValueError("attested snapshot: truncated span count")
    (count,) = struct.unpack_from("<I", data, off)
    off += 4
    spans = []
    for _ in range(count):
        if off + 4 > len(data):
            raise ValueError("attested snapshot: truncated span section")
        (ln,) = struct.unpack_from("<I", data, off)
        off += 4
        if off + ln > len(data):
            raise ValueError("attested snapshot: span overruns envelope")
        span, used = codec.decode_span_certificate(data[off : off + ln])
        if used != ln:
            raise ValueError("attested snapshot: span section malformed")
        spans.append(span)
        off += ln
    return spans, data[off:]


def attested_snapshot_bytes(process) -> bytes:
    """:func:`snapshot_bytes` enveloped with the donor's verified span
    chain (``Process._span_chain``) for the covered window. Falls back
    to the plain blob when the donor holds no spans (span path off, or
    a window younger than the first assembled span)."""
    blob = snapshot_bytes(process)
    if not blob:
        return b""
    chain = getattr(process, "_span_chain", None)
    if not chain:
        return blob
    base = process.dag.base_round
    spans = [
        chain[e] for e in sorted(chain) if chain[e].last_round > base
    ]
    if not spans:
        return blob
    process.metrics.inc("snapshot_spans_attached", len(spans))
    process.log.event(
        "snapshot_attested", spans=len(spans), base=base
    )
    return wrap_attested(blob, spans)


def restore_from_snapshot(
    process, blob: bytes, verifier=None, span_verifier=None
) -> bool:
    """Rebuild a process (fresh OR live-but-stuck — the node runtime
    calls this on its started process from the pump thread) from an
    untrusted peer snapshot. ATOMIC: the window is validated and staged
    into a scratch DagState first, and the process is only touched on
    full success — a malicious or broken snapshot returns False with the
    caller's state completely intact (a single Byzantine donor must not
    be able to wipe a victim's live DAG).

    Refused outright (False) when: cfg.gc_depth is None (the exclusion
    rule is what makes the import sound), the claimed floor does not
    strictly exceed our round (a no-progress/rewind snapshot would
    duplicate deliveries — normal sync covers that case), the window is
    thinner than gc_depth after filtering, a duplicate (round, source)
    appears, or the bytes/committee are wrong.

    ``verifier``: the Verifier seam used to batch-check every round>=1
    vertex signature; None skips signature checks (signature-less
    deployments only — matching the reference's no-crypto mode).

    ``span_verifier``: a CertVerifier used to check an
    attested envelope's span chain — one combined pairing per span.
    Vertices whose digests a verified span restates are admitted
    without a per-vertex signature check (the quorum already BLS-
    co-signed those digests); a digest mismatch against a verified span
    means the donor tampered with the window and refuses it wholesale.
    With ``span_verifier=None`` the envelope's spans are ignored and
    every vertex pays the ordinary signature check — attestation only
    ever removes work, never trust.
    """
    from dag_rider_tpu_torch.consensus.dag_state import DagState
    from dag_rider_tpu_torch.core.types import Vertex as _V

    try:
        spans, blob = unwrap_attested(blob)
    except (ValueError, struct.error):
        # torn or tampered envelope: refused wholesale, never degraded
        # to "unattested"
        process.metrics.inc("snapshot_attest_rejects")
        process.log.event("snapshot_attest_reject", reason="envelope")
        return False
    try:
        (hlen,) = struct.unpack_from("<I", blob, 0)
        head = json.loads(blob[4 : 4 + hlen])
        offset = 4 + hlen
        vertices = []
        while offset < len(blob):
            (ln,) = struct.unpack_from("<I", blob, offset)
            offset += 4
            v, _ = codec.decode_vertex(blob[offset : offset + ln])
            offset += ln
            vertices.append(v)
    except Exception:
        return False
    if not isinstance(head, dict):
        return False  # valid JSON, wrong shape (e.g. a bare list/number)
    if head.get("n") != process.cfg.n or head.get("version") != 1:
        return False
    try:
        base = int(head.get("base_round", 0))
        head_max = int(head.get("max_round", 1 << 62))
        # dry-parse the optional epoch section BEFORE any
        # commit below — a malformed section refuses wholesale, it must
        # never leave the DAG imported under the wrong coin keys
        _ep = head.get("epoch")
        if _ep is not None:
            int(_ep.get("epoch", 0))
            bytes.fromhex(_ep.get("seed") or "")
            for _w, _k, _t, _nc, _pl in _ep.get("pending_ops", []):
                int(_w), str(_k), int(_t), int(_nc)
                bytes.fromhex(_pl)
    except (TypeError, ValueError, AttributeError, KeyError):
        return False
    if base < 0:
        return False
    gc = process.cfg.gc_depth
    if gc is None:
        # State transfer is only sound under the GC ordering-exclusion
        # rule (it is what makes rounds below the floor undeliverable
        # everywhere); without it, importing a window and resetting
        # delivery state could duplicate or lose deliveries.
        return False
    if base <= process.round:
        # No-progress (or REWIND) snapshot: our round already covers the
        # claimed floor, so ordinary anti-entropy sync can serve us — and
        # accepting it would reset delivered state for rounds we already
        # emitted (duplicate a_deliver). Only windows strictly above our
        # progress are state-transfer material.
        return False
    # Span attestation: verify the chain — ONE combined
    # pairing per span — then fold every attested (round, source) ->
    # digest claim into a lookup the admission pass below consults.
    span_good = {}
    if spans is not None and span_verifier is not None:
        for s in spans:
            process.metrics.inc("snapshot_pairing_checks")
            if not span_verifier.verify_span(s):
                process.metrics.inc("snapshot_attest_rejects")
                process.log.event(
                    "snapshot_attest_reject",
                    reason="span",
                    first_round=s.first_round,
                )
                return False
            process.metrics.inc("snapshot_spans_verified")
            for i in range(len(s.signers)):
                r = s.first_round + i
                for src, dg in zip(s.signers[i], s.digests[i]):
                    span_good[(r, src)] = dg
    signed = [v for v in vertices if v.round >= 1]
    if span_good:
        # Attested digests substitute for per-vertex signature checks:
        # the span's quorum BLS-co-signed exactly these (round, source,
        # digest) claims, so a byte-identical vertex needs no second
        # proof of authorship — this is what makes a joiner's sync cost
        # ~1 pairing per settled span instead of a vertex-by-vertex
        # replay. A MISMATCHED digest is donor tampering: refuse.
        need, pre = [], set()
        for v in signed:
            want = span_good.get((v.round, v.source))
            if want is None:
                need.append(v)
            elif want == (v.__dict__.get("_digest") or v.digest()):
                pre.add(v.id)
            else:
                process.metrics.inc("snapshot_attest_rejects")
                process.log.event(
                    "snapshot_attest_reject",
                    reason="digest",
                    round=v.round,
                    source=v.source,
                )
                return False
    else:
        need, pre = signed, set()
    if verifier is not None:
        ok = verifier.verify_batch(need)
        good = pre | {v.id for v, m in zip(need, ok) if m}
    else:
        good = {v.id for v in signed}
    usable = [
        v
        for v in sorted(vertices, key=lambda v: (v.round, v.source))
        if v.round >= max(base, 1)
        and v.id in good
        and process.edges_valid(v)
    ]

    # ---- stage into a scratch DAG (the live process stays untouched) ----
    staged = DagState(process.cfg)
    staged.base_round = base
    staged.max_round = base
    have: set = set()
    if base == 0:
        for i in range(process.cfg.n):
            staged.insert(_V(id=VertexID(0, i)))
        have = {(0, i) for i in range(process.cfg.n)}
    accepted = []
    for v in usable:
        # Edges must be satisfied within the snapshot itself (round base
        # is the axiom row — its predecessors were retired by the donor's
        # GC, which the ordering-exclusion rule already finalized; weak
        # targets at or below the floor are final for the same reason).
        if v.round > base:
            _, ss, wr, ws = v.edge_arrays()
            if any((v.round - 1, int(s)) not in have for s in ss) or any(
                int(r) > base and (int(r), int(s2)) not in have
                for r, s2 in zip(wr, ws)
            ):
                continue
        try:
            staged.insert(v)
        except ValueError:
            # duplicate (round, source) in the snapshot: an equivocating
            # pair smuggled past the donor's RBC, or plain corruption —
            # either way the window is ambiguous; refuse it wholesale
            # (the ATOMIC contract: the live process stays untouched).
            return False
        have.add((v.round, v.source))
        accepted.append(v)
    top = staged.max_round
    if top > head_max:
        return False  # header inconsistent with its own payload
    # Window-width check: an honest donor's window spans >= gc_depth
    # rounds AFTER filtering (floor = decided_r1 - gc_depth and the
    # frontier sits at or above decided_r1). A lying floor, a censored
    # window, or broken admission chains all fail here and the snapshot
    # is refused wholesale. (gc is non-None here — gc-less configs were
    # refused up front.)
    if top - base < gc:
        return False

    # ---- commit: swap the staged window in and reset replay state ----
    # Replay cursors: the consensus state machine resumes at the
    # frontier; wave decisions from here retro-walk the imported window
    # (pruned leaders below the floor terminate the chain), and the GC
    # ordering rule keeps this node's deliveries the exact suffix every
    # correct process emits above the horizon. Live admission state from
    # the pre-transfer view (buffer, memos, pending verifies) is dropped
    # wholesale — live traffic re-supplies anything still relevant.
    process.dag = staged
    process.buffer = []
    process._buffered_ids = set()
    process._blocked_on = {}
    process._pending_verify = []
    process._pending_verify_ids = set()
    process._stuck_steps = 0
    process._seen_digests = {}
    for v in accepted:
        process._note_seen(v)
    for v in accepted:
        process._observe_coin_share(v)
    process.round = top
    process.decided_wave = 0
    process._waves_tried = set()
    process._pending_waves = set()
    process._deferred_orders.clear()
    process.delivered_log = []
    process.delivered_trimmed = 0
    process._rebuild_delivered_mask()
    process.state_transfer_needed = False
    process._horizon_nacks.clear()
    tp_prune = getattr(process.transport, "prune_below", None)
    if tp_prune is not None:
        tp_prune(base)
    if base >= 1:
        # a live laggard's pre-transfer share books are below the new
        # floor too (same class as the RBC books two lines up)
        process.coin.prune_below(process.cfg.wave_of_round(base))
    # Epoch cursor: land on the donor's epoch + seed so this
    # node's rotated coin keys match the survivors' — the snapshot head
    # is covered by the same trust argument as the window itself (a
    # lying epoch/seed diverges the coin and fails liveness locally,
    # never corrupts peers). Pre-epoch heads carry no key -> epoch 0.
    _res = getattr(process, "restore_epoch_state", None)
    if _res is not None:
        try:
            _res(head.get("epoch"))
        except (KeyError, TypeError, ValueError, AttributeError):
            # malformed epoch section from an untrusted donor: the DAG
            # import above is still sound (it never depended on epoch
            # state), so keep it and stay at the local epoch cursor
            process.log.event(
                "snapshot_attest_reject", reason="epoch_head"
            )
    inserted = len(accepted)
    process.metrics.inc("state_transfers")
    process.log.event(
        "state_transfer", base=base, top=top, vertices=inserted
    )
    return True


def latest_round(path: str) -> Optional[int]:
    """Peek a checkpoint's round cursor without loading it."""
    try:
        with open(os.path.join(path, MANIFEST)) as fh:
            return json.load(fh)["round"]
    except (OSError, KeyError, json.JSONDecodeError):
        return None
