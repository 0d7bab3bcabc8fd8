"""The general generator of the benchmark's inputs, and its work rule.

A cell is a configuration file (``configs/<name>.json``: the committee, its
vertices and the program's knobs) and a traffic file
(``traffic/<name>.json``: what one request holds and how it is chunked).
From them and ``--seed`` this module makes a fixed pool of signed vertex
rows that the window replays, and the request schedule over it. It imports
only the standard library, so the signing and reference workers can import
it without the program.

The work rule: the seed draws byte values only (the key seeds, the
transaction and coin-share bytes, which rows are corrupted and which bit
of their signed message flips). Every count and length (vertices a round,
rounds a request, strong and weak edges, transactions and their length,
the coin share's width and the rounds that carry one, corrupted rows a
round, chunk sizes) comes from the cell's files, so every seed costs the
same work. :func:`fingerprint` states that work and raises when two
requests of one pool differ in rows, dispatches or corrupted rows.

The signed message of a row is the canonical vertex encoding
(``b"dagrider-vertex-v1"``, the id, the block, the sorted strong and weak
edges, the coin share), written here from the cell's fields. A corrupted
row carries a signature made over its message with one bit flipped: the
vertex handed over is as honest as any other, passes every structural
check, is hashed and computed like any other row, and must be rejected.
"""

from __future__ import annotations

import hashlib
import json
import random
import struct
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
MIN_BUCKET = 16  # the smallest padded dispatch
KNOB_PREFIX = "DAGRIDER_"

_CONFIG_INTS = (
    "n", "f", "strong_edges", "weak_edges", "txs_per_block", "tx_bytes",
    "coin_share_bytes", "wave_length", "corrupt_per_round", "pool_rounds",
)
_TRAFFIC_KEYS = ("request_rounds", "chunks_per_request", "warm_s")


class Cell(NamedTuple):
    """One cell as the generator needs it: the two files' contents."""

    name: str
    config: dict
    traffic: dict


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def check_config(cfg: dict) -> dict:
    """Validate a configuration: the integers it must state, the
    committee's own rules (n = 3f + 1, 2f + 1 strong edges, weak edges
    only to sources outside the strong set) and the program's knobs
    (``DAGRIDER_*`` names, string values)."""
    name = cfg.get("name")
    for key in _CONFIG_INTS:
        if not isinstance(cfg.get(key), int) or cfg[key] < 0:
            raise ValueError(f"config {name}: {key} must be a whole number")
    n, f = cfg["n"], cfg["f"]
    if n != 3 * f + 1 or cfg["strong_edges"] != 2 * f + 1:
        raise ValueError(f"config {name}: want n = 3f + 1 and 2f + 1 strong edges")
    if cfg["weak_edges"] > n - cfg["strong_edges"]:
        raise ValueError(f"config {name}: at most n - (2f + 1) weak edges")
    if cfg["wave_length"] < 1 or cfg["pool_rounds"] < 1 or cfg["corrupt_per_round"] > n:
        raise ValueError(f"config {name}: wave_length, pool_rounds or corrupt_per_round")
    knobs = cfg.get("knobs", {})
    if not isinstance(knobs, dict) or not all(
            isinstance(k, str) and k.startswith(KNOB_PREFIX) and isinstance(v, str)
            for k, v in knobs.items()):
        raise ValueError(f"config {name}: knobs maps {KNOB_PREFIX}* names to strings")
    return cfg


def check_traffic(cfg: dict, traffic: dict) -> dict:
    for key in _TRAFFIC_KEYS:
        if key not in traffic:
            raise ValueError(f"traffic {traffic.get('name')}: missing {key}")
    rounds = request_rounds(cfg, traffic)
    if cfg["pool_rounds"] % rounds:
        raise ValueError("a request's rounds must divide the pool's rounds")
    if (rounds * cfg["n"]) % traffic["chunks_per_request"]:
        raise ValueError("the chunks must split a request's rows evenly")
    return traffic


def load_cell(bench: dict, workload: str, root: Path = HERE.parent) -> Cell:
    """The cell ``workload`` of a parsed BENCHMARK.json: its configuration
    file (the entry's ``file``) and its traffic file, found by name under
    ``traffic/``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = check_config(load_json(root / conf["file"]))
    traffic = check_traffic(cfg, load_json(HERE / "traffic" / f"{w['traffic']}.json"))
    return Cell(workload, cfg, traffic)


def request_rounds(cfg: dict, traffic: dict) -> int:
    r = traffic["request_rounds"]
    return cfg["pool_rounds"] if r == "pool" else int(r)


def chunk_rows(cfg: dict, traffic: dict) -> int:
    return request_rounds(cfg, traffic) * cfg["n"] // traffic["chunks_per_request"]


def padded(rows: int) -> int:
    """The padded size of a dispatch of ``rows``: the next power of two,
    at least :data:`MIN_BUCKET`."""
    b = MIN_BUCKET
    while b < rows:
        b *= 2
    return b


# -- the seeded fields ----------------------------------------------------


def _stream(seed: int, *tag) -> bytes:
    return "|".join(str(t) for t in (seed, *tag)).encode()


def key_seed(seed: int, source: int) -> bytes:
    return hashlib.shake_256(_stream(seed, "key", source)).digest(32)


def payload(seed: int, cfg: dict, rnd: int, source: int) -> bytes:
    """The block's transaction bytes of vertex (rnd, source), concatenated."""
    size = cfg["txs_per_block"] * cfg["tx_bytes"]
    return hashlib.shake_256(_stream(seed, "tx", rnd, source)).digest(size) if size else b""


def carries_share(cfg: dict, rnd: int) -> bool:
    """Whether round ``rnd``'s vertices carry a coin share: the last round
    of each wave, as the protocol's proposer attaches one."""
    return cfg["coin_share_bytes"] > 0 and rnd % cfg["wave_length"] == 0


def coin_share(seed: int, cfg: dict, rnd: int, source: int) -> bytes:
    """The coin share bytes of vertex (rnd, source), or b"" in a round that
    carries none."""
    if not carries_share(cfg, rnd):
        return b""
    return hashlib.shake_256(_stream(seed, "coin", rnd, source)).digest(cfg["coin_share_bytes"])


def transactions(cfg: dict, data: bytes) -> Tuple[bytes, ...]:
    w = cfg["tx_bytes"]
    return tuple(data[i : i + w] for i in range(0, len(data), w))


def strong_edges(cfg: dict, rnd: int) -> List[Tuple[int, int]]:
    """The 2f + 1 strong edges of every vertex of round ``rnd``: sources
    0 .. 2f of round rnd - 1, sorted."""
    return [(rnd - 1, s) for s in range(cfg["strong_edges"])]


def weak_edges(cfg: dict, rnd: int) -> List[Tuple[int, int]]:
    """The weak edges of every vertex of round ``rnd``: sources from 2f + 1
    up, which the strong edges leave out, of round rnd - 2 (round 0 for the
    first rounds), sorted."""
    lo = cfg["strong_edges"]
    return [(max(rnd - 2, 0), s) for s in range(lo, lo + cfg["weak_edges"])]


def message(cfg: dict, rnd: int, source: int, data: bytes, share: bytes = b"") -> bytes:
    """The canonical signed encoding of vertex (rnd, source) with block
    transactions ``data`` and coin share ``share`` (see the module
    docstring)."""
    txs = transactions(cfg, data)
    out = [b"dagrider-vertex-v1", struct.pack("<II", rnd, source), struct.pack("<I", len(txs))]
    for tx in txs:
        out.append(struct.pack("<I", len(tx)))
        out.append(tx)
    for label, edges in ((b"S", strong_edges(cfg, rnd)), (b"W", weak_edges(cfg, rnd))):
        out.append(label)
        out.append(struct.pack("<I", len(edges)))
        out.extend(struct.pack("<II", r, s) for r, s in sorted(edges))
    out.append(b"C")
    out.append(struct.pack("<I", len(share)))
    out.append(share)
    return b"".join(out)


def message_len(cfg: dict, rnd: int) -> int:
    """The length of every signed message of round ``rnd``."""
    share = b"\0" * cfg["coin_share_bytes"] if carries_share(cfg, rnd) else b""
    return len(message(cfg, rnd, 0, b"\0" * (cfg["txs_per_block"] * cfg["tx_bytes"]), share))


def corruptions(seed: int, cfg: dict, rnd: int) -> Dict[int, int]:
    """source -> the bit of the signed message that flips before signing,
    for the round's corrupted rows (``corrupt_per_round`` of them, at
    positions the seed draws)."""
    rng = random.Random(_stream(seed, "corrupt", rnd).decode())
    bits = message_len(cfg, rnd) * 8
    sources = rng.sample(range(cfg["n"]), cfg["corrupt_per_round"])
    return {s: rng.randrange(bits) for s in sorted(sources)}


def flip(data: bytes, bit: int) -> bytes:
    out = bytearray(data)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


class Row(NamedTuple):
    """One pool row as the benchmark made it: the vertex's round and
    source, its block bytes and coin share as handed to the program, and
    the bit of the signed message that was flipped before signing (-1 for
    an honest row)."""

    rnd: int
    source: int
    data: bytes
    share: bytes
    bad_bit: int

    @property
    def corrupted(self) -> bool:
        return self.bad_bit >= 0


def pool_rows(seed: int, cfg: dict, sources: Optional[Sequence[int]] = None) -> List[Row]:
    """The pool's rows, round-major (rounds 1 .. pool_rounds, sources
    0 .. n - 1), or only those of ``sources``."""
    keep = range(cfg["n"]) if sources is None else sources
    rows = []
    for rnd in range(1, cfg["pool_rounds"] + 1):
        bad = corruptions(seed, cfg, rnd)
        for s in keep:
            rows.append(Row(rnd, s, payload(seed, cfg, rnd, s), coin_share(seed, cfg, rnd, s),
                            bad.get(s, -1)))
    return rows


def row_message(cfg: dict, row: Row) -> bytes:
    return message(cfg, row.rnd, row.source, row.data, row.share)


# -- signing and the reference, in spawn workers ---------------------------


def sign_sources(seed: int, cfg: dict, sources: Sequence[int]):
    """Keys and signatures of ``sources`` (a spawn worker's share): returns
    (source -> public key, (rnd, source) -> signature over the row's
    message, with its bit flipped where the row is corrupted)."""
    from portbench import ed25519_ref as E

    keys = {s: E.expand(key_seed(seed, s)) for s in sources}
    pubs, sigs = {s: k[2] for s, k in keys.items()}, {}
    for row in pool_rows(seed, cfg, sources):
        msg = row_message(cfg, row)
        if row.corrupted:
            msg = flip(msg, row.bad_bit)
        sigs[(row.rnd, row.source)] = E.sign(*keys[row.source], msg)
    return pubs, sigs


def verdicts(seed: int, cfg: dict, sources: Sequence[int], pubs: Dict[int, bytes],
             sigs: Dict[Tuple[int, int], bytes]) -> Dict[Tuple[int, int], bool]:
    """The plain reference's verdict of each row of ``sources`` (a spawn
    worker's share), from the benchmark's own inputs."""
    from portbench import ed25519_ref as E

    return {(row.rnd, row.source): E.verify(pubs[row.source], row_message(cfg, row),
                                            sigs[(row.rnd, row.source)])
            for row in pool_rows(seed, cfg, sources)}


def shares(n: int, workers: int) -> List[List[int]]:
    return [list(range(w, n, workers)) for w in range(workers) if w < n]


# -- the work of one pool replay --------------------------------------------


def requests(cfg: dict, traffic: dict) -> List[range]:
    """The pool's requests as ranges of row indices (round-major), in the
    order the window replays them."""
    per = request_rounds(cfg, traffic) * cfg["n"]
    total = cfg["pool_rounds"] * cfg["n"]
    return [range(lo, lo + per) for lo in range(0, total, per)]


def fingerprint(cfg: dict, traffic: dict, msg_lens: Sequence[int],
                corrupted: Sequence[bool]) -> dict:
    """The work of one replay of the pool, from the rows as made (their
    signed messages' lengths and which were corrupted): the same for every
    seed by construction. Raises when two requests of the pool differ in
    rows, padded rows, dispatches or corrupted rows; their hashed bytes
    differ only where some rounds carry a coin share."""
    chunks = traffic["chunks_per_request"]
    shape, hashed = set(), []
    for req in requests(cfg, traffic):
        shape.add((len(req), chunks * padded(len(req) // chunks), chunks,
                   sum(corrupted[i] for i in req)))
        hashed.append(sum(64 + msg_lens[i] for i in req))
    if len(shape) != 1:
        raise ValueError(f"requests of one pool differ in work: {sorted(shape)}")
    n_rows, n_padded, dispatches, bad = shape.pop()
    return {
        "requests_per_pool": len(hashed),
        "rows_per_request": n_rows,
        "padded_rows_per_request": n_padded,
        "dispatches_per_request": dispatches,
        "corrupted_rows_per_request": bad,
        "bytes_hashed_per_request": [min(hashed), max(hashed)],
        "bytes_hashed_per_pool": sum(hashed),
        "pool_signing_bytes": sum(msg_lens),
    }
