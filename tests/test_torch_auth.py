"""The port's frame authentication gives the reference's bytes.

``transport/auth.py`` is a copy (``tests/test_torch_copies.py`` pins its
AST); here the two packages run on the same inputs: masters made from a
seed with numpy, pair keys and frame tags byte-identical, and tampered,
reflected, redirected, truncated, unknown-sender and wrong-master frames
refused by both exactly alike.
"""

import numpy as np
import pytest

from dag_rider_tpu.transport import auth as ref
from dag_rider_tpu_torch.transport import auth as port

N = 6


def _masters(seed, count=3):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(1, 64))) for _ in range(count)]


def _payloads(seed, count=4):
    rng = np.random.default_rng(seed + 1)
    return [b""] + [rng.bytes(int(rng.integers(1, 300))) for _ in range(count - 1)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derived_keys_and_tags_are_the_references_bytes(seed):
    for master in _masters(seed):
        r_rows, p_rows = ref.FrameAuth.derive(master, N), port.FrameAuth.derive(master, N)
        assert [a.index for a in p_rows] == list(range(N))
        for r, p in zip(r_rows, p_rows):
            assert p._keys == r._keys
            node = port.FrameAuth.for_node(master, r.index, N)
            assert node._keys == r._keys
        assert port._pair_key(master, 1, 4) == ref._pair_key(master, 4, 1)
        for payload in _payloads(seed):
            for i in range(N):
                for j in range(N):
                    if i == j:
                        continue
                    tag = p_rows[i].tag(j, payload)
                    assert tag == r_rows[i].tag(j, payload)
                    assert len(tag) == port.TAG_BYTES == ref.TAG_BYTES
                    assert p_rows[j].check(i, payload, tag) is True
                    assert r_rows[j].check(i, payload, tag) is True


@pytest.mark.parametrize("seed", [3, 4])
def test_forged_frames_are_refused_as_the_reference_refuses_them(seed):
    master, other = _masters(seed, 2)
    rows = {"ref": ref.FrameAuth.derive(master, N), "port": port.FrameAuth.derive(master, N)}
    outsiders = {"ref": ref.FrameAuth.derive(other, N), "port": port.FrameAuth.derive(other, N)}
    rng = np.random.default_rng(seed)
    payload = rng.bytes(96)

    def verdicts(pkg):
        a = rows[pkg]
        tag = a[0].tag(1, payload)
        flipped = bytearray(tag)
        flipped[int(rng.integers(0, len(tag)))] ^= 1 << int(rng.integers(0, 8))
        body = bytearray(payload)
        body[int(rng.integers(0, len(body)))] ^= 1
        return {
            "genuine": a[1].check(0, payload, tag),
            "tampered payload": a[1].check(0, bytes(body), tag),
            "tampered tag": a[1].check(0, payload, bytes(flipped)),
            "reflected to its author": a[0].check(1, payload, tag),
            "redirected to a third node": a[2].check(0, payload, tag),
            "wrong claimed sender": a[1].check(2, payload, tag),
            "unknown sender": a[1].check(N + 3, payload, tag),
            "itself as sender": a[1].check(1, payload, tag),
            "truncated tag": a[1].check(0, payload, tag[:-1]),
            "empty tag": a[1].check(0, payload, b""),
            "another master": a[1].check(0, payload, outsiders[pkg][0].tag(1, payload)),
        }

    state = rng.bit_generator.state
    want = verdicts("ref")
    rng.bit_generator.state = state
    got = verdicts("port")
    assert got == want
    assert want["genuine"] and not any(v for k, v in want.items() if k != "genuine")
