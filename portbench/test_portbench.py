"""CPU tests of the port's benchmark harness.

    python3 -m pytest portbench/ -q

They check the work rule (two seeds, the same work), that nothing the
harness runs loads JAX or the JAX package, that every cell of
``BENCHMARK.json`` resolves to files found by name and keeps the
character rules of BENCHMARK.json's names, the result line's keys, and that the
correctness check calls the control and each fault of the timed path not
correct. The runs here use tiny committees on the CPU (the program's plain
torch path); the one test that needs the card skips without it.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, workgen  # noqa: E402
from portbench import run as bench_run  # noqa: E402
from portbench.control import control_program  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"name": "tiny", "n": 4, "f": 1, "strong_edges": 3, "weak_edges": 0, "txs_per_block": 4,
        "tx_bytes": 32, "coin_share_bytes": 48, "wave_length": 4, "corrupt_per_round": 1,
        "pool_rounds": 4}
#: empty blocks, weak edges and a coin share on every second round
BARE = dict(TINY, name="bare", txs_per_block=0, weak_edges=1, wave_length=2)
#: a seed whose consecutive rounds (cyclically) corrupt different rows, so a
#: mask handed back one request late differs from the due one
TINY_SEED = 2**31 + 12


def small(cfg: dict) -> dict:
    """A configuration with its committee and pool cut small and every
    other field (blocks, transactions) as the file states them."""
    return dict(cfg, n=7, f=2, strong_edges=5, corrupt_per_round=1, pool_rounds=4)


def tiny_cell(traffic: str, cfg: dict = TINY) -> workgen.Cell:
    tr = workgen.load_json(HERE / "traffic" / f"{traffic}.json")
    tr = dict(tr, warm_s=0.2, chunks_per_request=min(tr["chunks_per_request"], 2))
    return workgen.Cell(f"tiny.{traffic}", workgen.check_config(dict(cfg)),
                        workgen.check_traffic(cfg, tr))


#: the benchmark's cell of each traffic mix, whose metrics a tiny run reports
CELL_OF = {"round": "verify.c256.round", "catchup": "verify.c1024.catchup"}


def tiny_run(traffic="round", trace=False, program=harness.port_program, seed=TINY_SEED,
             cfg=TINY):
    wl = CELL_OF[traffic]
    return harness.run(tiny_cell(traffic, cfg), bench_run.cell_metrics(BENCH, "end_to_end", wl),
                       bench_run.cell_metrics(BENCH, "per_layer", wl), seed, 0.6, trace,
                       device="cpu", program=program)


@pytest.mark.parametrize("traffic", ["round", "catchup"])
@pytest.mark.parametrize("config", ["committee256", "committee1024"])
def test_two_seeds_make_the_same_work(config, traffic):
    cfg = small(workgen.check_config(workgen.load_json(HERE / "configs" / f"{config}.json")))
    tr = workgen.check_traffic(cfg, workgen.load_json(HERE / "traffic" / f"{traffic}.json"))
    prints, payloads = [], []
    for seed in (3, 2**31 + 5):
        rows = workgen.pool_rows(seed, cfg)
        lens = [len(workgen.row_message(cfg, r)) for r in rows]
        prints.append(workgen.fingerprint(cfg, tr, lens, [r.corrupted for r in rows]))
        payloads.append([(r.data, r.share, r.bad_bit) for r in rows])
    assert prints[0] == prints[1]
    assert payloads[0] != payloads[1]  # the seed still draws the bytes
    assert prints[0]["corrupted_rows_per_request"] == workgen.request_rounds(cfg, tr)
    assert any(r[1] for r in payloads[0])  # the wave's last rounds carry a coin share


def test_fingerprint_refuses_requests_of_unequal_work():
    cfg = dict(TINY)
    tr = workgen.check_traffic(cfg, dict(workgen.load_json(HERE / "traffic" / "round.json")))
    lens = [100] * 16
    lens[5] = 101  # hashed bytes may differ by a round's coin share
    workgen.fingerprint(cfg, tr, lens, [False] * 16)
    corrupted = [False] * 16
    corrupted[5] = True  # corrupted rows may not
    with pytest.raises(ValueError):
        workgen.fingerprint(cfg, tr, lens, corrupted)


def test_corrupted_rows_fail_and_honest_rows_pass_the_reference():
    cfg = dict(TINY, pool_rounds=1)
    pubs, sigs = workgen.sign_sources(9, cfg, range(4))
    ok = workgen.verdicts(9, cfg, range(4), pubs, sigs)
    bad = {(r.rnd, r.source) for r in workgen.pool_rows(9, cfg) if r.corrupted}
    assert len(bad) == 1
    assert all(ok[k] == (k not in bad) for k in ok)


@pytest.mark.parametrize("cfg", [TINY, BARE], ids=["full_blocks", "bare_blocks"])
def test_the_program_signs_the_bytes_the_generator_writes(cfg):
    from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID

    cfg = workgen.check_config(dict(cfg))
    for row in workgen.pool_rows(5, cfg):
        v = Vertex(id=VertexID(row.rnd, row.source), block=Block(workgen.transactions(cfg, row.data)),
                   strong_edges=tuple(VertexID(*e) for e in workgen.strong_edges(cfg, row.rnd)),
                   weak_edges=tuple(VertexID(*e) for e in workgen.weak_edges(cfg, row.rnd)),
                   coin_share=row.share or None)
        assert v.signing_bytes() == workgen.row_message(cfg, row)
        assert len(v.signing_bytes()) == workgen.message_len(cfg, row.rnd)


def test_a_run_of_bare_blocks_with_weak_edges_and_coin_shares_is_correct():
    out = tiny_run(cfg=BARE)
    assert out["correct"], out["checks"]
    # the control still accepts the corrupted rows, which carry no transaction
    out = tiny_run(cfg=BARE, program=control_program)
    assert not out["correct"] and out["checks"]["mismatched_rows"]["value"] > 0


def test_knobs_are_checked_and_must_be_set_before_the_run():
    workgen.check_config(dict(TINY, knobs={"DAGRIDER_PREP_WORKERS": "2"}))
    for bad in ({"PREP_WORKERS": "2"}, {"DAGRIDER_PREP_WORKERS": 2}, ["DAGRIDER_COMB"]):
        with pytest.raises(ValueError):
            workgen.check_config(dict(TINY, knobs=bad))
    for knobs in ({"DAGRIDER_NOT_A_KNOB": "1"}, {"DAGRIDER_PREP_WORKERS": "2"}):
        os.environ.pop("DAGRIDER_PREP_WORKERS", None)
        with pytest.raises(ValueError):
            tiny_run(cfg=dict(TINY, knobs=knobs))


def test_the_roofline_counts_follow_the_comb_width():
    from portbench import roofline

    assert roofline.comb_bits({}) == 4
    assert roofline.comb_bits({"knobs": {"DAGRIDER_COMB_BITS": "8"}}) == 8
    b4, ops4 = roofline.tree_work(256)
    b8, ops8 = roofline.tree_work(256, 8)
    assert ops4 == 2 * 256 * 63 * roofline.PADD_IMADS and ops8 == 2 * 256 * 31 * roofline.PADD_IMADS
    assert b8 * 65 == b4 * 33
    assert roofline.finish_work(256) == roofline.finish_work(256, 8)


def test_rate_by_slice_counts_rows_in_each_slice():
    assert harness.rate_by_slice([1.0] * 11, 10, 100.0) == [8.0, 10.0]
    assert harness.rate_by_slice([0.5], 10, 0.0) == []


def test_the_reference_agrees_with_rfc8032_test_1():
    from portbench import ed25519_ref as E

    a, prefix, pub = E.expand(bytes.fromhex(
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"))
    assert pub.hex() == "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
    sig = E.sign(a, prefix, pub, b"")
    assert sig.hex() == ("e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
                         "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")
    assert E.verify(pub, b"", sig) and not E.verify(pub, b"x", sig)


def test_every_workload_resolves_to_files_found_by_name():
    for w in BENCH["workloads"]:
        cell = workgen.load_cell(BENCH, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        for section in ("end_to_end", "per_layer"):
            for m in bench_run.cell_metrics(BENCH, section, w["name"]):
                assert callable(harness.reader(m["name"]))
        assert bench_run.cell_metrics(BENCH, "per_layer", w["name"])
        assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for conf in BENCH["configs"]:
        assert (ROOT / conf["file"]).is_file()
        assert conf["file"].startswith(BENCH["paths"][0] + "/")


def test_names_and_units_keep_the_character_rules():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for s in ("end_to_end", "per_layer") for m in BENCH[s]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [k for c in BENCH["configs"]
                                                          for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(names[: len(BENCH["configs"]) + len(BENCH["workloads"])])) == \
        len(BENCH["configs"]) + len(BENCH["workloads"])
    for s in ("end_to_end", "per_layer"):
        for m in BENCH[s]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    for path in HERE.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT)))


def test_the_reference_imports_nothing_of_the_program():
    for name in ("ed25519_ref.py", "workgen.py", "roofline.py"):
        tree = ast.parse((HERE / name).read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] in ("__future__", "hashlib", "json", "random", "struct",
                                              "pathlib", "typing", "portbench"), (name, mod)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import test_portbench as t, run\n"
        "out = t.tiny_run(trace=True)\n"
        "assert out['correct'], out['checks']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.loaded_forbidden())\n" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    top, forbidden = proc.stdout.strip().splitlines()[-2:]
    assert "dag_rider_tpu_torch" in top
    for name in ("'jax'", "'jaxlib'", "'flax'", "'dag_rider_tpu'"):
        assert name not in top
    assert forbidden == "[]"


@pytest.mark.parametrize("traffic", ["round", "catchup"])
def test_the_result_line_carries_its_keys(traffic):
    out = tiny_run(traffic)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wl = CELL_OF[traffic]
    assert set(out["metrics"]) == {m["name"] for m in bench_run.cell_metrics(
        BENCH, "end_to_end", wl)}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.loads(json.dumps(out))


def test_a_traced_run_adds_its_window_and_breakdown():
    out = tiny_run("catchup", trace=True)
    assert out["correct"], out["checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    # on the CPU the trace holds no device operation: the device readers
    # stay silent rather than read 0
    assert "device_idle_pct" not in out["metrics"]
    assert "tree_sum_xyzt_roofline" not in out["metrics"]
    assert out["metrics"]["prep_us_per_sig"]["value"] > 0


def _faulty(fault):
    """The program with one fault planted under the window's entry."""

    def program(registry, chunk, device):
        pipe = harness.port_program(registry, chunk, device)
        inner = pipe.run_coalesced
        last = []

        def run_coalesced(vertices):
            if fault == "half_batch":
                half = len(vertices) // 2
                return inner(vertices[:half]) + [True] * (len(vertices) - half)
            mask = inner(vertices)
            if fault == "stale_state":
                out = last[-1] if last else mask
                last.append(mask)
                return out
            if fault == "altered_answer":
                mask[-1] = not mask[-1]
            return mask

        pipe.run_coalesced = run_coalesced
        return pipe

    return program


@pytest.mark.parametrize("fault", ["stale_state", "half_batch", "altered_answer"])
def test_a_fault_under_the_window_comes_out_not_correct(fault):
    bad = [workgen.corruptions(TINY_SEED, TINY, r) for r in range(1, TINY["pool_rounds"] + 1)]
    assert all(bad[i].keys() != bad[i - 1].keys() for i in range(len(bad)))
    out = tiny_run(program=_faulty(fault))
    assert not out["correct"]
    assert out["checks"]["mismatched_rows"]["value"] > 0
    assert out["failed"] > 0


def test_the_control_comes_out_not_correct():
    out = tiny_run("catchup", program=control_program)
    assert not out["correct"]
    # the control accepts exactly the corrupted rows it should reject
    per_request = out["checks"]["mismatched_rows"]["value"] / out["attempted"]
    assert per_request == TINY["pool_rounds"] * TINY["corrupt_per_round"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m cuda")


@pytest.mark.cuda
def test_a_short_run_of_the_first_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", BENCH["workloads"][0]["name"],
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
