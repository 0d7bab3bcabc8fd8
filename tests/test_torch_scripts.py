"""The port's command-line scripts against the repository's ``scripts/``.

``dag_rider_tpu_torch/scripts/{cluster,soak,obs_report}.py`` are copies
(``tests/test_torch_copies.py`` pins their ASTs). Here they run:

- ``obs_report``'s ``capture`` mode (``--seconds 1``) exits 0 with a
  traced ring of complete chains, its ``DAGRIDER_TRACE`` forced on through
  ``config.env_set``; on that ring and on one flight dump, the ``report``,
  ``chrome`` and ``flight`` modes print and write exactly what the
  reference script does (loaded as ``tests/test_obs.py`` loads it);
- ``python -m dag_rider_tpu_torch.scripts.cluster --n 4 --seconds 3 --rate
  200 --kill auto`` exits 0 with a clean audit: one seeded kill -9 and its
  restart, no transaction lost or delivered twice;
- ``soak.main`` runs for minutes (as the reference says), so it is held
  by its pinned AST only; here it is imported without JAX.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_obs_report():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        return importlib.import_module("obs_report")
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The port's capture mode at --seconds 1, its ring written out."""
    from dag_rider_tpu_torch.scripts import obs_report

    path = str(tmp_path_factory.mktemp("ring") / "ring.json")
    before = os.environ.get("DAGRIDER_TRACE")
    try:
        assert obs_report.main(["capture", "--seconds", "1", "--out", path]) == 0
    finally:
        if before is None:
            os.environ.pop("DAGRIDER_TRACE", None)
        else:
            os.environ["DAGRIDER_TRACE"] = before
    return path


def test_capture_mode_exits_zero_with_a_traced_ring(ring):
    events = json.load(open(ring))
    events = events.get("events", events) if isinstance(events, dict) else events
    names = {e.get("event") for e in events}
    assert {"tx_submit", "tx_deliver"} <= names


def test_env_set_validates_the_knob(monkeypatch):
    from dag_rider_tpu_torch import config

    monkeypatch.delenv("DAGRIDER_TRACE", raising=False)
    config.env_set("DAGRIDER_TRACE", "1")
    assert config.env_flag("DAGRIDER_TRACE")
    monkeypatch.delenv("DAGRIDER_TRACE")
    with pytest.raises(KeyError, match="unregistered"):
        config.env_set("DAGRIDER_TRACEE", "1")
    assert "DAGRIDER_TRACEE" not in os.environ


def _run_both(ref, argv_of, capsys):
    """(port stdout, reference stdout) of one mode; ``argv_of(tag)`` gives
    each side's arguments."""
    from dag_rider_tpu_torch.scripts import obs_report

    outs = []
    for tag, mod in (("port", obs_report), ("ref", ref)):
        assert mod.main(argv_of(tag)) == 0
        outs.append(capsys.readouterr().out)
    return outs


def test_report_mode_prints_the_references_table(ring, ref_obs_report, capsys):
    port, ref = _run_both(ref_obs_report, lambda tag: ["report", ring, "--json"], capsys)
    assert port == ref
    assert "p50" in port and "wave_commit" in port


def test_chrome_mode_writes_the_references_trace(ring, ref_obs_report, tmp_path, capsys):
    port, ref = _run_both(ref_obs_report,
                          lambda tag: ["chrome", ring, str(tmp_path / f"{tag}.json")], capsys)
    assert port.replace("port.json", "ref.json") == ref
    got = json.load(open(tmp_path / "port.json"))
    assert got == json.load(open(tmp_path / "ref.json")) and got["traceEvents"]


def test_flight_mode_summarises_as_the_reference(ref_obs_report, tmp_path, capsys):
    from dag_rider_tpu_torch.obs.flight import FlightRecorder
    from dag_rider_tpu_torch.utils.slog import EventLog

    fr = FlightRecorder(str(tmp_path), capacity=8, clock=lambda: 1.0)
    log = EventLog(fr.sink, clock=lambda: 1.0)
    log.event("pump_error", error="planted")
    port, ref = _run_both(ref_obs_report, lambda tag: ["flight", fr.dumps[0]], capsys)
    assert port == ref and "pump_error" in port


def test_cluster_command_audits_a_seeded_kill_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "dag_rider_tpu_torch.scripts.cluster", "--n", "4",
         "--seconds", "3", "--rate", "200", "--kill", "auto"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["ok"] and report["violations"] == []
    assert report["lost_tx"] == 0 and report["duplicate_tx"] == 0
    assert report["load"]["accepted"] > 0 and report["decided_waves"]
    assert len(report["kills"]) == 1 and report["kills"] == report["restarts"]
    assert [ev["action"] for ev in report["fault_plan"]] == ["kill", "restart"]
    assert not report["forced_stops"]


def test_soak_imports_without_jax():
    code = (
        "import importlib.abc, sys\n"
        "class B(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'dag_rider_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, B())\n"
        "from dag_rider_tpu_torch.scripts import soak, cluster, obs_report\n"
        "import inspect\n"
        "print(list(inspect.signature(soak.main).parameters))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "['box_s']"
    from dag_rider_tpu_torch.scripts import soak

    assert "box_s" in inspect.signature(soak.main).parameters
