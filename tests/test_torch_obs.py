"""The port's trace export and latency report against the JAX package's.

A traced, mempool-fronted n = 4 cluster (``tests/test_obs.py``'s
``_traced_loaded_sim``) runs in the port, and its recorder's dump goes
through both packages' ``obs.export`` (the Perfetto / Chrome trace, its
file and its reload) and ``obs.report`` (the submit→deliver chains, their
split into mempool queue, propose stage and wave commit, the wave
commit's split over the ``phase_*`` spans, and the printed report). The
outputs must be equal; these are host modules, so the tolerance is zero.
"""

import json

import pytest

from dag_rider_tpu.obs import export as jexport, report as jreport
from dag_rider_tpu_torch import Config, obs
from dag_rider_tpu_torch.config import MempoolConfig
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.mempool.loadgen import ClusterLoadDriver, LoadGenerator
from dag_rider_tpu_torch.obs import export as texport, report as treport


@pytest.fixture(scope="module", params=[(0.6, 3), (0.4, 8)], ids=["seed3", "seed8"])
def dump(request):
    seconds, seed = request.param
    tracing = obs.build_tracing(sample_rate=1.0, flight_dir="")
    sim = Simulation(Config(n=4, coin="round_robin", propose_empty=True,
                            sync_request_cooldown_s=0.0, sync_serve_cooldown_s=0.0),
                     log=tracing.log)
    drv = ClusterLoadDriver(sim, LoadGenerator(clients=4, rate=300.0, tx_bytes=32, seed=seed),
                            mcfg=MempoolConfig(cap=4096, batch_bytes=512))
    drv.run(seconds)
    events = tracing.recorder.events()
    assert events
    return tracing, events


def test_export_equals_jax(dump, tmp_path):
    tracing, events = dump
    doc = texport.chrome_trace(events)
    assert doc == jexport.chrome_trace(events)
    assert len(doc["traceEvents"]) == len(events)
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    tpath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    texport.write_chrome_trace(events, tpath)
    jexport.write_chrome_trace(events, jpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert texport.load_events(tpath) == jexport.load_events(jpath)
    ring = str(tmp_path / "ring.json")
    tracing.recorder.write_json(ring)
    assert texport.load_events(ring) == jexport.load_events(ring)
    assert len(texport.load_events(ring)) == len(events)


def test_report_equals_jax(dump):
    _, events = dump
    chains = treport.chains(events)
    assert chains, "the traced load closed no submit->deliver chain"
    assert chains == jreport.chains(events)
    assert treport.phase_occupancy(events) == jreport.phase_occupancy(events)
    rep = treport.decompose(events)
    assert rep == jreport.decompose(events)
    assert rep["txs"] == len(chains)
    assert treport.format_report(rep) == jreport.format_report(rep)
    json.dumps(rep)  # the report is plain JSON
