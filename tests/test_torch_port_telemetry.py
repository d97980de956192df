"""The port's telemetry (``horovod_tpu_torch/core/telemetry.py``) against
the reference's (``horovod_tpu/core/telemetry.py``), in process.

The same calls go to a fresh registry of each package: counters, gauges and
histograms with labels, past the series cap, across several ranks'
snapshots; the Prometheus text, the compact exports (whole and dirty-only)
and the flight recorder's dumps and incident report must be equal. Then the
port's own producers — the step monitor's span, a sentinel verdict and
``DistributedOptimizer.step`` — are shown to record into the same names the
reference's do.
"""

import json

import pytest
import torch

from horovod_tpu.core import telemetry as jtel

import horovod_tpu_torch as thvd
from horovod_tpu_torch.core import sentinel as tsentinel
from horovod_tpu_torch.core import telemetry as ttel
from horovod_tpu_torch.core import watchdog as twatchdog


def _drive(reg, rank):
    """The same sequence of calls on a registry of either package."""
    reg.inc("hvd_steps_total", what="train_step")
    reg.inc("hvd_steps_total", 2.0, what="train_step")
    reg.inc("hvd_collective_launches_total")
    reg.inc("hvd_sentinel_verdicts_total", kind="skip")
    reg.set_gauge("hvd_last_step", 7 + rank)
    reg.set_gauge("hvd_step_mfu_proxy", 0.25 + 0.125 * rank,
                  what='quote"d')
    for v in (0.0005, 0.003, 0.05, 0.7, 3.0, 100.0):
        reg.observe("hvd_step_seconds", v * (rank + 1), what="train_step")
    reg.observe("hvd_custom_seconds", 0.3, buckets=(0.1, 1.0))
    for i in range(70):  # past the series cap of one metric
        reg.inc("hvd_many_total", series=i)


@pytest.mark.parametrize("ranks", [1, 3])
def test_render_prometheus_matches_the_reference(ranks):
    per = {}
    for mod, key in ((jtel, "ref"), (ttel, "port")):
        snaps = {}
        for r in range(ranks):
            reg = mod.Registry()
            _drive(reg, r)
            snaps[r] = reg.export()
        per[key] = snaps
    assert per["port"] == per["ref"]
    text = ttel.render_prometheus(per["port"])
    assert text == jtel.render_prometheus(per["ref"])
    assert "# TYPE hvd_steps_total counter" in text
    assert "hvd_telemetry_series_dropped_total" in text


def test_dirty_exports_and_values_match_the_reference():
    out = {}
    for mod in (jtel, ttel):
        reg = mod.Registry()
        _drive(reg, 0)
        first = reg.export(dirty_only=True)
        second = reg.export(dirty_only=True)
        reg.set_gauge("hvd_last_step", 9)
        third = reg.export(dirty_only=True)
        out[mod] = (first, second, third,
                    reg.counter_value("hvd_steps_total", what="train_step"),
                    reg.gauge_value("hvd_last_step"))
    assert out[ttel] == out[jtel]


def test_flight_dumps_and_incident_match_the_reference(tmp_path,
                                                       monkeypatch):
    """Both packages' rings dump the same events; the port's incident
    report over its dumps has the reference's keys and tails."""
    monkeypatch.setattr("time.time", lambda: 1234.5)
    docs = {}
    for mod, name in ((jtel, "ref"), (ttel, "port")):
        d = tmp_path / name
        for rank in range(2):
            t = mod.configure(rank=rank, enabled=True, ring_size=8)
            for i in range(12):  # the ring keeps the last 8
                mod.record_event("step_end", step=i, rank=rank)
            mod.record_event("manifest_publish", seq=rank + 3)
            assert mod.dump_flight("test", directory=str(d))
        dumps = mod.load_flight_dumps(str(d))
        path = mod.assemble_incident(str(d), 5, journal_tail=[{"a": 1}],
                                     coordinator_metrics={0: {"x": 1.0}},
                                     tail=4)
        with open(path) as f:
            report = json.load(f)
        report.pop("created")
        docs[name] = (dumps, report)
        mod.reset()
    assert docs["port"] == docs["ref"]
    assert docs["port"][1]["last_manifest"] == 4


def test_disabled_telemetry_records_nothing():
    for mod in (jtel, ttel):
        mod.configure(enabled=False)
        mod.inc("hvd_x_total")
        mod.record_event("x")
        assert mod.export_delta() is None
        assert mod.active().ring.events() == []
        assert mod.dump_flight("x", directory="/nonexistent") is None
        mod.reset()


def test_port_producers_record_the_reference_names():
    """The step span, a sentinel verdict and a ``DistributedOptimizer``
    step record under the names the reference's producers use."""
    ttel.configure(rank=0, enabled=True)
    try:
        mon = twatchdog.StepMonitor()
        with mon.step_span("torch_step"):
            pass
        hb = mon.heartbeat()
        s = tsentinel.Sentinel(max_skips=1)
        s.observe_finite(False, 1)
        thvd.init(device="cpu")
        try:
            model = torch.nn.Linear(3, 2)
            opt = thvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1))
            model(torch.ones(1, 3)).sum().backward()
            opt.step()
        finally:
            thvd.shutdown()
        c = ttel.active().registry.export()["c"]
        g = ttel.active().registry.export()["g"]
        assert c['hvd_steps_total{what="torch_step"}'] == 2.0
        assert c['hvd_sentinel_verdicts_total{kind="skip"}'] == 1.0
        assert c['hvd_frontend_steps_total{frontend="torch"}'] == 1.0
        assert g["hvd_heartbeat_steps_completed"] == 1.0
        assert hb["steps_completed"] == 1
        kinds = [e["kind"] for e in ttel.active().ring.events()]
        assert kinds.count("step_begin") == 2 and "sentinel" in kinds
    finally:
        ttel.reset()
