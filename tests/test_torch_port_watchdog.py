"""The port's step watchdog (``horovod_tpu_torch/core/watchdog.py``)
against the reference's (``horovod_tpu/core/watchdog.py``).

- In a 2-process gloo world with ``HOROVOD_STEP_TIMEOUT_SECONDS=2``, rank 1
  holds back its second step: rank 0's monitored ``make_train_step`` raises
  ``HorovodInternalError`` within the deadline plus 2 s, the communicators
  are aborted (the next collective fails at once), the expiry is counted
  and dumped to the flight record. A second world with
  ``HOROVOD_STEP_TIMEOUT_ACTION=exit`` ends rank 0 with exit code 73
  (``RESTART_EXIT_CODE``). Both worlds run side by side, once for the
  module.
- In process: the heartbeat's keys and the deadline's arithmetic equal the
  reference's; an unarmed monitor calls the step directly, on the caller's
  thread; a peer-failure notification rescues a blocked step after the
  grace window; a step's own error passes through.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from horovod_tpu.core import watchdog as jwatchdog

import torch_port_mp as mp
from horovod_tpu_torch.core import watchdog as twatchdog
from horovod_tpu_torch.core.exceptions import HorovodInternalError

TIMEOUT_S = 2.0
HOLD_S = TIMEOUT_S + 5.0

_WORKER = textwrap.dedent("""
    import json
    import os
    import sys
    import time
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import watchdog
    from horovod_tpu_torch.core.exceptions import HorovodInternalError
    from horovod_tpu_torch.train import create_train_state, make_train_step

    data_dir, hold = sys.argv[1], float(sys.argv[2])
    hvd.init(device="cpu")
    rank = hvd.rank()
    model = torch.nn.Linear(4, 1)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    step = make_train_step(model, opt, lambda y, t: (y - t).square().mean())
    state = create_train_state(model, opt)
    x, y = torch.ones(2, 4), torch.zeros(2, 1)
    state, _ = step(state, x, y)
    out = {"first": True}
    if rank == 1:
        time.sleep(hold)  # holds back its second step
    else:
        t0 = time.monotonic()
        try:
            step(state, x, y)
            out["raised"] = None
        except HorovodInternalError as e:
            out["raised"] = str(e)
        out["seconds"] = time.monotonic() - t0
        out["aborted"] = watchdog.monitor().aborted
        try:
            dist.all_reduce(torch.ones(1))
            out["next"] = "returned"
        except Exception as e:
            out["next"] = type(e).__name__
        out["heartbeat"] = watchdog.monitor().heartbeat()
    with open(os.path.join(data_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    os._exit(0)  # rank 0's world is aborted; nothing to tear down
""")


def _start(tmp, action):
    tmp.mkdir()
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=mp.REPO, HOROVOD_NUM_PROCESSES="2",
               HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{mp._free_port()}",
               HOROVOD_STEP_TIMEOUT_SECONDS=str(TIMEOUT_S),
               HOROVOD_STEP_TIMEOUT_COMPILE_MULTIPLIER="1",
               HOROVOD_STEP_TIMEOUT_ACTION=action,
               HOROVOD_FLIGHT_DIR=str(tmp))
    return [subprocess.Popen([sys.executable, str(script), str(tmp),
                              str(HOLD_S)],
                             env=dict(env, HOROVOD_PROCESS_ID=str(r)),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(2)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("watchdog")
    procs = {a: _start(tmp / a, a) for a in ("raise", "exit")}
    out = {}
    for action, ps in procs.items():
        out[action] = [(p.wait(timeout=120), p.stdout.read()) for p in ps]
    return tmp, out


def _result(tmp, action, rank):
    with open(tmp / action / f"rank{rank}.json") as f:
        return json.load(f)


def test_hung_peer_raises_within_the_deadline(worlds):
    tmp, out = worlds
    for rc, log in out["raise"]:
        assert rc == 0, log
    r0 = _result(tmp, "raise", 0)
    assert r0["raised"] and "HOROVOD_STEP_TIMEOUT_SECONDS" in r0["raised"]
    assert TIMEOUT_S <= r0["seconds"] <= TIMEOUT_S + 2.0
    assert r0["aborted"] and r0["next"] != "returned"
    assert r0["heartbeat"]["in_flight"] is False
    with open(tmp / "raise" / "flight_0.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert "watchdog_expiry" in kinds and kinds[-1] == "flight_dump"


def test_exit_action_ends_the_process_with_73(worlds):
    tmp, out = worlds
    (rc0, log0), (rc1, log1) = out["exit"]
    assert rc0 == 73, log0
    assert rc1 == 0, log1
    assert not (tmp / "exit" / "rank0.json").exists()


def test_heartbeat_keys_and_deadline_match_the_reference(monkeypatch):
    monkeypatch.setenv("HOROVOD_STEP_TIMEOUT_SECONDS", "3")
    ref, port = jwatchdog.StepMonitor(), twatchdog.StepMonitor()
    assert sorted(port.heartbeat()) == sorted(ref.heartbeat())
    t = time.monotonic()
    for started, scale in ((t, 1.0), (t - 5, 1.0), (t - 5, 2.0),
                           (t - 40, 10.0)):
        assert (port.deadline_reason(started, scale) is None) == \
            (ref.deadline_reason(started, scale) is None)
    assert port.armed()
    monkeypatch.setenv("HOROVOD_STEP_TIMEOUT_SECONDS", "0")
    assert not port.armed()


def test_unarmed_monitor_calls_the_step_directly(monkeypatch):
    monkeypatch.delenv("HOROVOD_STEP_TIMEOUT_SECONDS", raising=False)
    mon = twatchdog.StepMonitor()
    seen = []
    assert mon.monitored_call(lambda: seen.append(
        threading.current_thread()) or 5, "x") == 5
    assert seen == [threading.current_thread()] and mon._queue is None
    assert mon.heartbeat()["steps_completed"] == 1


def test_peer_failure_rescues_a_blocked_step(monkeypatch):
    monkeypatch.delenv("HOROVOD_STEP_TIMEOUT_SECONDS", raising=False)
    monkeypatch.setenv("HOROVOD_PEER_FAILURE_GRACE_SECONDS", "0.5")
    mon = twatchdog.StepMonitor()
    release = threading.Event()
    mon.notify_peer_failure("host-b (exit 1)")
    t0 = time.monotonic()
    with pytest.raises(HorovodInternalError, match="peer died"):
        mon.monitored_call(lambda: release.wait(30), "blocked")
    assert time.monotonic() - t0 < 2.0
    release.set()
    mon.clear_peer_failure()
    assert not mon.armed()


def test_step_error_passes_through(monkeypatch):
    monkeypatch.setenv("HOROVOD_STEP_TIMEOUT_SECONDS", "30")
    mon = twatchdog.StepMonitor()

    def bad():
        raise KeyError("boom")
    with pytest.raises(KeyError):
        mon.monitored_call(bad, "bad")
    assert mon.monitored_call(lambda: 7, "good") == 7
