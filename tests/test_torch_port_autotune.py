"""The port's autotuner (``horovod_tpu_torch/tools/autotune.py``) against
the reference's (``horovod_tpu/tools/autotune.py``), in process.

- The search space's unit maps, the GP's predictions and expected
  improvement, and the ``Autotuner``'s proposals under the same seed and
  scores: equal (the same float64 arithmetic in the same order).
- ``StepAutotuner`` over a fake step: the same trial schedule, the step
  counter advancing on every trial step, convergence, the best knobs
  locked in.
- ``make_train_step(autotune=True)`` in a world of one: the fusion
  threshold re-plans ``DistributedOptimizer``'s buckets on every trial
  (``fusion_threshold_override``, scoped to the re-plan), the step keeps
  training, and the trial log is written.
"""

import csv

import numpy as np
import pytest
import torch

from horovod_tpu.tools import autotune as jat

import horovod_tpu_torch as thvd
from horovod_tpu_torch.collectives import ops as tops
from horovod_tpu_torch.core.config import Config
from horovod_tpu_torch.tools import autotune as tat
from horovod_tpu_torch.train import create_train_state, make_train_step


@pytest.mark.parametrize("dim", [("Dim", (0.5, 4.0), 1.3),
                                 ("IntDim", (1, 16), 5),
                                 ("LogIntDim", (1 << 20, 1 << 28), 3 << 22)])
def test_dims_map_like_the_reference(dim):
    name, args, value = dim
    j, t = getattr(jat, name)(*args), getattr(tat, name)(*args)
    for u in np.linspace(0, 1, 11):
        assert t.from_unit(u) == j.from_unit(u)
    assert t.to_unit(value) == j.to_unit(value)
    c = ("a", 2, None)
    assert [tat.CatDim(c).from_unit(u) for u in np.linspace(0, 1, 7)] == \
        [jat.CatDim(c).from_unit(u) for u in np.linspace(0, 1, 7)]


def test_gaussian_process_and_ei_match_the_reference():
    rng = np.random.RandomState(3)
    X, y, Xs = rng.rand(6, 2), rng.randn(6), rng.rand(50, 2)
    gj, gt = jat.GaussianProcess(), tat.GaussianProcess()
    gj.fit(X, y)
    gt.fit(X, y)
    mj, sj = gj.predict(Xs)
    mt, st = gt.predict(Xs)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(tat.expected_improvement(mt, st, 0.3),
                                  jat.expected_improvement(mj, sj, 0.3))


@pytest.mark.parametrize("seed", [0, 7])
def test_proposals_match_the_reference_under_the_same_scores(seed):
    space = {"fusion_threshold_bytes": (1 << 20, 1 << 28),
             "cycles": (1, 8)}

    def tuner(mod):
        return mod.Autotuner({"fusion_threshold_bytes":
                              mod.LogIntDim(*space["fusion_threshold_bytes"]),
                              "cycles": mod.IntDim(*space["cycles"])},
                             warmup_trials=3, max_trials=9,
                             candidates_per_step=64, seed=seed, patience=4)
    j, t = tuner(jat), tuner(tat)
    seen = []
    while not j.converged():
        assert not t.converged()
        pj, pt = j.propose(), t.propose()
        assert pt == pj
        score = -abs(np.log2(pj["fusion_threshold_bytes"]) - 24.3) \
            - 0.1 * pj["cycles"]
        j.report(pj, score)
        t.report(pt, score)
        seen.append(pj)
    assert t.converged() and t.best_params() == j.best_params()
    assert len(seen) == 9 or len(seen) >= 4


def test_step_autotuner_counts_steps_and_converges():
    built = []

    def build(fusion_threshold_bytes):
        built.append(fusion_threshold_bytes)
        return lambda state: state + 1

    tuner = tat.Autotuner({"fusion_threshold_bytes":
                           tat.LogIntDim(1 << 20, 1 << 28)},
                          warmup_trials=2, max_trials=4)
    st = tat.StepAutotuner(build, {}, steps_per_trial=3, tuner=tuner)
    state = 0
    for _ in range(4 * 4 + 2):
        state = st(state)
    assert state == 18  # every trial step advanced the state
    assert st.chosen == tuner.best_params()
    assert len(built) == 5 and built[-1] == st.chosen["fusion_threshold_bytes"]


def test_fusion_threshold_override_is_scoped():
    thvd.init(device="cpu", config=Config(fusion_threshold_bytes=4096))
    try:
        assert tops._fusion_threshold() == 4096
        with tops.fusion_threshold_override(0):
            assert tops._fusion_threshold() == 0
            with tops.fusion_threshold_override(None):
                assert tops._fusion_threshold() == 4096
        assert tops._fusion_threshold() == 4096
    finally:
        thvd.shutdown()


def test_autotuned_train_step_replans_buckets_and_trains(tmp_path):
    log = tmp_path / "trials.csv"
    cfg = Config(autotune=True, autotune_warmup_samples=2,
                 autotune_max_samples=4, autotune_steps_per_sample=2,
                 autotune_log=str(log))
    thvd.init(device="cpu", config=cfg)
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(*[torch.nn.Linear(512, 512)
                                      for _ in range(8)])
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1e-3))
        sizes = [(p.numel() * 4, torch.float32) for p in model.parameters()]
        plans = []
        real = opt.replan

        def replan():
            real()
            thr = tops._fusion_threshold()
            plans.append((thr, len(opt.buckets),
                          len(tops.plan_buckets(sizes, thr))))
        opt.replan = replan
        step = make_train_step(model, opt,
                               lambda out, y: (out - y).square().mean())
        assert isinstance(step, tat.StepAutotuner)
        state = create_train_state(model, opt)
        x = torch.randn(4, 512)
        losses = []
        for _ in range(4 * 3 + 2):
            state, loss = step(state, x, x)
            losses.append(float(loss))
        assert state.step == 14
        assert step.chosen is not None
        # One plan a trial and one for the choice, each at its threshold
        # (the override reaches the re-plan alone).
        assert len(plans) == 5
        assert all(got == want for _, got, want in plans)
        assert plans[-1][0] == step.chosen["fusion_threshold_bytes"]
        assert tops._fusion_threshold() == cfg.fusion_threshold_bytes
        assert losses[-1] < losses[0]
        with open(log) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["trial", "fusion_threshold_bytes", "score"]
        assert [thr for thr, _, _ in plans[:4]] == [int(r[1])
                                                    for r in rows[1:]]
    finally:
        thvd.shutdown()
