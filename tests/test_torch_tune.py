"""The port's `tune` on the CPU: search spaces, Tuner.fit over trial
actors, trial errors, ASHA, PBT with its clone pin, `TorchTrainer` in
`Tuner`, median stopping, HyperBand, TPE and restore.

Counterpart tests: tests/test_tune.py, case for case, with the
reference's own margins. Each test starts its own runtime of the port, as
the reference's fixtures do; the ASHA case runs its 8 trials on one node
of 8 CPUs, where the reference adds a second node (the port has no
multi-node cluster utility).
"""

import os
import pickle
import tempfile

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import Checkpoint, RunConfig
from ray_tpu_torch.tune import ASHAScheduler, PopulationBasedTraining, TuneConfig, Tuner


def _runtime(num_cpus):
    ray_tpu_torch.init(num_cpus=num_cpus)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture
def rt_2cpu():
    yield from _runtime(2)


@pytest.fixture
def rt_4cpu():
    yield from _runtime(4)


@pytest.fixture
def rt_8cpu():
    yield from _runtime(8)


def test_search_space_generation():
    from ray_tpu_torch.tune.search import BasicVariantGenerator

    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.choice([1, 2, 3]),
        "nested": {"h": tune.grid_search([16, 32])},
        "const": 7,
    }
    cfgs = BasicVariantGenerator(seed=0).generate(space, num_samples=3)
    assert len(cfgs) == 12  # 2 x 2 grid combos x 3 samples
    assert all(c["const"] == 7 for c in cfgs)
    assert {(c["lr"], c["nested"]["h"]) for c in cfgs} == {
        (0.1, 16), (0.1, 32), (0.01, 16), (0.01, 32)}
    assert all(c["wd"] in (1, 2, 3) for c in cfgs)


def _quadratic(config):
    """Best score at x=3."""
    for it in range(8):
        score = -(config["x"] - 3.0) ** 2 - it * 0.0  # constant per trial
        tune.report({"score": score})


def test_tuner_grid_fifo(rt_4cpu, tmp_path):
    tuner = Tuner(
        _quadratic,
        param_space={"x": tune.grid_search([0.0, 2.0, 3.0, 5.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 4
    assert grid.num_errors == 0
    best = grid.get_best_result()
    assert best.config["x"] == 3.0
    assert best.metrics["score"] == 0.0
    # every trial ran all 8 iterations under FIFO
    assert all(r.metrics["training_iteration"] == 8 for r in grid)


def test_tuner_trial_error_reported(rt_2cpu, tmp_path):
    def boom(config):
        if config["x"] == 1:
            raise RuntimeError("kaboom")
        tune.report({"score": 1.0})

    grid = Tuner(
        boom, param_space={"x": tune.grid_search([0, 1])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 1
    ok = [r for r in grid if r.error is None]
    assert len(ok) == 1 and ok[0].metrics["score"] == 1.0


def _staircase(config):
    """Good trials (high base) keep improving; bad trials plateau low.
    A KV barrier aligns all trials before the loop so ASHA's rungs see the
    full population regardless of actor spawn stagger."""
    import time as _time
    import uuid

    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    w.kv("put", ns="test", key=f"asha_gate/{uuid.uuid4().hex}", value=b"1")
    while len(w.kv("keys", ns="test", prefix="asha_gate/")["keys"]) < config["world"]:
        _time.sleep(0.02)
    # Weak trials iterate 10x slower: strong trials populate every rung
    # before a weak trial reaches it, making the ASHA cut deterministic
    # (async halving lets whoever reaches a rung first pass uncontested).
    pace = 0.03 if config["base"] > 5 else 0.3
    for it in range(1, 21):
        _time.sleep(pace)
        tune.report({"score": config["base"] + it * config["base"] * 0.1})


def test_asha_stops_bad_half(rt_8cpu, tmp_path):

    # Strong trials interleaved FIRST: whatever the actor start order/pace,
    # every weak trial finds a strong score recorded at its first rung and
    # is cut there — deterministic even if trials end up running serially.
    bases = [10.0, 1.0, 10.0, 1.0, 10.0, 1.0, 10.0, 1.0]
    tuner = Tuner(
        _staircase,
        param_space={"base": tune.grid_search(bases), "world": 8},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=ASHAScheduler(max_t=20, grace_period=2,
                                    reduction_factor=2)),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 8 and grid.num_errors == 0
    iters = sorted(r.metrics["training_iteration"] for r in grid)
    # The strong half must reach max_t-ish; the weak half must be cut early.
    stopped_early = [i for i in iters if i < 20]
    assert len(stopped_early) >= 4, iters  # the weak half was cut
    best = grid.get_best_result()
    assert best.config["base"] == 10.0
    # the winner ran to the end
    assert best.metrics["training_iteration"] >= 19


def _pbt_loop(config):
    """Score grows by `rate` per step; checkpoint carries the accumulated
    score so exploit actually transfers progress. A KV start barrier keeps
    all trials concurrent — exploit decisions need live peers."""
    import time as _time
    import uuid as _uuid

    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    w.kv("put", ns="test", key=f"pbt_gate/{_uuid.uuid4().hex}", value=b"1")
    deadline = _time.monotonic() + 30
    while (len(w.kv("keys", ns="test", prefix="pbt_gate/")["keys"])
           < config["world"] and _time.monotonic() < deadline):
        _time.sleep(0.02)
    score = 0.0
    step = 0
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.path, "state.pkl"), "rb") as f:
            st = pickle.load(f)
        score, step = st["score"], st["step"]
    while step < 25:
        step += 1
        score += config["rate"]
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "state.pkl"), "wb") as f:
                pickle.dump({"score": score, "step": step}, f)
            tune.report({"score": score}, checkpoint=Checkpoint(d))


def test_pbt_exploits_good_trials(rt_4cpu, tmp_path):
    pbt = PopulationBasedTraining(
        perturbation_interval=5,
        hyperparam_mutations={"rate": tune.uniform(0.1, 10.0)},
        quantile_fraction=0.5, seed=0)  # bottom 2 of 4 exploit the top 2
    tuner = Tuner(
        _pbt_loop,
        param_space={"rate": tune.grid_search([0.1, 0.2, 5.0, 6.0]),
                     "world": 4},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=pbt),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert grid.num_errors == 0
    # The weak trials (rate 0.1/0.2 -> final ~2.5-5) must have exploited a
    # strong donor: every trial's final score should blow past the
    # no-exploit weak ceiling.
    finals = sorted(r.metrics["score"] for r in grid)
    assert finals[0] > 10.0, finals


def test_pbt_clone_pin_protects_donor_checkpoint(tmp_path):
    """The PBT checkpoint-sharing hazard: a clone restores from
    `donor.checkpoint_path`, so the donor's retention/GC must not collect
    that dir while the clone still references it. The controller pins the
    restore source on exploit; the pin defeats retention until the clone
    has a checkpoint of its own (or stops)."""
    import numpy as np

    from ray_tpu_torch import storage
    from ray_tpu_torch.train import checkpoint as ckpt_mod
    from ray_tpu_torch.tune.trial import Trial
    from ray_tpu_torch.tune.tuner import TuneController

    ctl = TuneController.__new__(TuneController)  # pin logic only
    donor = Trial({"rate": 5.0}, str(tmp_path / "trial_donor"))
    clone = Trial({"rate": 0.1}, str(tmp_path / "trial_clone"))
    # donor has one committed checkpoint; session-side retention keeps 1
    ck1 = storage.join(donor.trial_dir, "checkpoint_000001")
    ckpt_mod.upload_directory(_make_dir(tmp_path, "payload-1"), ck1, step=1)
    donor.checkpoint_path = ck1

    ctl._pin_restore_source(clone, donor.checkpoint_path)
    assert clone.restore_from == ck1 and clone.pinned_source == ck1

    # donor keeps training: a newer checkpoint + keep-last-1 retention
    # (what the donor's trial session runs under RT_CKPT_KEEP=1)
    ck2 = storage.join(donor.trial_dir, "checkpoint_000002")
    ckpt_mod.upload_directory(_make_dir(tmp_path, "payload-2"), ck2, step=2)
    deleted = ckpt_mod.retention(donor.trial_dir, keep=1)
    assert deleted == []  # ck1 pinned by the clone -> survives
    assert storage.exists(storage.join(ck1, "state.txt"))

    # the clone writes its own checkpoint -> controller releases the pin
    clone.checkpoint_path = storage.join(clone.trial_dir,
                                         "checkpoint_000001")
    ctl._release_restore_pin(clone)
    assert ckpt_mod.retention(donor.trial_dir, keep=1) == [ck1]
    assert not storage.exists(ck1)
    assert storage.exists(storage.join(ck2, "state.txt"))


def _make_dir(tmp_path, payload: str) -> str:
    import uuid

    d = tmp_path / f"src_{uuid.uuid4().hex[:6]}"
    d.mkdir()
    (d / "state.txt").write_text(payload)
    return str(d)


def test_trainer_in_tuner(rt_4cpu, tmp_path):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def loop(config):
        import ray_tpu_torch.train as train

        # trivial "training": the tuned lr decides the loss
        train.report({"loss": abs(config["lr"] - 0.01)})

    trainer = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path / "t")))
    grid = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search([0.1, 0.01, 0.5])}},
        tune_config=TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0
    assert grid.get_best_result().config["train_loop_config"]["lr"] == 0.01


def test_median_stopping_rule(rt_4cpu):
    """Bad trials stop early once enough peers establish the median
    (reference tune/schedulers/median_stopping_rule.py)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import MedianStoppingRule, TuneConfig, Tuner

    def trainable(config):
        import time as _t

        for i in range(1, 21):
            _t.sleep(0.05)  # real iterations take time: peers interleave
            tune.report({"score": config["q"] * i, "training_iteration": i})

    tuner = Tuner(
        trainable,
        param_space={"q": tune.grid_search([1, 2, 10, 11, 12, 13])},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=MedianStoppingRule(grace_period=3,
                                         min_samples_required=3)),
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.config["q"] == 13
    iters = {r.config["q"]: r.metrics.get("training_iteration") for r in grid}
    # The clearly-below-median trials must have been cut early.
    assert iters[1] < 20 and iters[2] < 20, iters


def test_hyperband_scheduler(rt_4cpu):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import HyperBandScheduler, TuneConfig, Tuner

    def trainable(config):
        import time as _t

        for i in range(1, 28):
            _t.sleep(0.04)
            tune.report({"loss": 100.0 / config["lr_id"] - i * 0.01,
                         "training_iteration": i})

    tuner = Tuner(
        trainable,
        param_space={"lr_id": tune.grid_search([1, 2, 3, 4, 5, 6])},
        tune_config=TuneConfig(
            metric="loss", mode="min",
            scheduler=HyperBandScheduler(max_t=27, reduction_factor=3)),
    )
    grid = tuner.fit()
    assert grid.get_best_result().config["lr_id"] == 6
    iters = {r.config["lr_id"]: r.metrics.get("training_iteration") for r in grid}
    assert iters[1] < 27, iters  # worst trial halved out before max_t


def test_tpe_searcher_converges(rt_4cpu):
    """Native TPE (the reference's OptunaSearch seat) beats random on a
    smooth objective: suggestions concentrate near the optimum once the
    startup trials are in."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TPESearcher, TuneConfig, Tuner

    def objective(config):
        x, y = config["x"], config["y"]
        tune.report({"score": -(x - 0.3) ** 2 - (y - 7.0) ** 2})

    tuner = Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0),
                     "y": tune.loguniform(1.0, 100.0)},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=24,
                               max_concurrent_trials=4,
                               search_alg=TPESearcher(n_startup=6, seed=0)),
    )
    grid = tuner.fit()
    assert grid.num_errors == 0 and len(grid) == 24
    best = grid.get_best_result()
    assert best.metrics["score"] > -0.5, best.metrics
    # Later (model-guided) suggestions should be better than the random
    # startup phase on average.
    scores = [r.metrics["score"] for r in grid]
    import statistics

    # Medians: TPE keeps a uniform exploration component, so one late
    # outlier must not fail the direction-of-improvement check.
    assert statistics.median(scores[12:]) > statistics.median(scores[:6]), scores


def test_tuner_restore_resumes_experiment(rt_2cpu, tmp_path):
    """Tuner.restore finishes an interrupted experiment: completed trials
    keep results, unfinished ones re-run (reference tuner.py restore)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.train.config import FailureConfig

    marker = str(tmp_path / "fail_once")

    def flaky(config):
        # Trial with x == 3 kills ITSELF the first time (simulating an
        # interrupted experiment); every other trial finishes normally.
        if config["x"] == 3 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
        tune.report({"score": config["x"] * 10, "training_iteration": 1})

    exp_dir = str(tmp_path / "exp")
    tuner = Tuner(
        flaky,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path), name="exp",
                             failure_config=FailureConfig(max_failures=0)),
    )
    grid = tuner.fit()
    # trial x=3 errored (simulated interruption)
    assert grid.num_errors == 1
    # restore: the errored trial re-runs (marker exists now -> succeeds)
    tuner2 = Tuner.restore(exp_dir)
    grid2 = tuner2.fit()
    assert grid2.num_errors == 0 and len(grid2) == 3
    assert sorted(r.metrics["score"] for r in grid2) == [10, 20, 30]
