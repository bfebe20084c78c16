"""The port's state API (`util.state`) and `air.session` on the CPU.

Counterpart tests: tests/test_util_extras.py::test_air_session_in_trainer
(here over `TorchTrainer` with `use_gpu=False`), and the state rows the
reference's tests read through `ray_tpu.util.state`: a live actor in
`list_actors` with its node and class, the node in `list_nodes`, and
`air.session` outside any session and inside a tune trial. The module
brings its own runtime.
"""

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import air, tune
from ray_tpu_torch.air import session
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.util import state


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


def test_state_needs_a_runtime():
    with pytest.raises(RuntimeError, match="init"):
        state.list_actors()


def test_state_lists_actors_and_nodes(cluster):
    @rt.remote(num_cpus=0)
    class Probe:
        def ping(self):
            return "pong"

    probe = Probe.options(name="state-probe").remote()
    try:
        assert rt.get(probe.ping.remote(), timeout=60) == "pong"
        nodes = state.list_nodes()
        assert len(nodes) == 1 and nodes[0]["alive"]
        rows = [r for r in state.list_actors()
                if r["actor_id"] == probe._actor_id]
        assert len(rows) == 1, state.list_actors()
        row = rows[0]
        assert row["state"] == "ALIVE" and row["name"] == "state-probe"
        assert row["node_id"] == nodes[0]["node_id"]
        assert "Probe" in row["class"]
        assert len(state.list_actors(limit=0)) == 0
    finally:
        rt.kill(probe)


def test_air_session_outside_any_session():
    assert session.get_world_rank() == 0
    assert session.get_world_size() == 1
    assert session.get_local_rank() == 0
    assert session.get_checkpoint() is None
    with pytest.raises(RuntimeError, match="outside a train/tune session"):
        session.report({"x": 1})
    assert air.ScalingConfig is ScalingConfig and air.RunConfig is RunConfig


def test_air_session_in_trainer(cluster, tmp_path):
    def loop(config):
        from ray_tpu_torch.air import session

        session.report({"rank": session.get_world_rank(),
                        "world": session.get_world_size()})

    res = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert res.error is None
    assert res.metrics["world"] == 2
    assert res.metrics["rank"] in (0, 1)


def _trial(config):
    from ray_tpu_torch.air import session

    for i in range(3):
        session.report({"score": config["x"] * i})


def test_air_session_in_tune_trial(cluster, tmp_path):
    grid = tune.Tuner(
        _trial, param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert grid.num_errors == 0
    best = grid.get_best_result()
    assert best.config["x"] == 2.0 and best.metrics["score"] == 4.0
