"""A Chrome trace's device time charged to the port's layer spans."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import REPO
from harness import spans

BWD = "autograd::engine::evaluate_function: "


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid,
              correlation=corr)


def _kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
            "dur": dur, "pid": 0, "tid": 7,
            "args": {"device": 0, "correlation": corr}}


def _doc():
    ev = [
        # forward, thread 1: an op in tf.norm that makes node 7, then one
        # in it that makes none (it carries the next number, 8), then the
        # op in tf.mlp.proj that makes node 8
        _x("user_annotation", "tf.norm", 0, 20),
        _x("cpu_op", "aten::mul", 1, 8, **{"Sequence number": 7}),
        _launch(2, 1),
        _x("cpu_op", "aten::to", 12, 2, **{"Sequence number": 8}),
        _x("user_annotation", "tf.mlp.proj", 20, 20),
        _x("cpu_op", "aten::mm", 21, 10, **{"Sequence number": 8}),
        _launch(22, 2),
        # backward, thread 2: node 8's op, node 7's, a leaf's accumulation
        _x("cpu_op", BWD + "MmBackward0", 50, 10, 2,
           **{"Sequence number": 8}),
        _x("cpu_op", "aten::mm", 51, 8, 2),
        _launch(52, 3, 2),
        _x("cpu_op", BWD + "MulBackward0", 60, 10, 2,
           **{"Sequence number": 7}),
        _launch(61, 4, 2),
        _x("cpu_op", BWD + "torch::autograd::AccumulateGrad", 70, 5, 2),
        _launch(71, 5, 2),
        # the optimizer, thread 1; a launch in no op
        _x("user_annotation", "Optimizer.step#Adam.step", 80, 10),
        _launch(81, 6),
        _launch(95, 7),
        # device: forward, backward, accumulation, Adam, stray, unlaunched
        _kernel(5, 10, 1), _kernel(25, 20, 2), _kernel(53, 6, 3),
        _kernel(62, 4, 4), _kernel(72, 2, 5), _kernel(82, 8, 6),
        _kernel(96, 2, 7), _kernel(98, 1, 99),
    ]
    return {"traceEvents": ev}


def test_device_time_lands_on_the_spans_that_launched_it():
    red = spans.reduce(_doc(), steps=1)
    s = red["spans"]
    ms = 1e-3
    assert s["tf.norm"]["fwd_ms"] == pytest.approx(10 * ms)
    assert s["tf.norm"]["bwd_ms"] == pytest.approx((4 + 2) * ms)
    assert s["tf.norm"]["bwd_kernels"] == 2
    assert s["tf.mlp.proj"]["fwd_ms"] == pytest.approx(20 * ms)
    assert s["tf.mlp.proj"]["bwd_ms"] == pytest.approx(6 * ms)
    assert s["tf.mlp.proj"]["kernels"] == 2
    assert s["adam"]["ms"] == pytest.approx(8 * ms)
    assert s["unattributed"]["ms"] == pytest.approx(3 * ms)
    assert s["unattributed"]["kernels"] == 2
    assert red["device_ms"] == pytest.approx(53 * ms)
    assert spans.metric(red, "train.products_ms") == pytest.approx(26 * ms)
    assert spans.metric(red, "train.norm_ms") == pytest.approx(16 * ms)


def test_idle_gaps_are_named_by_the_span_the_host_was_in():
    red = spans.reduce(_doc(), steps=2)
    idle = red["idle_ms"]
    # middles: [0, 5) at 2.5 in tf.norm; [15, 25) at 20, tf.mlp.proj just
    # entered; [45, 53) at 49 in none (the backward not begun); [59, 62)
    # and [66, 72) in node 7's backward (tf.norm); [74, 82) at 78 and
    # [90, 96) at 93 in none; halved over two steps
    assert idle["tf.norm"] == pytest.approx((5 + 3 + 6) * 1e-3 / 2)
    assert idle["tf.mlp.proj"] == pytest.approx(10 * 1e-3 / 2)
    assert idle["none"] == pytest.approx((8 + 8 + 6) * 1e-3 / 2)


def _tiny_step_trace(tmp_path, moe_experts=0) -> dict:
    from ray_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab_size=96, d_model=32, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=48, max_seq=32,
                              moe_experts=moe_experts)
    model = T.Transformer(cfg, device="cpu", seed=1)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    toks = torch.randint(0, 96, (2, 17),
                         generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.loss_fn(model, toks).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("moe_experts", [0, 2])
def test_a_cpu_step_charges_its_backward_to_the_spans(tmp_path, moe_experts):
    red = spans.reduce(_tiny_step_trace(tmp_path, moe_experts), steps=1)
    s = red["spans"]
    bwd = sum(v["bwd_ms"] for v in s.values())
    in_spans = sum(v["bwd_ms"] for k, v in s.items() if k.startswith("tf."))
    assert bwd > 0 and in_spans >= 0.99 * bwd
    assert {"tf.norm", "tf.cast", "tf.attn.proj", "tf.attn.rope",
            "tf.attn.core", "tf.mlp.proj", "tf.mlp.act", "tf.head",
            "tf.loss", "tf.embed", "tf.block", "adam"} <= s.keys()
    for name in spans.METRICS:
        assert spans.metric(red, name) > 0


def test_metrics_read_nothing_without_the_spans():
    no_port_spans = {"spans": {"adam": {"ms": 2.0},
                               "unattributed": {"ms": 5.0}}}
    for name in spans.METRICS:
        assert spans.metric(None, name) is None
        want = 2.0 if name == "train.adam_ms" else None
        assert spans.metric(no_port_spans, name) == want


def test_split_reads_every_span_of_a_tiny_cell(tiny_root):
    code = ("import sys; sys.path.insert(0, 'bench_h100'); import split; "
            "sys.exit(split.main(['--workload', 'tiny.train', '--seed', "
            "'2147483659'], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO,
               TMPDIR=os.path.join(tiny_root, "tmp"))
    os.makedirs(env["TMPDIR"], exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["card"] == "cpu" and line["port"] == REPO
    assert line["plain_step_ms"] > 0 and line["traced_step_ms"] > 0
    assert {"tf.norm", "tf.attn.core", "tf.loss", "adam"} <= line[
        "spans"].keys()
    assert all(v > 0 for v in line["metrics"].values())
