"""The port's layer spans (`tracing.device_span`) on the CPU.

Under torch.profiler a training step of the Transformer lays every `tf.*`
span in the Chrome trace, and a replica's capture an engine step's three
`engine.*` spans; with no profiler nothing is recorded, and the numbers
are the same bit for bit either way.
"""

import io
import json
import threading
import time
import zipfile

import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch._private import telemetry
from ray_tpu_torch.llm import LLMConfig
from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams
from ray_tpu_torch.models import transformer as T

SHAPE = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=48, max_seq=32)
TF_SPANS = {"tf.embed", "tf.block", "tf.norm", "tf.cast", "tf.attn.proj",
            "tf.attn.rope", "tf.attn.core", "tf.mlp.proj", "tf.mlp.act",
            "tf.head", "tf.loss"}


def _model(**over):
    cfg = T.TransformerConfig(**{**SHAPE, **over})
    return T.Transformer(cfg, device="cpu", seed=3)


def _tokens():
    return torch.randint(0, SHAPE["vocab_size"], (2, 17),
                         generator=torch.Generator().manual_seed(5))


def _step(model, tokens):
    """A training step's loss and gradients (by name), gradients cleared."""
    loss = T.loss_fn(model, tokens)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _annotations(prof, tmp_path) -> set:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_profiled_training_step_lays_every_layer_span(tmp_path):
    model, tokens = _model(), _tokens()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(model, tokens)
    assert TF_SPANS <= _annotations(prof, tmp_path)


def test_moe_model_spans_its_experts(tmp_path):
    model, tokens = _model(moe_experts=2), _tokens()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(model, tokens)
    names = _annotations(prof, tmp_path)
    assert {"tf.mlp.proj", "tf.mlp.act", "tf.mlp.router"} <= names


def test_no_profiler_records_nothing_and_changes_no_bit(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    model, tokens = _model(), _tokens()
    loss, grads = _step(model, tokens)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        p_loss, p_grads = _step(model, tokens)
    assert TF_SPANS <= set(entered)
    assert torch.equal(loss, p_loss)
    assert grads.keys() == p_grads.keys()
    for name, g in grads.items():
        assert torch.equal(g, p_grads[name]), name


def test_profiled_engine_step_lays_its_three_spans():
    """`telemetry.torch_profile`, the capture behind `profile --mode
    torch`, runs on a thread of its own while the engine's scheduler works
    on another: it records every thread, so the engine's three spans and
    the model's lie in its trace."""
    cfg = LLMConfig(vocab_size=96, d_model=32, n_layers=2, n_heads=4,
                    max_seq=64)
    eng = ContinuousEngine(cfg, max_batch=2, decode_chunk=2, device="cpu")
    reps = []
    try:
        eng.submit([1, 2, 3], SamplingParams(temperature=0.0,
                                             max_tokens=2)).tokens()
        capture = threading.Thread(
            target=lambda: reps.append(telemetry.torch_profile(1.0)))
        capture.start()
        deadline = time.monotonic() + 30
        while not torch.autograd.profiler._is_profiler_enabled:
            assert time.monotonic() < deadline, "the capture never started"
            time.sleep(0.01)
        toks = eng.submit([4, 5, 6], SamplingParams(
            temperature=0.0, max_tokens=4)).tokens()
        capture.join(timeout=60)
        assert len(toks) == 4
    finally:
        eng.shutdown()
    with zipfile.ZipFile(io.BytesIO(reps[0]["archive"])) as z:
        events = json.loads(z.read("trace.json"))["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"engine.prefill", "engine.dispatch_chunk",
            "engine.host_sync"} <= names
    assert "tf.attn.core" in names
