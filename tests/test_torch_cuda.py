"""The port's CUDA kernels and its engine on the card, against their plain
PyTorch versions. These need an NVIDIA GPU and nvcc and skip elsewhere;
on the card run them with

    python -m pytest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: float32 within 1e-4 (same f32 arithmetic, other summation
order); bfloat16 outputs within 2e-2 * max(1, |ref|) (one bf16 ulp of
rounding on top of that). The backward kernel is held to the plain
backward on the same inputs (same lse, same rounding of P and dS to bf16),
with the same tolerances.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import kernels
from ray_tpu_torch.ops.decode_attention import (_reference_decode_attention,
                                                decode_attention,
                                                decode_attention_cuda,
                                                split_plan)
from ray_tpu_torch.ops.flash_attention import (
    _reference_flash_attention, _reference_flash_attention_backward,
    _reference_flash_attention_lse, flash_attention,
    flash_attention_backward_cuda, flash_attention_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _check(out, ref, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)
    assert torch.isfinite(out.float()).all()
    assert float(err.max()) <= tol


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _edge_lengths(b, hq, kv, d, s, dtype):
    """0, 1, chunk - 1, chunk, chunk + 1 and S for the split plan's chunk."""
    elem = torch.finfo(dtype).bits // 8
    chunk = split_plan(b, hq, kv, s, d, elem).chunk
    return sorted({n for n in (0, 1, chunk - 1, chunk, chunk + 1, s)
                   if 0 <= n <= s})


def _decode_and_check(gen, dtype, b, hq, kv, d, s):
    q = _randn(gen, b, hq, d, dtype=dtype)
    k, v = (_randn(gen, b, s, kv, d, dtype=dtype) for _ in range(2))
    lens = _edge_lengths(b, hq, kv, d, s, dtype)
    lens = torch.tensor((lens * b)[:b], dtype=torch.int32, device="cuda")
    before = kernels.DECODE_ATTENTION.launches
    out = decode_attention_cuda(q, k, v, lens)
    assert kernels.DECODE_ATTENTION.launches == before + 1
    live = lens > 0  # the plain version gives NaN at length 0
    assert torch.all(out[~live] == 0)
    _check(out[live], _reference_decode_attention(q, k, v, lens)[live], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kv,d,s", [
    (4, 4, 64, 300), (8, 2, 128, 300), (24, 2, 64, 300),  # rep 1, 4, 12
    (16, 16, 64, 1024),                                   # serving heads
    (16, 8, 64, 600), (32, 4, 128, 600), (32, 2, 128, 600),  # rep 2, 8, 16
])
def test_decode_kernel_matches_plain(gen, dtype, hq, kv, d, s):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1 and S, with S = 600 not a
    multiple of the chunk."""
    b = len(_edge_lengths(6, hq, kv, d, s, dtype))
    _decode_and_check(gen, dtype, b, hq, kv, d, s)


def test_decode_kernel_counters_reset_between_calls(gen):
    """Calls in a row, on the same and on other shapes, each equal the
    plain version: every launch leaves its ticket counters at zero."""
    shapes = [(8, 16, 16, 64, 1024), (8, 16, 16, 64, 1024),
              (4, 32, 2, 128, 600), (8, 16, 16, 64, 1024),
              (3, 8, 8, 64, 300)]
    for b, hq, kv, d, s in shapes:
        _decode_and_check(gen, torch.bfloat16, b, hq, kv, d, s)


def test_decode_kernel_zero_length_gives_zeros(gen):
    q = _randn(gen, 2, 4, 64, dtype=torch.bfloat16)
    k = _randn(gen, 2, 16, 4, 64, dtype=torch.bfloat16)
    lens = torch.tensor([0, 16], dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, k, lens)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 200, 200, 4, 4, 64, True),
    (1, 77, 300, 8, 2, 128, True),     # GQA, Sq < Sk, ragged tiles
    (1, 130, 70, 2, 2, 64, True),      # Sq > Sk: rows without keys
    (2, 64, 190, 4, 1, 128, False),
    # edges of the 128-row tiles: Sq, Sk in {1, 63, 64, 65, 127, 128, 129,
    # 1000, 2048}
    (2, 1, 1, 2, 2, 64, True),
    (1, 1, 1000, 4, 2, 128, True),     # one query row, Sq < Sk
    (1, 63, 63, 2, 1, 128, True),
    (2, 64, 64, 2, 2, 64, False),
    (1, 65, 129, 4, 2, 64, True),
    (1, 127, 128, 2, 2, 128, True),
    (1, 128, 128, 2, 2, 64, True),
    (1, 129, 127, 2, 2, 128, True),    # Sq > Sk: one row without keys
    (1, 129, 65, 4, 4, 64, False),
    (1, 1000, 1000, 4, 1, 64, True),
    (1, 2048, 2048, 2, 2, 128, True),
    (1, 2048, 1000, 2, 2, 64, True),   # Sq > Sk: 1048 rows without keys
    (1, 65, 2048, 8, 2, 128, False),
    (1, 1000, 63, 2, 2, 128, False),
])
def test_flash_kernel_matches_plain(gen, dtype, b, sq, sk, hq, hkv, d,
                                    causal):
    q = _randn(gen, b, sq, hq, d, dtype=dtype)
    k, v = (_randn(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    before = kernels.FLASH_ATTENTION.launches
    out = flash_attention_cuda(q, k, v, causal)
    assert kernels.FLASH_ATTENTION.launches == before + 1
    _check(out, _reference_flash_attention(q, k, v, causal), dtype)
    if causal and sq > sk:
        assert torch.all(out[:, :sq - sk] == 0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 1, 4, 64, dtype=torch.float16)
    k = _randn(gen, 1, 8, 4, 64, dtype=torch.float16)
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        decode_attention_cuda(q, k, k, lens)
    k32 = _randn(gen, 1, 8, 4, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_cuda(k32[:, 0], k32, k32.transpose(1, 2)
                              .contiguous().transpose(1, 2), lens)


def test_engine_on_the_card_matches_the_cpu(gen):
    """Greedy tokens through the decode kernel (f32, TF32 off) equal the
    plain versions' on the CPU for the same seeded weights."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LLMConfig(vocab_size=300, d_model=128, n_layers=2, n_heads=2,
                    max_seq=96, seed=3)
    prompts = [[1, 2, 3], list(range(10, 40)), [7] * 9]
    out = {}
    for device in ("cpu", "cuda"):
        eng = ContinuousEngine(cfg, max_batch=2, decode_chunk=4,
                               device=device)
        try:
            out[device] = [eng.submit(p, SamplingParams(
                temperature=0.0, max_tokens=12)).tokens() for p in prompts]
        finally:
            eng.shutdown()
    assert np.array_equal(out["cpu"], out["cuda"])


BACKWARD_CASES = [
    (2, 200, 200, 4, 4, 64, True),
    (1, 77, 300, 8, 2, 128, True),     # GQA, Sq < Sk, ragged tiles
    (1, 130, 70, 2, 2, 64, True),      # Sq > Sk: rows without keys
    (2, 64, 190, 4, 1, 128, False),    # GQA rep 4
    (1, 1, 1000, 4, 2, 64, True),      # one query row
    (1, 129, 127, 2, 2, 128, True),    # Sq > Sk by one
    (1, 1000, 1000, 4, 1, 64, True),   # ragged, rep 4
    (1, 65, 129, 4, 2, 64, False),
    (2, 256, 256, 16, 16, 64, True),   # training heads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", BACKWARD_CASES)
def test_flash_backward_kernel_matches_plain(gen, dtype, b, sq, sk, hq, hkv,
                                             d, causal):
    """The forward's logsumexp within 1e-4 of the plain one (-inf where a
    row sees no key), then dq, dk, dv against the plain backward fed the
    same o, dO and lse."""
    q = _randn(gen, b, sq, hq, d, dtype=dtype)
    k, v = (_randn(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    dout = _randn(gen, b, sq, hq, d, dtype=dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    ref_out, ref_lse = _reference_flash_attention_lse(q, k, v, causal)
    _check(out, ref_out, dtype)
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead) and bool((lse[dead] < 0).all())
    diff = (lse - ref_lse)[~dead].abs()
    assert diff.numel() == 0 or float(diff.max()) <= 1e-4
    before = kernels.FLASH_ATTENTION_BWD.launches
    grads = flash_attention_backward_cuda(q, k, v, out, dout, lse, causal)
    assert kernels.FLASH_ATTENTION_BWD.launches == before + 1
    refs = _reference_flash_attention_backward(q, k, v, out, dout, lse,
                                               causal)
    for g, r in zip(grads, refs):
        assert g.dtype == dtype and g.shape == r.shape
        _check(g, r, dtype)
    if causal and sq > sk:
        assert torch.all(grads[0][:, :sq - sk] == 0)


def test_flash_attention_autograd_takes_a_strided_gradient(gen):
    """Through `flash_attention` with grad required, the output has a
    grad_fn and a non-contiguous incoming gradient (a broadcast weight)
    gives the plain backward's result."""
    dt = torch.bfloat16
    q = _randn(gen, 2, 128, 4, 64, dtype=dt).requires_grad_()
    k = _randn(gen, 2, 128, 2, 64, dtype=dt).requires_grad_()
    v = _randn(gen, 2, 128, 2, 64, dtype=dt).requires_grad_()
    w = _randn(gen, 64, dtype=dt).expand(2, 128, 4, 64)
    before = (kernels.FLASH_ATTENTION.launches,
              kernels.FLASH_ATTENTION_BWD.launches)
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    (out * w).sum().backward()
    assert (kernels.FLASH_ATTENTION.launches,
            kernels.FLASH_ATTENTION_BWD.launches) == (before[0] + 1,
                                                      before[1] + 1)
    with torch.no_grad():
        o, lse = flash_attention_cuda(q, k, v, True, with_lse=True)
        refs = _reference_flash_attention_backward(
            q, k, v, o, w.contiguous(), lse, True)
    for t, r in zip((q, k, v), refs):
        _check(t.grad, r, dt)


def test_decode_attention_raises_when_grad_is_required(gen):
    q = _randn(gen, 2, 4, 64, dtype=torch.bfloat16).requires_grad_()
    k = _randn(gen, 2, 16, 4, 64, dtype=torch.bfloat16)
    lens = torch.tensor([3, 16], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_attention(q, k, k, lens)
    with torch.no_grad():  # how the engine calls it
        out = decode_attention(q, k, k, lens)
    _check(out, _reference_decode_attention(q.detach(), k, k, lens),
           torch.bfloat16)


def _tiny_models(seed=3, **over):
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)

    cfg = TransformerConfig(**{**dict(
        vocab_size=300, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
        d_ff=344, max_seq=96, dtype=torch.float32), **over})
    return (Transformer(cfg, device="cuda", seed=seed),
            Transformer(cfg, device="cpu", seed=seed))


@pytest.mark.parametrize("moe_experts", [0, 4])
def test_transformer_gradients_on_the_card_match_the_cpu(gen, moe_experts):
    """f32, TF32 off: loss within 1e-5 and every parameter's gradient
    (wq, wk and wv through the flash backward kernel, GQA rep 2) within
    1e-4 * max(1, |ref|) of the plain path on the CPU."""
    from ray_tpu_torch.models.transformer import loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = _tiny_models(moe_experts=moe_experts)
    tokens = torch.randint(0, 300, (2, 65),
                           generator=torch.Generator().manual_seed(0))
    before = kernels.FLASH_ATTENTION_BWD.launches
    loss = loss_fn(card, tokens.cuda())
    loss.backward()
    assert kernels.FLASH_ATTENTION_BWD.launches == before + 2
    ref = loss_fn(cpu, tokens)
    ref.backward()
    assert abs(float(loss) - float(ref)) <= 1e-5
    for (name, p), r in zip(card.named_parameters(), cpu.parameters()):
        assert p.grad is not None, name
        err = (p.grad.cpu() - r.grad).abs() / r.grad.abs().clamp(min=1)
        assert float(err.max()) <= 1e-4, name


def test_adam_steps_on_the_card(gen):
    """Three Adam(1e-3) steps on one batch: the first loss equals the
    CPU's within 1e-5, every loss is finite and the last is the lowest."""
    from ray_tpu_torch.models.transformer import loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = _tiny_models()
    tokens = torch.randint(0, 300, (2, 65),
                           generator=torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(card.parameters(), lr=1e-3)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = loss_fn(card, tokens.cuda())
        loss.backward()
        opt.step()
        losses.append(float(loss))
    with torch.no_grad():
        assert abs(losses[0] - float(loss_fn(cpu, tokens))) <= 1e-5
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
