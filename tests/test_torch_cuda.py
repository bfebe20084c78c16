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
                                                split_plan, stage_rows)
from ray_tpu_torch.ops.flash_attention import (
    _reference_flash_attention, _reference_flash_attention_backward,
    _reference_flash_attention_lse, bwd_head_split, flash_attention,
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
    """0, 1, chunk - 1, chunk, chunk + 1 and S for the split plan's chunk
    on this card."""
    elem = torch.finfo(dtype).bits // 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = split_plan(b, hq, kv, s, d, elem, sms).chunk
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
              (3, 8, 8, 64, 300),
              # a sequence of 32,768 rows: two levels of the merge tree
              (6, 8, 1, 64, 32768), (8, 16, 16, 64, 1024),
              (6, 8, 1, 64, 32768), (6, 8, 1, 256, 8192),
              (3, 8, 8, 64, 300)]
    for b, hq, kv, d, s in shapes:
        _decode_and_check(gen, torch.bfloat16, b, hq, kv, d, s)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert split_plan(1, 8, 1, 32768, 64, 2, sms).merge_groups > 1


def test_decode_kernel_zero_length_gives_zeros(gen):
    q = _randn(gen, 2, 4, 64, dtype=torch.bfloat16)
    k = _randn(gen, 2, 16, 4, 64, dtype=torch.bfloat16)
    lens = torch.tensor([0, 16], dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, k, lens)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kv,d,s", [
    (8, 1, 64, 32768),     # the long-context row: 8 heads on one KV head
    (1, 1, 64, 32768),     # one head: a contiguous copy per stage
    (8, 1, 64, 100000),
    (8, 2, 128, 100000),   # two KV heads: a copy per row
])
def test_decode_kernel_one_long_sequence(gen, dtype, hq, kv, d, s):
    """A single sequence of 32,768 or 100,000 rows, full and one row short
    of full: more chunks than the merge tree's first level takes in one
    block, so both levels run."""
    q = _randn(gen, 1, hq, d, dtype=dtype)
    k, v = (_randn(gen, 1, s, kv, d, dtype=dtype) for _ in range(2))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    elem = torch.finfo(dtype).bits // 8
    assert split_plan(1, hq, kv, s, d, elem, sms).merge_groups > 1
    for n in (s, s - 1):
        lens = torch.tensor([n], dtype=torch.int32, device="cuda")
        _check(decode_attention_cuda(q, k, v, lens),
               _reference_decode_attention(q, k, v, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(2, 600), (8, 8192)])
def test_decode_kernel_8_heads_on_one_kv_head_at_d256(gen, dtype, b, s):
    """Gemma-2B's multi-query heads: one block serves all 8 query heads of
    the KV head at D = 256 (tensor cores in bf16), at the plan's edge
    lengths."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = split_plan(b, 8, 1, s, 256, torch.finfo(dtype).bits // 8, sms)
    assert (plan.group, plan.n_groups) == (8, 1)
    _decode_and_check(gen, dtype, b, 8, 1, 256, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kv,d", [
    (8, 8, 80), (8, 8, 96),      # one head a block: CUDA cores, real width
    (16, 4, 80), (16, 4, 96),    # groups of 4: tensor cores in bf16
    (8, 1, 96),
])
def test_decode_kernel_real_width_rows_at_edge_lengths(gen, dtype, hq, kv,
                                                       d):
    """D = 80 and 96 (rows of 160 and 192 bf16 bytes, copied at their real
    width) at lengths 0, 1, a stage and a chunk each +- 1, and S."""
    s = 600
    elem = torch.finfo(dtype).bits // 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = split_plan(6, hq, kv, s, d, elem, sms)
    chunk, tile = plan.chunk, stage_rows(d, elem, plan.group)
    lens = sorted({n for n in (0, 1, tile - 1, tile, tile + 1, chunk - 1,
                               chunk, chunk + 1, s) if 0 <= n <= s})
    q = _randn(gen, len(lens), hq, d, dtype=dtype)
    k, v = (_randn(gen, len(lens), s, kv, d, dtype=dtype) for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, v, lens)
    live = lens > 0
    assert torch.all(out[~live] == 0)
    _check(out[live], _reference_decode_attention(q, k, v, lens)[live], dtype)


def test_decode_kernel_under_cuda_graph_capture(gen):
    """A CUDA graph captures one decode call (one kernel, no memset); after
    new lengths are copied into the captured tensor, a replay equals the
    eager call on them, for a shape with one merge level and one with
    two."""
    for b, hq, kv, d, s, first, then in (
            (8, 16, 16, 64, 1024, [1, 1024, 517, 64, 300, 900, 128, 777],
             [1024, 3, 700, 129, 1, 1000, 256, 5]),
            (1, 8, 1, 64, 32768, [32768], [20001])):
        q = _randn(gen, b, hq, d, dtype=torch.bfloat16)
        k, v = (_randn(gen, b, s, kv, d, dtype=torch.bfloat16)
                for _ in range(2))
        lens = torch.tensor(first, dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the workspace of the capture stream
            decode_attention_cuda(q, k, v, lens)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernels.DECODE_ATTENTION.launches
        with torch.cuda.graph(graph, stream=side):
            out = decode_attention_cuda(q, k, v, lens)
        assert kernels.DECODE_ATTENTION.launches == before + 1
        graph.replay()
        torch.cuda.synchronize()
        _check(out, _reference_decode_attention(q, k, v, lens),
               torch.bfloat16)
        lens.copy_(torch.tensor(then, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        eager = decode_attention_cuda(q, k, v, lens)
        assert torch.equal(out, eager)
        _check(out, _reference_decode_attention(q, k, v, lens),
               torch.bfloat16)


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
    # edges of the bf16 kernel's tiles (BWD_TILES: 128 keys; 128 query
    # rows at D=64, 64 at D=128)
    (1, 127, 127, 2, 2, 64, True),
    (1, 129, 129, 2, 2, 64, True),
    (1, 100, 129, 4, 2, 64, False),    # Sk one past a key tile
    (1, 200, 200, 8, 1, 128, True),    # GQA rep 8, D=128
    (4, 1024, 1024, 16, 16, 64, True),  # the training shape
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


def _backward_case(gen, b, sq, sk, hq, hkv, d, causal, dtype=torch.bfloat16):
    q = _randn(gen, b, sq, hq, d, dtype=dtype)
    k, v = (_randn(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    dout = _randn(gen, b, sq, hq, d, dtype=dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    return q, k, v, out, dout, lse


def test_flash_backward_kernel_repeats(gen):
    """Two calls on the same inputs: dq is a sum of f32 bulk reduce-adds in
    an order that changes from run to run, so the two agree within the
    tolerance and each matches the plain backward; dk and dv are bitwise
    equal (four blocks share each KV head here, their slots summed in
    order)."""
    args = _backward_case(gen, 2, 300, 300, 8, 2, 64, True)
    first = flash_attention_backward_cuda(*args, True)
    second = flash_attention_backward_cuda(*args, True)
    refs = _reference_flash_attention_backward(*args, True)
    for a, c, r in zip(first, second, refs):
        _check(a, r, torch.bfloat16)
        _check(c, r, torch.bfloat16)
        _check(a, c, torch.bfloat16)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.parametrize("b,s,h,d", [
    (1, 256, 4, 64),   # phase 2's f32 row
    (2, 256, 4, 8),    # the tile of 16 at D8
    (8, 32, 8, 16),    # the dryrun's training shape
])
def test_flash_backward_f32_is_bitwise_repeatable(gen, b, s, h, d):
    """The f32 backward sums in a fixed order (no atomics): two calls on
    the same inputs give bitwise equal dq, dk and dv, each within 1e-4 of
    the plain backward."""
    args = _backward_case(gen, b, s, s, h, h, d, True, dtype=torch.float32)
    first = flash_attention_backward_cuda(*args, True)
    second = flash_attention_backward_cuda(*args, True)
    refs = _reference_flash_attention_backward(*args, True)
    for a, c, r in zip(first, second, refs):
        _check(a, r, torch.float32)
        assert torch.equal(a, c)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_backward_gqa_head_split_at_exact_widths(gen, d):
    """Phase 2's GQA row (B2 Hq16 Hkv4 Sq512 < Sk1024, causal) at each
    exact width: the blocks share each KV head's query heads
    (bwd_head_split > 1), the result matches the plain backward and dk and
    dv are bitwise repeatable."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert bwd_head_split(2, 1024, 16, 4, d, sms) > 1
    args = _backward_case(gen, 2, 512, 1024, 16, 4, d, True)
    first = flash_attention_backward_cuda(*args, True)
    second = flash_attention_backward_cuda(*args, True)
    refs = _reference_flash_attention_backward(*args, True)
    for a, c, r in zip(first, second, refs):
        _check(a, r, torch.bfloat16)
        _check(c, r, torch.bfloat16)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


def test_flash_backward_kernel_shapes_in_a_row(gen):
    """Calls of different shapes one after another each give the plain
    backward's answer: the dQ accumulator and the other scratch carry
    nothing from one call to the next."""
    for shape in [(1, 300, 300, 4, 4, 64, True), (2, 64, 190, 4, 1, 128, False),
                  (1, 129, 127, 2, 2, 128, True), (1, 300, 300, 4, 4, 64, True)]:
        args = _backward_case(gen, *shape)
        grads = flash_attention_backward_cuda(*args, shape[-1])
        refs = _reference_flash_attention_backward(*args, shape[-1])
        for g, r in zip(grads, refs):
            _check(g, r, torch.bfloat16)


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


def _card_train_loop(config):
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig, loss_fn)

    cfg = TransformerConfig(**config["shape"], dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", seed=0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    kernels.reset_launch_counts()
    tokens = torch.from_numpy(config["tokens"]).long().cuda()
    loss = loss_fn(model, tokens)
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    train.report({"loss": loss.item(), "launches": kernels.launch_counts(),
                  "device": str(next(model.parameters()).device)})


def test_torch_trainer_step_on_the_card(gen, tmp_path):
    """One TorchTrainer step in a worker that holds the card: its loss is
    the in-process step's, and the flash kernels ran in the worker."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig, loss_fn)
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    shape = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                 n_kv_heads=2, d_ff=256, max_seq=256)
    tokens = np.random.RandomState(0).randint(0, 256, (2, 129)).astype(
        np.int32)
    rt.init(num_cpus=2)
    try:
        result = TorchTrainer(
            _card_train_loop,
            train_loop_config={"shape": shape, "tokens": tokens},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=str(tmp_path))).fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    rep = result.metrics
    assert rep["device"].startswith("cuda")
    assert rep["launches"]["flash_attention"] == 2
    assert rep["launches"]["flash_attention_bwd"] == 2
    model = Transformer(TransformerConfig(**shape, dtype=torch.bfloat16),
                        device="cuda", seed=0)
    want = loss_fn(model, torch.from_numpy(tokens).long().cuda()).item()
    assert rep["loss"] == pytest.approx(want, rel=1e-4)


def test_batch_inference_of_two_rows_on_the_card(gen):
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, batch_inference

    # D = 64
    cfg = LLMConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4,
                    max_seq=64, max_new_tokens=8)
    prompts = np.random.RandomState(1).randint(0, 256, (2, 6)).astype(
        np.int32)
    rt.init(num_cpus=2)
    try:
        rows = batch_inference(data.from_items([{"tokens": p}
                                                for p in prompts]),
                               cfg).take_all()
    finally:
        rt.shutdown()
    want = LLMEngine(cfg, device="cpu").generate(prompts)
    got = {tuple(r["tokens"]): r["generated"] for r in rows}
    for p, w in zip(prompts, want):
        np.testing.assert_array_equal(got[tuple(p)], w)


def test_pipelined_engine_on_the_card_gives_golden_tokens(gen):
    """Two stage actors on the card, on the golden float32 model: the
    golden greedy tokens, and each stage launched the decode kernel once
    per layer of each decode invocation it ran."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import SamplingParams
    from ray_tpu_torch.llm.pipeline import PipelinedEngine

    path = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_golden.npz")
    with np.load(path) as f:
        g = {k: f[k] for k in f.files}
    vocab, d_model, n_layers, n_heads, max_seq = (int(x) for x in g["config"])
    from ray_tpu_torch.models.convert import params_from_flax

    tree: dict = {}
    for key, arr in g.items():
        if key.startswith("params/"):
            node = tree
            *parents, leaf = key[len("params/"):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    cfg = LLMConfig(vocab_size=vocab, d_model=d_model, n_layers=n_layers,
                    n_heads=n_heads, max_seq=max_seq, dtype="float32",
                    params=params_from_flax(tree))
    prompts = [g[f"prompt_{i}"].tolist() for i in range(g["greedy"].shape[0])]
    rt.init(num_cpus=2)
    try:
        pipe = PipelinedEngine(cfg, n_stages=2, max_batch=2, device="cuda")
        try:
            pipe.reset_pipeline_stats()
            got = pipe.generate(prompts, SamplingParams(
                temperature=0.0, max_tokens=g["greedy"].shape[1]))
            stages = pipe.pipeline_stats()["stages"]
        finally:
            pipe.shutdown()
    finally:
        rt.shutdown()
    np.testing.assert_array_equal(np.asarray(got), g["greedy"])
    assert len(stages) == 2
    for s in stages:
        assert s["device"].startswith("cuda") and s["device_bytes"] > 0
        assert s["decode_steps"] > 0
        assert s["kernel_launches"]["decode_attention"] == \
            len(s["layers"]) * s["decode_steps"]


# ---- the reference's narrow heads: D = 16 and 32
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96])
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_wgmma_descriptor_products_match_a_plain_product(gen, d, which):
    """One wgmma product through each descriptor the flash kernels use,
    on tiles loaded by TMA as the kernels load them (wgmma_probe.cu): 0 the
    forward's Q K^T (both K-major), 1 the backward's K Q^T, 2 P V with P
    from registers and V MN-major, 3 dQ = dS K with dS^T and K MN-major.
    D = 64 runs the 128-byte swizzle's descriptors as a control; D = 80 and
    96 read a second panel that TMA filled past D with zeros, in case 2
    through an m64n16k16 / m64n32k16 on part of its swizzle atom. Both
    sides sum bf16 products in f32: within 1e-3 * max(1, |ref|)."""
    dt = torch.bfloat16
    shapes = {0: ((64, d), (128, d)), 1: ((64, d), (64, d)),
              2: ((64, 128), (128, d)), 3: ((128, 64), (128, d))}[which]
    a, b = (_randn(gen, *shape, dtype=dt) for shape in shapes)
    ref = {0: lambda: a.float() @ b.float().T,
           1: lambda: a.float() @ b.float().T,
           2: lambda: a.float() @ b.float(),
           3: lambda: a.float().T @ b.float()}[which]()
    out = torch.full_like(ref, float("nan"))
    stream = torch.cuda.current_stream().cuda_stream
    kernels.WGMMA_PROBE.launch(
        None if which == 2 else a.data_ptr(), b.data_ptr(),
        a.data_ptr() if which == 2 else None, out.data_ptr(), d, which,
        stream)
    torch.cuda.synchronize()
    err = (out - ref).abs() / ref.abs().clamp(min=1)
    assert torch.isfinite(out).all() and float(err.max()) <= 1e-3


NARROW_DECODE_CASES = [
    (4, 4, 16, 300), (16, 4, 16, 1024),   # rep 1 and 4 at D = 16
    (16, 16, 32, 1024), (16, 8, 32, 600),  # serving heads, rep 2 at D = 32
    (4, 1, 32, 300),                       # rep 4 at D = 32
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kv,d,s", NARROW_DECODE_CASES)
def test_decode_kernel_matches_plain_at_narrow_heads(gen, dtype, hq, kv, d,
                                                     s):
    """As test_decode_kernel_matches_plain, at head dims 16 and 32."""
    b = len(_edge_lengths(6, hq, kv, d, s, dtype))
    _decode_and_check(gen, dtype, b, hq, kv, d, s)


NARROW_FLASH_CASES = [
    (2, 200, 200, 4, 4, 16, True),
    (1, 77, 300, 8, 2, 32, True),      # GQA, Sq < Sk, ragged tiles
    (1, 130, 70, 2, 2, 16, True),      # Sq > Sk: rows without keys
    (2, 64, 190, 4, 1, 32, False),     # GQA rep 4
    (1, 129, 127, 2, 2, 32, True),     # Sq > Sk by one
    (1, 1000, 1000, 4, 1, 16, True),   # ragged, rep 4
    (8, 32, 32, 8, 8, 16, True),       # the dryrun's training heads
    (2, 128, 128, 8, 8, 32, True),     # entry()'s heads
    (1, 512, 1024, 8, 2, 16, True),    # GQA Sq512 < Sk1024
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", NARROW_FLASH_CASES)
def test_flash_kernels_match_plain_at_narrow_heads(gen, dtype, b, sq, sk, hq,
                                                   hkv, d, causal):
    """The forward (with its logsumexp) and the backward at head dims 16
    and 32 against their plain versions, as at 64 and 128."""
    q = _randn(gen, b, sq, hq, d, dtype=dtype)
    k, v = (_randn(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    dout = _randn(gen, b, sq, hq, d, dtype=dtype)
    before = kernels.FLASH_ATTENTION.launches
    _check(flash_attention_cuda(q, k, v, causal),
           _reference_flash_attention(q, k, v, causal), dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    assert kernels.FLASH_ATTENTION.launches == before + 2
    ref_out, ref_lse = _reference_flash_attention_lse(q, k, v, causal)
    _check(out, ref_out, dtype)
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead)
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
        assert torch.all(out[:, :sq - sk] == 0)
        assert torch.all(grads[0][:, :sq - sk] == 0)


def test_flash_backward_kernel_repeats_at_narrow_heads(gen):
    """dk and dv stay bitwise repeatable at D = 16 and 32; dq (f32
    reduce-adds) within the tolerance."""
    for d in (16, 32):
        args = _backward_case(gen, 2, 300, 300, 8, 2, d, True)
        first = flash_attention_backward_cuda(*args, True)
        second = flash_attention_backward_cuda(*args, True)
        _check(first[0], second[0], torch.bfloat16)
        assert torch.equal(first[1], second[1])
        assert torch.equal(first[2], second[2])


# ---- the parallelism layer: ranks sharing the card
@pytest.mark.parametrize("kind", ["decode", "flash", "flash_bwd"])
def test_kernels_at_tensor_parallel_per_rank_shapes(gen, kind):
    """tp=2 halves the serving and training heads: decode B8 Hq8 KV8 D64
    S1024 and flash forward and backward B4 S1024 H8 D64 (also Ulysses'
    per-rank head slice over sp=2), bf16, against the plain versions."""
    dt = torch.bfloat16
    if kind == "decode":
        q = _randn(gen, 8, 8, 64, dtype=dt)
        k, v = (_randn(gen, 8, 1024, 8, 64, dtype=dt) for _ in range(2))
        lens = torch.tensor([1, 1024, 517, 64, 300, 900, 128, 777],
                            dtype=torch.int32, device="cuda")
        _check(decode_attention_cuda(q, k, v, lens),
               _reference_decode_attention(q, k, v, lens), dt)
        return
    q, k, v, do = (_randn(gen, 4, 1024, 8, 64, dtype=dt) for _ in range(4))
    if kind == "flash":
        _check(flash_attention_cuda(q, k, v, True),
               _reference_flash_attention(q, k, v, True), dt)
        return
    o, lse = flash_attention_cuda(q, k, v, True, with_lse=True)
    for g, r in zip(
            flash_attention_backward_cuda(q, k, v, o, do, lse, True),
            _reference_flash_attention_backward(q, k, v, o, do, lse, True)):
        _check(g, r, dt)


def test_tp2_forward_of_two_ranks_on_one_card_matches_unsharded(gen):
    """Two rank processes share the card (gloo, host-staged collectives):
    the tp=2 forward's gathered logits equal the unsharded forward's within
    1e-4 (f32, TF32 off), each rank running the flash kernel once per
    layer on its head."""
    from ray_tpu_torch.parallel.dryrun import run_ranks
    from torch_parallel_ranks import card_tp_forward

    cfg = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
               n_kv_heads=2, d_ff=344, max_seq=64)
    tokens = np.random.RandomState(0).randint(0, 512, (2, 64))
    out = run_ranks(card_tp_forward, 2, cfg, tokens)
    for r in out:
        assert r["transport"] == "gloo" and r["flash_launches"] == 2
        err = np.abs(r["logits"] - out[0]["ref"]) / np.maximum(
            np.abs(out[0]["ref"]), 1)
        assert float(err.max()) <= 1e-4


def test_nccl_ranks_sharing_one_card_raise(gen):
    """nccl takes one card per rank: two ranks on the one card raise at
    mesh construction, before any collective; nothing falls back to
    gloo."""
    from ray_tpu_torch.parallel.dryrun import run_ranks
    from torch_parallel_ranks import nccl_on_one_card

    for msg in run_ranks(nccl_on_one_card, 2, backend="nccl"):
        assert "nccl needs one CUDA device per rank" in msg


# ---- every head dim the JAX package's kernels take: multiples of 8 to 256
WIDE_DECODE_CASES = [
    (32, 32, 96, 600),    # Phi-3-mini's heads (D = 96: workers of 16 lanes)
    (8, 1, 256, 600),     # Gemma-2B's query heads over one KV head, group 8
    (8, 8, 256, 300),     # D = 256, one head a block
    (32, 32, 80, 300),    # Phi-2's heads
    (4, 4, 8, 300),       # D = 8: a worker of one bf16 lane
    (16, 4, 8, 600),
    (8, 2, 120, 300),     # a width no listed model uses (tile 128)
    (4, 1, 24, 300),      # tile 32
    (6, 2, 200, 300),     # tile 256, group 4 (rep 3)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kv,d,s", WIDE_DECODE_CASES)
def test_decode_kernel_matches_plain_at_every_width(gen, dtype, hq, kv, d,
                                                    s):
    """As test_decode_kernel_matches_plain, at the new head dims (the
    runtime-width instances) and the split plan's edge lengths."""
    b = len(_edge_lengths(6, hq, kv, d, s, dtype))
    _decode_and_check(gen, dtype, b, hq, kv, d, s)


WIDE_FLASH_CASES = [
    (1, 300, 300, 4, 4, 96, True),
    (1, 77, 300, 8, 2, 80, True),      # GQA, Sq < Sk, ragged tiles
    (1, 130, 70, 2, 2, 96, True),      # Sq > Sk: rows without keys
    (2, 64, 190, 8, 1, 256, False),    # MQA rep 8 at D = 256
    (1, 200, 200, 8, 1, 256, True),
    (1, 129, 127, 2, 2, 256, True),    # Sq > Sk by one
    (2, 200, 200, 4, 4, 8, True),
    (1, 1000, 1000, 4, 1, 8, True),    # ragged, rep 4
    (1, 300, 300, 4, 2, 40, True),     # runtime widths: tiles 64, 128, 256
    (1, 129, 300, 2, 2, 120, False),
    (1, 200, 200, 2, 1, 136, True),
    (1, 100, 130, 2, 2, 24, True),     # tile 32
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", WIDE_FLASH_CASES)
def test_flash_kernels_match_plain_at_every_width(gen, dtype, b, sq, sk, hq,
                                                  hkv, d, causal):
    """The forward (with its logsumexp) and the backward at the new head
    dims against their plain versions, as at 16 to 128."""
    q = _randn(gen, b, sq, hq, d, dtype=dtype)
    k, v = (_randn(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    dout = _randn(gen, b, sq, hq, d, dtype=dtype)
    before = kernels.FLASH_ATTENTION.launches
    _check(flash_attention_cuda(q, k, v, causal),
           _reference_flash_attention(q, k, v, causal), dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    assert kernels.FLASH_ATTENTION.launches == before + 2
    ref_out, ref_lse = _reference_flash_attention_lse(q, k, v, causal)
    _check(out, ref_out, dtype)
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead)
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
        assert torch.all(out[:, :sq - sk] == 0)
        assert torch.all(grads[0][:, :sq - sk] == 0)


def test_flash_backward_kernel_repeats_at_every_width(gen):
    """D = 8, 80, 96 and 256 run runtime-width backward instances. At
    B2 S300 Hq8 Hkv2 their few blocks share each KV head's query heads
    (bwd_head_split > 1), at B4 S1024 H8 the grid is full without sharing;
    dk and dv are bitwise repeatable either way (the shares' slots are
    summed in order), dq within the tolerance."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (8, 80, 96, 256):
        for b, s, hq, hkv in ((2, 300, 8, 2), (4, 1024, 8, 8)):
            args = _backward_case(gen, b, s, s, hq, hkv, d, True)
            split = bwd_head_split(b, s, hq, hkv, d, sms)
            assert (split > 1) == (hkv == 2)
            first = flash_attention_backward_cuda(*args, True)
            second = flash_attention_backward_cuda(*args, True)
            refs = _reference_flash_attention_backward(*args, True)
            for a, c, r in zip(first, second, refs):
                _check(a, r, torch.bfloat16)
                _check(a, c, torch.bfloat16)
            assert torch.equal(first[1], second[1])
            assert torch.equal(first[2], second[2])
