"""The port's CUDA kernels and its engine on the card, against their plain
PyTorch versions. These need an NVIDIA GPU and nvcc and skip elsewhere;
on the card run them with

    python -m pytest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: float32 within 1e-4 (same f32 arithmetic, other summation
order); bfloat16 outputs within 2e-2 * max(1, |ref|) (one bf16 ulp of
rounding on top of that).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import kernels
from ray_tpu_torch.ops.decode_attention import (_reference_decode_attention,
                                                decode_attention_cuda)
from ray_tpu_torch.ops.flash_attention import (_reference_flash_attention,
                                               flash_attention_cuda)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kv,d", [(4, 4, 64), (8, 2, 128), (24, 2, 64)])
def test_decode_kernel_matches_plain(gen, dtype, hq, kv, d):
    b, s = 3, 300
    q = _randn(gen, b, hq, d, dtype=dtype)
    k, v = (_randn(gen, b, s, kv, d, dtype=dtype) for _ in range(2))
    lens = torch.tensor([1, 300, 129], dtype=torch.int32, device="cuda")
    before = kernels.DECODE_ATTENTION.launches
    out = decode_attention_cuda(q, k, v, lens)
    assert kernels.DECODE_ATTENTION.launches == before + 1
    _check(out, _reference_decode_attention(q, k, v, lens), dtype)


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
