"""The port's attention ops against the JAX package's, on the CPU.

On a CPU tensor each of the port's wrappers runs its plain version; the JAX
side runs its Pallas kernels in interpret mode (as tests/test_ops.py does)
and its XLA reference paths. Inputs come from numpy with a fixed seed. All
comparisons are float32 within 2e-5: both sides keep softmax state in f32
and differ only in summation order. The TPU kernels need a cache length and
Sk that are multiples of 128 and an Sq that is a multiple of 8, so the
shared cases use those; the port's own rules beyond them (any length, zero
rows) are tested on the port alone.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tpu.ops.attention import _xla_attention
from ray_tpu.ops.decode_attention import (_xla_decode_attention,
                                          decode_attention_pallas)
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops import (decode_attention, dot_product_attention,
                               flash_attention)
from ray_tpu_torch.ops.attention import _reference_attention
from ray_tpu_torch.ops.decode_attention import decode_attention_cuda
from ray_tpu_torch.ops.flash_attention import flash_attention_cuda

TOL = 2e-5


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)


@pytest.mark.parametrize("b,hq,kv,d,s,lengths", [
    (3, 4, 4, 64, 256, [1, 100, 256]),   # MHA, ragged, full cache row
    (2, 8, 2, 128, 128, [1, 77]),        # GQA rep 4, D=128
    (2, 16, 16, 64, 128, [128, 5]),      # serving head layout
])
def test_decode_attention_matches_jax(b, hq, kv, d, s, lengths):
    rng = np.random.RandomState(0)
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, s, kv, d), \
        _randn(rng, b, s, kv, d)
    lens = np.asarray(lengths, np.int32)
    port = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens))
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    pallas = decode_attention_pallas(jq, jk, jv, jl, block_k=128,
                                     interpret=True)
    _close(port, pallas)
    _close(port, _xla_decode_attention(jq, jk, jv, jl))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 256, 256, 4, 4, 64),
    (1, 128, 384, 8, 2, 64),     # GQA, Sq < Sk (diagonal offset 256)
    (1, 128, 128, 2, 2, 128),
])
def test_flash_attention_matches_jax(b, sq, sk, hq, hkv, d, causal):
    rng = np.random.RandomState(1)
    q, k, v = _randn(rng, b, sq, hq, d), _randn(rng, b, sk, hkv, d), \
        _randn(rng, b, sk, hkv, d)
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(port, jax_flash(jq, jk, jv, causal=causal, block_q=128,
                           block_k=128, interpret=True))
    _close(port, _xla_attention(jq, jk, jv, causal=causal))
    port_dpa = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    _close(port_dpa, _xla_attention(jq, jk, jv, causal=causal))


@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 130), (192, 128)])
def test_reference_attention_matches_xla_any_shape(sq, sk):
    """`_reference_attention` is the XLA path, Sq > Sk included (rows that
    see no key are the mean of V there); no tile rule applies."""
    rng = np.random.RandomState(2)
    q, k, v = _randn(rng, 1, sq, 4, 64), _randn(rng, 1, sk, 2, 64), \
        _randn(rng, 1, sk, 2, 64)
    port = _reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    _close(port, _xla_attention(*map(jnp.asarray, (q, k, v)), causal=True))


def test_flash_rows_without_keys_are_zero():
    """The port's rule for causal Sq > Sk: rows that see no key are zeros;
    the other rows equal the XLA path."""
    rng = np.random.RandomState(3)
    q, k, v = _randn(rng, 1, 192, 2, 64), _randn(rng, 1, 128, 2, 64), \
        _randn(rng, 1, 128, 2, 64)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True).numpy()
    assert np.all(out[:, :64] == 0)
    ref = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=True))
    _close(out[:, 64:], ref[:, 64:])


def test_decode_attention_any_cache_length():
    """No %128 rule in the port: S=100, lengths within it, against the
    dense XLA reference."""
    rng = np.random.RandomState(4)
    q, k, v = _randn(rng, 2, 4, 64), _randn(rng, 2, 100, 2, 64), \
        _randn(rng, 2, 100, 2, 64)
    lens = np.asarray([3, 100], np.int32)
    port = decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    _close(port, _xla_decode_attention(*map(jnp.asarray, (q, k, v, lens))))


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers raise ValueError naming the shape for head dims
    other than 64/128, and refuse CPU tensors rather than computing."""
    z = torch.zeros
    with pytest.raises(ValueError, match="D=32"):
        decode_attention_cuda(z(1, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32),
                              z(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="D=32"):
        flash_attention_cuda(z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(z(1, 2, 64), z(1, 8, 2, 64), z(1, 8, 2, 64),
                              z(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(z(1, 8, 2, 64), z(1, 8, 2, 64), z(1, 8, 2, 64))


def test_cuda_entry_points_raise_without_cuda():
    """Asked for "cuda" where there is none, the entry points raise instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import ContinuousEngine
    from ray_tpu_torch.llm.openai import OpenAIServer
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)

    cfg = LLMConfig(vocab_size=300, d_model=64, n_layers=1, n_heads=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(TransformerConfig(vocab_size=16, d_model=64, n_layers=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OpenAIServer(cfg)
