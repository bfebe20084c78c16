"""The port's RMSNorm on the CPU: the plain forward against the model's
formula, the plain closed-form backward against autograd, the CPU path
launching nothing, and the launch plan's rules. The kernels themselves are
held to these plain versions on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import kernels
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.ops.rms_norm import (_reference_rms_norm,
                                        _reference_rms_norm_backward,
                                        _RMSNorm, bwd_max_blocks,
                                        launch_plan, rms_norm,
                                        rms_norm_backward_cuda,
                                        rms_norm_cuda)

EPS = 1e-6


def _formula(x, scale, eps):
    """The model's norm as RMSNorm.forward wrote it before the kernel."""
    x32 = x.to(torch.float32)
    norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                             + eps)
    return (norm * scale).to(x.dtype)


def _inputs(shape, dtype, seed=0, grad=False):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal(shape) * 3).to(dtype)
    scale = torch.from_numpy(rng.standard_normal(shape[-1])).to(
        torch.promote_types(dtype, torch.float32))
    if grad:
        x.requires_grad_()
        scale.requires_grad_()
    return x, scale


SHAPES = [(2, 7, 64), (5, 520), (3, 33), (4, 1), (2, 3, 96)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_forward_equals_the_models_formula_bitwise(dtype, shape):
    x, scale = _inputs(shape, dtype)
    y, r = _reference_rms_norm(x, scale, EPS)
    assert y.dtype == dtype and r.dtype == torch.float32
    assert torch.equal(y, _formula(x, scale, EPS))
    assert r.shape == x.shape[:-1]
    want = torch.rsqrt((x.float() ** 2).mean(-1) + EPS)
    torch.testing.assert_close(r, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(3, 5, 16), (4, 33)], ids=str)
def test_plain_closed_form_backward_passes_gradcheck_in_f64(shape):
    x, scale = _inputs(shape, torch.float64, seed=1, grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: _RMSNorm.apply(a, b, EPS, False), (x, scale))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd_of_the_formula(dtype, tol, shape):
    """dx within tol * max(1, |ref|) (bf16: one ulp of rounding on top of
    the f32 arithmetic's order) and dscale within 1e-5 of its norm."""
    x, scale = _inputs(shape, dtype, seed=2, grad=True)
    dy = torch.from_numpy(np.random.RandomState(3).standard_normal(
        shape)).to(dtype)
    want_dx, want_ds = torch.autograd.grad(_formula(x, scale, EPS),
                                           (x, scale), dy)
    _, r = _reference_rms_norm(x.detach(), scale.detach(), EPS)
    dx, ds = _reference_rms_norm_backward(x.detach(), scale.detach(), r, dy)
    assert dx.dtype == dtype and ds.dtype == torch.float32
    err = (dx.float() - want_dx.float()).abs() / want_dx.float().abs().clamp(
        min=1)
    assert float(err.max()) <= tol
    assert float((ds - want_ds).norm() / want_ds.norm()) <= 1e-5


def test_the_function_on_cpu_tensors_runs_the_plain_versions():
    """`_RMSNorm` on CPU tensors: the plain forward, and the closed-form
    backward's dx and dscale."""
    x, scale = _inputs((6, 40), torch.float32, seed=4, grad=True)
    dy = torch.randn(6, 40, generator=torch.Generator().manual_seed(5))
    y = _RMSNorm.apply(x, scale, EPS, False)
    assert torch.equal(y, _formula(x, scale, EPS))
    dx, ds = torch.autograd.grad(y, (x, scale), dy)
    _, r = _reference_rms_norm(x.detach(), scale.detach(), EPS)
    want = _reference_rms_norm_backward(x.detach(), scale.detach(), r, dy)
    assert torch.equal(dx, want[0]) and torch.equal(ds, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_on_cpu_takes_the_plain_path_and_launches_nothing(dtype):
    x, scale = _inputs((3, 4, 48), dtype, seed=6, grad=True)
    before = kernels.launch_counts()
    y = rms_norm(x, scale, EPS)
    y.float().square().sum().backward()
    got = (y, x.grad, scale.grad)
    x.grad = scale.grad = None
    want = _formula(x, scale, EPS)
    want.float().square().sum().backward()
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], x.grad) and torch.equal(got[2], scale.grad)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("shape", [(3, 5, 16), (4, 33)], ids=str)
def test_plain_residual_backward_passes_gradcheck_in_f64(shape):
    """With `residual`, the x that comes back carries a gradient of its
    own, which the backward adds into dx: the sum of both outputs'
    gradients, checked through each output and through both."""
    x, scale = _inputs(shape, torch.float64, seed=8, grad=True)
    for pick in (lambda out: out[1], lambda out: out[0] * 1.5,
                 lambda out: out[0] * out[1]):
        assert torch.autograd.gradcheck(
            lambda a, b: pick(_RMSNorm.apply(a, b, EPS, True)), (x, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_function_matches_autograd_of_the_residual_block(dtype):
    """(x, y) with the gradient of x added in the norm's backward: the
    values of x + f(y) as written out, and dx within rounding of
    autograd's own add (which rounds the two gradients apart in bf16)."""
    x, scale = _inputs((5, 7, 48), dtype, seed=9, grad=True)
    w = torch.from_numpy(np.random.RandomState(10).standard_normal(
        (48, 48)) / 7).to(dtype)
    dout = torch.from_numpy(np.random.RandomState(11).standard_normal(
        (5, 7, 48))).to(dtype)
    res, y = _RMSNorm.apply(x, scale, EPS, True)
    assert torch.equal(res, x) and torch.equal(y, _formula(x, scale, EPS))
    got = torch.autograd.grad(res + y @ w, (x, scale), dout)
    want = torch.autograd.grad(x + _formula(x, scale, EPS) @ w,
                               (x, scale), dout)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = (got[0].float() - want[0].float()).abs() / want[0].float().abs(
        ).clamp(min=1)
    assert float(err.max()) <= tol
    assert float((got[1] - want[1]).norm() / want[1].norm()) <= 1e-5
    _, r = _reference_rms_norm(x.detach(), scale.detach(), EPS)
    dy = (dout @ w.t()).detach()
    assert torch.equal(got[0], _reference_rms_norm_backward(
        x.detach(), scale.detach(), r, dy, dout)[0])


def test_residual_gradient_is_added_inside_the_norms_backward():
    """Through `_RMSNorm` with `residual`, the engine launches no add for
    x's two gradients: the residual's reaches the norm's backward. Written
    out, the same block adds them after it."""
    from torch.profiler import ProfilerActivity, profile

    x, scale = _inputs((4, 32), torch.float32, seed=13, grad=True)
    w = torch.eye(32) * 0.5
    node = "autograd::engine::evaluate_function: _RMSNormBackward"

    def adds(out):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out.sum().backward()
        return [c.name for e in prof.events() if e.name == node
                for c in e.cpu_children if c.name.startswith("aten::add")]

    res, y = _RMSNorm.apply(x * 1, scale, EPS, True)
    assert adds(res + y @ w) == []
    h = x * 1
    assert adds(h + _RMSNorm.apply(h, scale, EPS, False) @ w) != []


def test_residual_on_cpu_returns_the_input_and_the_plain_norm():
    x, scale = _inputs((2, 3, 40), torch.bfloat16, seed=12, grad=True)
    res, y = rms_norm(x, scale, EPS, residual=True)
    assert res is x and torch.equal(y, _formula(x, scale, EPS))
    with torch.no_grad():
        res, y = rms_norm(x, scale, EPS, residual=True)
    assert res is x and torch.equal(y, _formula(x, scale, EPS))


def _old_norm_forward(self, x):
    scale = T._use(self.scale, T.P(), self.mesh)
    with T.device_span("tf.norm"):
        return _formula(x, scale, self.eps)


def _old_block_forward(self, x, positions, cache=None):
    with T.device_span("tf.block"):
        x = x + self.attn(self.attn_norm(x), positions, cache=cache)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.mlp_norm(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_transformer_loss_and_gradients_unchanged(dtype, monkeypatch):
    """A CPU Transformer's loss and every gradient are bit for bit those of
    the norm written out as the model's formula."""
    cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=48, max_seq=16,
                              dtype=dtype)
    tokens = torch.randint(0, 64, (2, 9),
                           generator=torch.Generator().manual_seed(7))

    def run():
        model = T.Transformer(cfg, device="cpu", seed=3)
        loss = T.loss_fn(model, tokens)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    loss, grads = run()
    monkeypatch.setattr(T.RMSNorm, "forward", _old_norm_forward)
    monkeypatch.setattr(T.Block, "forward", _old_block_forward)
    want_loss, want_grads = run()
    assert torch.equal(loss, want_loss)
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name


@pytest.mark.parametrize("d,elem,plan", [
    (5120, 2, (2, 320, 1)),   # Phi-3-medium in bf16: 2 vectors a thread
    (3072, 2, (1, 384, 1)),   # Phi-3-mini, a served step's rows
    (3072, 4, (2, 384, 1)),
    (5120, 4, (4, 320, 1)),
    (520, 2, (1, 96, 2)),     # narrow rows share a block
    (64, 2, (1, 32, 8)),
    (33, 4, (1, 32, 8)),      # not a whole number of vectors
    (1, 2, (1, 32, 8)),
    (16384, 2, (4, 512, 1)),  # the widest rows
    (8192, 4, (4, 512, 1)),
])
def test_launch_plan_follows_the_width(d, elem, plan):
    k, tpr, rpb = launch_plan(d, elem)
    assert (k, tpr, rpb) == plan
    vecs = -(-d * elem // 16)
    assert tpr % 32 == 0 and tpr * k >= vecs and tpr * rpb <= 512
    assert rpb == 1 or (k == 1 and tpr * rpb <= 256)
    # the fewest vectors a thread that fit
    assert k == 1 or 32 * -(-vecs // (32 * (k // 2))) > 512


@pytest.mark.parametrize("d,elem", [(16385, 2), (8193, 4), (0, 2)])
def test_launch_plan_refuses_what_the_kernel_does_not_take(d, elem):
    with pytest.raises(ValueError, match="at most 32 KiB"):
        launch_plan(d, elem)


def test_backward_scratch_has_a_row_per_resident_block():
    # the training shape: 320-thread blocks, 6 a Hopper SM by threads
    assert bwd_max_blocks(16384, 5120, 2, 132) == 132 * 6
    assert bwd_max_blocks(3, 5120, 2, 132) == 3  # no more than the rows
    assert bwd_max_blocks(17, 64, 2, 132) == 3   # groups of 8 rows


def test_cuda_wrappers_raise_on_what_the_kernel_does_not_take():
    """The checks come before any launch, so they show on the CPU."""
    x, scale = _inputs((4, 64), torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        rms_norm_cuda(x, scale, EPS)
    with pytest.raises(ValueError, match="dtype"):
        rms_norm_cuda(x.half(), scale, EPS)
    with pytest.raises(ValueError, match="scale"):
        rms_norm_cuda(x, scale[:32], EPS)
    with pytest.raises(ValueError, match="float32"):
        rms_norm_cuda(x, scale.double(), EPS)
    with pytest.raises(ValueError, match="32 KiB"):
        wide = torch.zeros(2, 8193)
        rms_norm_cuda(wide, torch.ones(8193), EPS)
    with pytest.raises(ValueError, match="shaped like x"):
        rms_norm_backward_cuda(x, scale, torch.ones(4), x[:2])
    with pytest.raises(ValueError, match="shaped like x"):
        rms_norm_backward_cuda(x, scale, torch.ones(4), x, x[:2])
    with pytest.raises(ValueError, match="dtype"):
        rms_norm_backward_cuda(x, scale, torch.ones(4), x, x.double())
