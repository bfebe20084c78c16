"""RMSNorm over the last axis, in f32, with its gradient.

`rms_norm(x, scale, eps)` is the model's norm: r = rsqrt(mean(x^2) + eps)
per row and y = (x r) scale, computed in f32 and rounded once to x's
dtype; scale is [d], read in f32. On a CPU tensor it runs the plain version,
`_reference_rms_norm`, the formula the model always ran, with autograd
through it. On a CUDA tensor it launches the hand-written kernel
(`csrc/rms_norm.cu`), or raises a ValueError that states what the kernel
takes; nothing falls back.

When autograd needs a gradient (grad mode on and an input that requires
grad), a CUDA call goes through `_RMSNorm`: its forward also writes r (one
f32 a row) and saves x, scale and r, nothing in f32 the size of x; its
backward launches the backward kernel, which writes dx and, through an f32
scratch of partial sums added in a fixed order, dscale. Both are bitwise
repeatable. Under `torch.no_grad()` the forward writes y alone.
`_RMSNorm` on CPU tensors runs the plain forward and the plain closed-form
backward, `_reference_rms_norm_backward`, the kernel's function.

`rms_norm(x, scale, eps, residual=True)` returns (x, y): a residual block
adds its branch to that x, and the gradient reaching x that way reaches
the norm's backward, which adds it into dx in the same pass (on the CPU
the same x and y come back, and autograd adds the two gradients as it
always did).

Widths: any d from 1 up to a row of 32 KiB (16384 in bfloat16, 8192 in
float32). `launch_plan` lays a row out over a group of threads from d
alone; the kernel loads 16-byte vectors where d is a multiple of the
vector and the pointers are aligned, elements otherwise.

Counterpart: ray_tpu/models/transformer.py (RMSNorm), plain jnp that XLA
fuses; the JAX package has no kernel for it.
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch._private import kernels

#: The widths the kernel takes; the wrappers raise a ValueError stating it.
WIDTH_RULE = ("a row of at most 32 KiB: d from 1 to 16384 in bfloat16, to "
              "8192 in float32")
ROW_BYTES_MAX = 32768
#: threads of a row group at most, and of a block (rms_norm.cu, kMaxThreads)
MAX_THREADS = 512
#: a block of narrow rows holds this many threads (several rows)
BLOCK_THREADS = 256
#: resident threads an SM holds (Hopper): the backward's scratch has a row
#: per block that can run at once, at most this over the block's threads
THREADS_PER_SM = 2048


def launch_plan(d: int, elem: int) -> tuple[int, int, int]:
    """(vectors a thread holds K, threads a row takes, rows a block holds)
    for rows of d elements of `elem` bytes: the fewest of K = 1, 2, 4 that
    let whole warps of at most MAX_THREADS hold the row's 16-byte vectors,
    and narrow rows several to a block of BLOCK_THREADS. Raises a
    ValueError outside WIDTH_RULE."""
    if not 1 <= d * elem <= ROW_BYTES_MAX:
        raise ValueError(f"rms_norm kernel takes {WIDTH_RULE}; got d={d}")
    vecs = -(-d * elem // 16)
    k, tpr = next((k, 32 * -(-vecs // (32 * k))) for k in (1, 2, 4)
                  if 32 * -(-vecs // (32 * k)) <= MAX_THREADS)
    return k, tpr, max(1, BLOCK_THREADS // tpr)


@functools.lru_cache(maxsize=64)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_max_blocks(rows: int, d: int, elem: int, sms: int) -> int:
    """Rows of the backward's f32 scratch: one per block that can run on
    the card at once (by threads; the kernel takes fewer where its
    registers allow fewer), and no more than the rows' groups."""
    _, tpr, rpb = launch_plan(d, elem)
    return max(1, min(-(-rows // rpb),
                      sms * max(1, THREADS_PER_SM // (tpr * rpb))))


def _reference_rms_norm(x, scale, eps: float):
    """Plain version (any device): (y in x's dtype, r [...] in the compute
    dtype). f32 for f32 and bf16 inputs (f64 for f64, so gradcheck can run
    it); y's autograd graph is the model's formula as it always was."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * r * scale).to(x.dtype), r.squeeze(-1)


def _reference_rms_norm_backward(x, scale, r, dy, dres=None):
    """Plain closed-form backward (any device), the kernel's function: with
    g = dy scale, dx = r (g - x r^2 mean(g x)) (+ dres, the gradient
    reaching x by the residual path, where given) and dscale = the sum over
    rows of dy x r, in the compute dtype. Returns (dx in x's dtype, dscale
    in scale's)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, dy32, r = x.to(acc), dy.to(acc), r.to(acc).unsqueeze(-1)
    g = dy32 * scale.to(acc)
    dx = r * (g - x32 * (r * r * torch.mean(g * x32, dim=-1, keepdim=True)))
    if dres is not None:
        dx = dx + dres.to(acc)
    dscale = (dy32 * (x32 * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _check(what: str, x, scale, *more):
    """Shape, width, dtype, device and layout checks shared by the
    wrappers; `more` are tensors shaped like x. Returns (rows, d, the
    kernel's dtype code, launch_plan)."""
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"{what}: scale {tuple(scale.shape)} must be "
                         f"[d] for x {tuple(x.shape)} [..., d]")
    if any(t.shape != x.shape for t in more):
        raise ValueError(f"{what}: dy and dres must be shaped like x "
                         f"{tuple(x.shape)}, got "
                         f"{[tuple(t.shape) for t in more]}")
    code = kernels.dtype_code(x.dtype)
    if any(t.dtype != x.dtype for t in more) or scale.dtype != torch.float32:
        raise ValueError(f"{what}: scale must be float32 and dy and dres "
                         f"x's dtype, "
                         f"got {scale.dtype} and "
                         f"{[str(t.dtype) for t in more]}")
    d = x.shape[-1]
    plan = launch_plan(d, x.element_size())
    tensors = (x, scale, *more)
    if any(t.device != x.device or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    return x.numel() // max(d, 1), d, code, plan


def rms_norm_cuda(x, scale, eps: float, *, with_r: bool = False):
    """Launch the forward kernel on the current stream, without
    synchronising: x [..., d] float32 or bfloat16, scale float32 [d], both
    contiguous on one CUDA device. Returns y like x, or (y, r f32 [...])
    when `with_r`."""
    rows, d, code, (k, tpr, rpb) = _check("rms_norm", x, scale)
    y = torch.empty_like(x)
    r = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
         if with_r else None)
    if rows:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            kernels.RMS_NORM.launch(
                x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                None if r is None else r.data_ptr(), rows, d, float(eps),
                code, k, tpr, rpb, stream)
    return (y, r) if with_r else y


def rms_norm_backward_cuda(x, scale, r, dy, dres=None):
    """Launch the backward kernels on the current stream, without
    synchronising: x and dy [..., d] of one dtype, scale float32 [d], r the
    forward's f32 [...], and dres (like dy, or None) a gradient reaching x
    by another path, added into dx. The f32 scratch of partial dscale rows
    is allocated here. Returns (dx like x, dscale float32 [d])."""
    more = (dy,) if dres is None else (dy, dres)
    rows, d, code, (k, tpr, rpb) = _check("rms_norm backward", x, scale,
                                          *more)
    if (r.shape != x.shape[:-1] or r.dtype != torch.float32
            or r.device != x.device or not r.is_contiguous()):
        raise ValueError(f"rms_norm backward: r must be contiguous float32 "
                         f"{tuple(x.shape[:-1])} on {x.device}, got "
                         f"{r.dtype} {tuple(r.shape)} on {r.device}")
    dx = torch.empty_like(x)
    if not rows:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    blocks = bwd_max_blocks(rows, d, x.element_size(),
                            _sms(x.device.index or 0))
    partial = torch.empty(blocks, d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        kernels.RMS_NORM_BWD.launch(
            x.data_ptr(), dy.data_ptr(),
            None if dres is None else dres.data_ptr(), scale.data_ptr(),
            r.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dscale.data_ptr(), rows, d, code, k, tpr, rpb, blocks, stream)
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with its gradient. The forward saves x, scale and r and
    returns y, or (x, y) with `residual`; CUDA tensors go to the kernels,
    CPU tensors to the plain versions. A gradient that never arrives is
    None (no zeros are made for it)."""

    @staticmethod
    def forward(ctx, x, scale, eps, residual):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            y, r = _reference_rms_norm(x, scale, eps)
        else:
            y, r = rms_norm_cuda(x, scale, eps, with_r=True)
        ctx.save_for_backward(x, scale, r)
        return (x, y) if residual else y

    @staticmethod
    def backward(ctx, *grads):
        x, scale, r = ctx.saved_tensors
        dres, dy = grads if len(grads) == 2 else (None, grads[0])
        if dy is None:
            return dres, None, None, None
        # the gradients reaching the norm come through reshapes, a matmul
        # and an add, and need not be contiguous; the kernel takes rows in
        # place
        dy = dy.contiguous()
        if dres is not None:
            dres = dres.contiguous()
        if x.device.type == "cpu":
            dx, dscale = _reference_rms_norm_backward(x, scale, r, dy, dres)
        else:
            dx, dscale = rms_norm_backward_cuda(x, scale, r, dy, dres)
        return dx, dscale, None, None


def rms_norm(x, scale, eps: float, *, residual: bool = False):
    """x [..., d] -> (x r) scale in x's dtype, r = rsqrt(mean(x^2) + eps)
    per row, in f32; with `residual`, (x, y) (module docstring). CPU
    tensors run the plain formula (autograd through it), CUDA tensors the
    kernels; differentiable when autograd needs it."""
    if x.device.type == "cpu":
        y = _reference_rms_norm(x, scale, eps)[0]
        return (x, y) if residual else y
    # the kernels read rows in place and an f32 scale; a model kept in
    # bfloat16 (served weights) casts its [d] scale here, as the formula's
    # f32 product promotes it, and autograd casts dscale back
    x, scale = x.contiguous(), scale.float()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps, residual)
    y = rms_norm_cuda(x, scale, eps)
    return (x, y) if residual else y
