"""The flash parity tests' comparison, with the evidence a failure needs.

`tests/test_torch_ops.py::test_flash_attention_matches_jax` and
`tests/test_torch_heads.py::test_flash_attention_matches_jax_at_narrow_heads`
have each failed once in a whole run of the suite (a few dozen elements
off by 2-4 times the tolerance) and never alone. `assert_flash_parity`
makes the same comparisons as before; on a failure its message also says
which rows were off, the port's normaliser (logsumexp) there, whether a
second computation of each side gives the same bits, and the process's
state (threads, precision settings, the test modules that ran before in
this process), so that the cause can be found from the failing run.
"""

import os
import sys

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _evidence(port, pallas, ref, tol, again) -> str:
    bad = np.abs(port - ref) > tol
    rows = sorted({(int(b), int(s), int(h))
                   for b, s, h, _ in np.argwhere(bad)})
    port2, pallas2, lse = again()
    lse = _numpy(lse)
    lines = [f"{int(bad.sum())} elements in {len(rows)} rows (batch, query "
             f"row, head) off; the first: {rows[:12]}",
             "their normaliser (natural-log logsumexp of the port): "
             + str([float(lse[b, h, s]) for b, s, h in rows[:12]]),
             f"computed again: the port's output bitwise equal "
             f"{np.array_equal(_numpy(port2), port)}, the Pallas output's "
             f"{np.array_equal(_numpy(pallas2), pallas)} (its largest "
             f"difference from the first "
             f"{float(np.abs(_numpy(pallas2) - pallas).max())})",
             f"torch threads {torch.get_num_threads()}, deterministic "
             f"{torch.are_deterministic_algorithms_enabled()}, default "
             f"dtype {torch.get_default_dtype()}, float32 matmul precision "
             f"{torch.get_float32_matmul_precision()}"]
    jax = sys.modules.get("jax")
    if jax is not None:
        lines.append("jax: " + ", ".join(
            f"{name} {getattr(jax.config, name, None)}" for name in (
                "jax_default_matmul_precision", "jax_enable_x64",
                "jax_default_device", "jax_platforms")))
    lines.append("env: " + ", ".join(
        f"{k}={os.environ.get(k)}" for k in (
            "XLA_FLAGS", "OMP_NUM_THREADS", "JAX_PLATFORMS",
            "PYTEST_XDIST_WORKER")))
    lines.append("test modules loaded in this process: " + str(sorted(
        m for m in sys.modules if m.rsplit(".", 1)[-1].startswith("test_"))))
    return "\n".join(lines)


def assert_flash_parity(port, pallas, xla, tol, again) -> None:
    """The JAX package's two paths agree within `tol` (absolute), then the
    port agrees with each. `again()` computes (the port's output, the
    Pallas output, the port's logsumexp [B, Hq, Sq]) anew, for a failure's
    message only."""
    port, pallas, xla = _numpy(port), _numpy(pallas), _numpy(xla)
    np.testing.assert_allclose(pallas, xla, atol=tol, rtol=0)
    for ref in (pallas, xla):
        try:
            np.testing.assert_allclose(port, ref, atol=tol, rtol=0)
        except AssertionError as e:
            raise AssertionError(
                f"{e}\n{_evidence(port, pallas, ref, tol, again)}") from None
