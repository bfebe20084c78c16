#!/usr/bin/env python3
"""The flash-attention forward's rows, on one NVIDIA GPU.

    python3 chip_fwd_probe.py --rows [--parent DIR]

from the root of a checkout (builds into build/ray_tpu_torch/probe/).

Every forward row of PERF.md's kernel table (chip_smoke.py's FWD_TABLE),
held to the plain version and timed like phase 2 (CUDA events, L2 flushed,
median of 20), one JSON line a row: the kernel's time, the plain version's,
the library call's (SDPA, the backend phase 2 picks, in turns with the
kernel) and the bound; at f32, whether two calls give bitwise-equal outputs
and logsumexps. With --parent DIR (chip_rows.py) the checkout DIR's two
flash sources are built too, their ptxas lines printed beside this build's,
and DIR's forward is held to the same checks and timed in turns with this
one: `ms` and `parent_ms` are the medians of the four timings of each.

It imports nothing of JAX and exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import sys

import chip_rows


def _repeats(call) -> bool:
    """Two calls give bitwise-equal outputs and logsumexps."""
    import torch

    (o1, l1), (o2, l2) = call(), call()
    return bool(torch.equal(o1, o2) and torch.equal(l1, l2))


def _row(smoke, fa, row, gen, flush, versions) -> dict:
    import torch

    b, sq, sk, hq, hkv, d, dtype, causal = row
    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    ref = fa._reference_flash_attention(q, k, v, causal)

    def call():
        return fa.flash_attention_cuda(q, k, v, causal)

    sdpa, backends = smoke._sdpa_call(q, k, v, causal)
    ms, library_ms, backend = smoke._timed_in_turns(call, lambda: sdpa,
                                                    backends, flush)
    bound_ms, bound_by = smoke._flash_bound(*row)
    rec = {**versions.both("max_abs_err",
                           lambda: smoke._max_err(call(), ref, dtype)),
           "ms_beside_library": ms, "library_ms": library_ms,
           "library_backend": backend,
           "plain_ms": smoke._timed_ms(
               lambda: fa._reference_flash_attention(q, k, v, causal),
               flush),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if dtype == "float32":
        rec.update(versions.both("bitwise_repeat", lambda: _repeats(
            lambda: fa.flash_attention_cuda(q, k, v, causal,
                                            with_lse=True))))
    return {**rec, **versions.timed(smoke, call, flush)}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", action="store_true", required=True)
    parser.add_argument("--parent", default=None,
                        help="a checkout whose forward is timed in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_fwd_probe: CUDA is not available", file=sys.stderr)
        return 1
    return chip_rows.rows("ray_tpu_torch.ops.flash_attention",
                          ("FLASH_ATTENTION", "FLASH_ATTENTION_BWD"),
                          "FWD_TABLE", _row, args.parent)


if __name__ == "__main__":
    sys.exit(main())
