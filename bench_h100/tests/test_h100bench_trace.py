"""A Chrome trace reduced to busy time, kernel times and idle gaps."""

from __future__ import annotations

import json
import zipfile

from harness import trace


def _doc():
    ev = [
        # host: an outer op holding a launch, and a synchronise
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
         "ts": 60, "dur": 40},
        # device: two overlapping kernels, a copy, an annotation
        {"ph": "X", "cat": "kernel", "name": "void gemm_kernel<1>(int)",
         "ts": 20, "dur": 20, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "void gemm_kernel<1>(int)",
         "ts": 30, "dur": 20, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 70, "dur": 10, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step",
         "ts": 0, "dur": 100, "args": {"device": 0}},
    ]
    return {"traceEvents": ev}


def test_busy_is_the_union_of_device_work():
    red = trace.reduce(_doc())
    assert abs(red.window_s - 100e-6) < 1e-12
    assert abs(red.busy_s - 40e-6) < 1e-12  # [20, 50) and [70, 80)
    seconds, launches = red.kernels("gemm_kernel")
    assert abs(seconds - 40e-6) < 1e-12 and launches == 2
    assert red.device_ops[0][0] == "gemm_kernel<1>"


def test_idle_gaps_are_named_by_the_host_op():
    red = trace.reduce(_doc())
    gaps = dict(red.idle_gaps)
    # [0, 20) in aten::mm, [50, 70) and [80, 100) in the synchronise
    assert abs(gaps["aten::mm"] - 20e-6) < 1e-12
    assert abs(gaps["cudaEventSynchronize"] - 40e-6) < 1e-12


def test_loads_a_zipped_capture(tmp_path):
    path = tmp_path / "capture.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("trace.json", json.dumps(_doc()))
    assert trace.reduce(trace.load(str(path))).busy_s > 0
