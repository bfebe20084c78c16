"""GPU detection: NVIDIA cards are the schedulable accelerator ("GPU").

Counterpart: ray_tpu/_private/accelerators.py, which counts TPU chips and
advertises pod-slice gang resources. The port counts CUDA cards the way the
reference's GPU accelerator manager does (reference
python/ray/_private/accelerators/nvidia_gpu.py: CUDA_VISIBLE_DEVICES, else
NVML's device count), without importing torch or initialising CUDA in the
node agent. The device files are no count: a containerised host can expose
/dev/nvidia<N> nodes for cards its driver does not give it. There is no
pod-slice counterpart on a GPU host, so none is advertised.
"""

from __future__ import annotations

import ctypes
import os

GPU_RESOURCE = "GPU"


def gpu_count() -> int:
    """Number of CUDA cards on this host: RT_NUM_GPUS, else the entries of
    CUDA_VISIBLE_DEVICES, else NVML's device count (0 where there is no
    NVIDIA driver)."""
    env = os.environ.get("RT_NUM_GPUS")
    if env:
        return int(env)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([c for c in visible.split(",") if c.strip()])
    return _nvml_device_count()


def _nvml_device_count() -> int:
    """The driver's device count through NVML (the library nvidia-smi
    reads), which creates no CUDA context."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return 0
    if nvml.nvmlInit_v2() != 0:
        return 0
    try:
        n = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(n)) != 0:
            return 0
        return int(n.value)
    finally:
        nvml.nvmlShutdown()


def host_resources(num_cpus: float | None = None,
                   num_gpus: float | None = None) -> dict[str, float]:
    r: dict[str, float] = {}
    r["CPU"] = float(num_cpus) if num_cpus is not None else float(os.cpu_count() or 1)
    gpus = num_gpus if num_gpus is not None else gpu_count()
    if gpus:
        r[GPU_RESOURCE] = float(gpus)
    return r
