"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one `.cu` file under `ray_tpu_torch/ops/csrc/` with a plain
C entry point (two for the RMSNorm, forward and backward, from one source;
helpers shared between them in `common.cuh`, the Hopper
building blocks of the two flash kernels in `hopper.cuh` and their f32
tile loads in `f32_tiles.cuh`). At first use
it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
under `build/ray_tpu_torch/` at the root of the checkout, named by a
hash of its source, the shared headers and the flags, and loaded with
`ctypes` (pointers and the stream passed as `c_void_p`). `build_all()`
starts one `nvcc` per source at once and waits for all of them.

Every `Kernel` counts its launches in a plain integer, `launches`, so a run
can show that its main path went through the kernel, and the attention
kernels (`HEAD_DIM_KERNELS`) by head dim in `launches_by_head_dim`. A build
failure and a non-zero launch status (`cudaGetLastError()` right after the
launch) both raise; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under CUDA_HOME or the
    toolkit's default prefix. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of ray_tpu_torch cannot be built on this machine")


class KernelBuildError(RuntimeError):
    """nvcc failed on a kernel's source; the message carries its output."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a non-zero cudaError_t."""


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.launches_by_head_dim: dict[int, int] = {}
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def library(self) -> Path:
        """The built library's path, named by a hash of the source, the
        shared headers and the flags (a changed input builds anew)."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    @property
    def build_log(self) -> Path:
        return self.library.with_suffix(".log")

    def start_build(self) -> subprocess.Popen | None:
        """Start nvcc unless the library is already built; returns the
        process (None when there is nothing to build)."""
        lib = self.library
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # two entry points of one source may build it from two threads
        tmp = lib.with_name(
            f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.rt_tmp = tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log.write_text(out)
        if proc.returncode != 0:
            proc.rt_tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}) on {self.source}:\n{out}")
        os.replace(proc.rt_tmp, self.library)  # atomic for concurrent builds

    def _load(self):
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.symbol}_error")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._err = err
                self._fn = fn
        return self._fn

    def launch(self, *args, head_dim: int | None = None) -> None:
        """Call the C entry point (which launches on the given stream and
        returns cudaGetLastError()); raise on a non-zero status, count the
        launch otherwise (also under `head_dim` when given)."""
        rc = (self._fn or self._load())(*args)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise KernelLaunchError(
                f"{self.name} launch failed: cudaError {rc} ({msg})")
        self.launches += 1
        if head_dim is not None:
            self.launches_by_head_dim[head_dim] = \
                self.launches_by_head_dim.get(head_dim, 0) + 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

DECODE_ATTENTION = Kernel(
    "decode_attention", "decode_attention.cu", "rt_decode_attention",
    # q, k, v, lengths, out, ws, counters, B, Hq, KV, S, D, dtype, group,
    # chunk, n_splits, stream
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
FLASH_ATTENTION = Kernel(
    "flash_attention", "flash_attention.cu", "rt_flash_attention",
    # q, k, v, out, lse (or None), B, Sq, Sk, Hq, Hkv, D, causal, dtype,
    # stream
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])
FLASH_ATTENTION_BWD = Kernel(
    "flash_attention_bwd", "flash_attention_bwd.cu", "rt_flash_attention_bwd",
    # q, k, v, o, dout, lse, delta, lse_log2, dq_accum, dq, dk, dv, B, Sq,
    # Sk, Hq, Hkv, D, causal, dtype, block_k, block_q, dkv_accum, hsplit,
    # stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
     _I, _I, _I, _I, _P, _I, _P])
RMS_NORM = Kernel(
    "rms_norm", "rms_norm.cu", "rt_rms_norm",
    # x, scale, y, rinv (or None), rows, d, eps, dtype, vec_per_thread,
    # threads_per_row, rows_per_block, stream
    [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P])
RMS_NORM_BWD = Kernel(
    "rms_norm_bwd", "rms_norm.cu", "rt_rms_norm_bwd",
    # x, dy, dres (or None), scale, rinv, dx, partial, dscale, rows, d,
    # dtype, vec_per_thread, threads_per_row, rows_per_block, max_blocks,
    # stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
#: the attention kernels, which also count their launches by head dim
HEAD_DIM_KERNELS = (DECODE_ATTENTION, FLASH_ATTENTION, FLASH_ATTENTION_BWD)
KERNELS = (*HEAD_DIM_KERNELS, RMS_NORM, RMS_NORM_BWD)
# One wgmma product through each narrow-row descriptor of hopper.cuh, for
# the card's tests only (no model path launches it, so it is not in
# KERNELS and build_all does not build it).
WGMMA_PROBE = Kernel(
    "wgmma_probe", "wgmma_probe.cu", "rt_wgmma_probe",
    # a, b, p, out, D, which, stream
    [_P, _P, _P, _P, _I, _I, _P])


def build_all() -> None:
    """Compile every kernel that is not built yet, one nvcc per source, all
    started together; raises KernelBuildError naming the first failure."""
    by_source = {k.source: k for k in KERNELS}.values()
    procs = [(k, k.start_build()) for k in by_source]
    errors = []
    for k, proc in procs:
        try:
            k.finish_build(proc)
        except KernelBuildError as e:
            errors.append(e)
    if errors:
        raise errors[0]


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_by_head_dim = {}


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def launch_counts_by_head_dim() -> dict[str, dict[int, int]]:
    return {k.name: dict(k.launches_by_head_dim) for k in HEAD_DIM_KERNELS}


#: The head dims the three attention kernels take (the JAX package's Pallas
#: kernels take any D): the wrappers raise a ValueError stating this rule for
#: any other.
HEAD_DIM_RULE = "a multiple of 8 from 8 to 256"


def supported_head_dim(d: int) -> bool:
    return d % 8 == 0 and 8 <= d <= 256


def dtype_code(dtype) -> int:
    """The C entry points' dtype argument: 0 float32, 1 bfloat16."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"unsupported dtype {dtype}: float32 or bfloat16")
