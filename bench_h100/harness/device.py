"""The card: its name and power limit, CUDA-event timing, and an
nvidia-smi sampler.

`timed_ms` and `smi_sampler` are frozen copies of the repository's chip
smoke script's `_timed_ms` and `_smi_sampler` (the sampler also reads the
card's used memory), so that later changes to the program's own scripts
do not move the yardstick. Kernel times come from a profile's trace
(`trace.py`).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess

# About 1 ms at the H100's 1980 MHz: longer than the host takes to enqueue
# any call timed here.
SPIN_CYCLES = 2_000_000


def require_cards(n: int) -> None:
    """Raise unless CUDA is available with at least n cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_h100: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"bench_h100: the cell needs {n} cards, "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")


def describe(count: int) -> dict:
    """The contract's `device` object without its peak."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def timed_ms(fn, flush, reps: int = 20) -> float:
    """Median milliseconds of fn() over CUDA events, L2 flushed before each
    launch. A spin kernel of SPIN_CYCLES between the flush and the start
    event keeps the card busy while the host enqueues fn's launches, so the
    events time the device's work and not the host's dispatch."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SMI_FIELDS = ("sm_clock_mhz", "power_draw_w", "power_limit_w",
              "temperature_c", "memory_used_mib")


@contextlib.contextmanager
def smi_sampler(period_ms: int = 200):
    """Sample the card's SM clock, power draw, power limit, temperature and
    used memory with nvidia-smi while the block runs; yields a dict that
    holds their min / median / max once the block ends. The sampler is
    stopped on the way out, also when the block raises."""
    proc = subprocess.Popen(
        ["nvidia-smi",
         "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu,"
         "memory.used", "--format=csv,noheader,nounits", f"-lms={period_ms}"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    summary: dict = {}
    try:
        yield summary
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    rows = [r for r in rows if len(r) == len(SMI_FIELDS)]
    summary["samples"] = len(rows)
    for i, name in enumerate(SMI_FIELDS):
        col = sorted(r[i] for r in rows)
        if col:
            summary[name] = [col[0], statistics.median(col), col[-1]]
