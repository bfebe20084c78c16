"""Row timing shared by the chip probes (chip_decode_probe.py,
chip_bwd_probe.py and chip_fwd_probe.py --rows).

Each probe's --rows mode takes the rows of one of chip_smoke.py's tables
(DECODE_TABLE, BWD_TABLE, FWD_TABLE), holds the kernel to its plain version
and times it as phase 2 does (CUDA events, L2 flushed, median of 20), one
JSON line a row. With --parent DIR it also builds the probe's kernels from
the checkout DIR's ops/csrc (the same C entry points, called through this
checkout's wrappers, so their arguments must not have changed), prints
their ptxas lines beside this build's, holds them to the plain version too
and times the two in turns (parent, change, change, parent, twice) in one
process: two versions compare in one call on one card. It imports nothing
of JAX.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
TURNS = ("parent", "change", "change", "parent") * 2


def build(sources: dict, kernels, include: str | None = None) -> dict:
    """{name: CDLL} of {name: CUDA source}, one nvcc each, all at once, into
    build/ray_tpu_torch/probe/ (nvcc's output beside each library as
    <name>.log); the sources' includes are read from `include` (default:
    the kernels' own csrc)."""
    out_dir = os.path.join(REPO, "build", "ray_tpu_torch", "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(source)
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I",
             include or str(kernels.CSRC), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        with open(lib[:-3] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the probe's {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def kernel_from(handle, template):
    """A Kernel like `template` (a ray_tpu_torch._private.kernels.Kernel)
    whose launches go to the same C entry point of the library `handle`."""
    kernel = type(template)(template.name, template.source.name,
                            template.symbol, template.argtypes)
    kernel._fn = getattr(handle, template.symbol)
    kernel._fn.argtypes, kernel._fn.restype = kernel.argtypes, ctypes.c_int
    kernel._err = getattr(handle, f"{template.symbol}_error")
    kernel._err.argtypes, kernel._err.restype = [ctypes.c_int], \
        ctypes.c_char_p
    return kernel


def smoke():
    """chip_smoke.py of this checkout (its tables and timers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_probe", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


class Versions:
    """This checkout's kernels (attributes of its kernels module, by name)
    and, with a parent, the parent's builds of the same C entry points."""

    def __init__(self, kernels, names: tuple, parent: dict | None):
        self.kernels, self.names, self.parent = kernels, names, parent

    def on(self, kind: str, fn):
        """fn() with the named kernels of `kind` ("change" or "parent")."""
        if kind == "change":
            return fn()
        shipped = {n: getattr(self.kernels, n) for n in self.names}
        for n in self.names:
            setattr(self.kernels, n, self.parent[n])
        try:
            return fn()
        finally:
            for n, k in shipped.items():
                setattr(self.kernels, n, k)

    def both(self, key: str, fn) -> dict:
        """{key: fn()}, and with a parent {"parent_" + key: fn()} on its
        kernels."""
        rec = {key: fn()}
        if self.parent is not None:
            rec["parent_" + key] = self.on("parent", fn)
        return rec

    def timed(self, smoke, call, flush) -> dict:
        """{"ms"} of call(), timed like phase 2; with a parent the medians
        of TURNS' timings of each ("ms", "parent_ms") and the timings."""
        if self.parent is None:
            return {"ms": smoke._timed_ms(call, flush)}
        times = {"parent": [], "change": []}
        for kind in TURNS:
            times[kind].append(
                self.on(kind, lambda: smoke._timed_ms(call, flush)))
        return {"ms": statistics.median(times["change"]),
                "parent_ms": statistics.median(times["parent"]),
                "ms_turns": times["change"],
                "parent_ms_turns": times["parent"]}


def _compare_ptxas(sm, kernels, names: tuple) -> None:
    """One `ptxas` JSON line a kernel: the instances whose ptxas line
    (registers, shared memory, spills) is the same in this checkout's build
    and the parent's, those that differ, and those only one build has."""
    probe = os.path.join(REPO, "build", "ray_tpu_torch", "probe")
    for name in names:
        k = getattr(kernels, name)
        with open(os.path.join(probe, f"{k.name}_parent.log")) as f:
            parent = f.read()
        change, was = [dict(line.split(": ", 1)
                            for line in sm._ptxas_summary(text))
                       for text in (k.build_log.read_text(), parent)]
        print("ptxas " + json.dumps({
            "kernel": k.name,
            "same": sorted(n for n in change if was.get(n) == change[n]),
            "differ": {n: [was[n], change[n]] for n in change
                       if n in was and was[n] != change[n]},
            "only_change": {n: change[n] for n in change if n not in was},
            "only_parent": {n: was[n] for n in was if n not in change}}),
            flush=True)


def _parent_kernels(sm, kernels, names: tuple, parent_tree: str) -> dict:
    """{name: Kernel} built from parent_tree's csrc, beside this checkout's
    builds of the same kernels (all nvcc at once)."""
    csrc = os.path.join(os.path.abspath(parent_tree), "ray_tpu_torch", "ops",
                        "csrc")
    mine = [getattr(kernels, n) for n in names]
    builds = [(k, k.start_build()) for k in mine]
    sources = {}
    for k in mine:
        with open(os.path.join(csrc, k.source.name)) as f:
            sources[f"{k.name}_parent"] = f.read()
    libs = build(sources, kernels, include=csrc)
    for k, proc in builds:
        k.finish_build(proc)
    _compare_ptxas(sm, kernels, names)
    return {n: kernel_from(libs[f"{k.name}_parent"], k)
            for n, k in zip(names, mine)}


def rows(module: str, kernel_names: tuple, table: str, run_row,
         parent_tree: str | None = None) -> int:
    """Every row of chip_smoke.<table>: imports `module` (an ops module of
    this checkout), builds the named kernels (attributes of its kernels
    module) and, with parent_tree, the parent's, prints the card, then one
    `row` JSON line a row: {"case"} and what
    run_row(smoke, mod, row, gen, flush, versions) returns."""
    import torch

    sys.path.insert(0, REPO)
    sm = smoke()
    from ray_tpu_torch._private import kernels
    mod = importlib.import_module(module)
    parent = None
    if parent_tree is not None:
        parent = _parent_kernels(sm, kernels, kernel_names, parent_tree)
    for name in kernel_names:
        getattr(kernels, name)._load()
    versions = Versions(kernels, kernel_names, parent)
    print(smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for case, row in getattr(sm, table).items():
        rec = run_row(sm, mod, row, gen, flush, versions)
        print("row " + json.dumps({"case": case, **rec}), flush=True)
    return 0
