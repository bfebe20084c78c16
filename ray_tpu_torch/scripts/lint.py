"""`ray-tpu-torch lint`: the rtcheck static analysis suite over the port.

tools/rtcheck's six passes pick their files by the JAX package's prefix
and anchor on its registry files (`ray_tpu/_private/rtconfig.py`,
`events.py`, `rpc.py`, `exceptions.py` and its wire files), so run as they
are they check nothing under `ray_tpu_torch/`. Here each pass is pointed at
the port: where a pass reads its files through `wants`, a subclass
overrides that; where it reads module constants (its anchors, the
knob allowlist, the required wire files), the subclass carries the port's
own copy of the methods that read them and reuses the pass's helpers. The
passes, the port's baseline (`lint_baseline.json`, beside this file) and
the port's root go to `tools.rtcheck.core.run`; tools/rtcheck itself and
the reference's `ray-tpu lint` are untouched.

    python -m ray_tpu_torch.scripts.cli lint [--json] [paths ...]

The default root is `ray_tpu_torch` alone: tools/ is the reference's
checker, which `ray-tpu lint` checks. Every run is cold (no result cache):
rtcheck's cache is keyed by the checker's own source and would hand the
reference passes' results for a file to the port's passes.
"""

from __future__ import annotations

import ast
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROOTS = ("ray_tpu_torch",)
PREFIX = "ray_tpu_torch/"
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "lint_baseline.json")
REGISTRY_PATH = "ray_tpu_torch/_private/rtconfig.py"
EVENTS_PATH = "ray_tpu_torch/_private/events.py"
TAXONOMY_FILES = ("ray_tpu_torch/exceptions.py",
                  "ray_tpu_torch/_private/rpc.py")
WIRE_FILES = tuple(f"ray_tpu_torch/_private/{m}.py"
                   for m in ("task_spec", "lease", "worker", "worker_proc"))

#: RT_* names read straight from the environment in the port, each because
#: it must exist before the config snapshot does (or names the process).
#: The reference's allowlist (tools/rtcheck/passes/knob_registry.py) plus
#: the port's own.
PORT_BOOTSTRAP = {
    "RT_NUM_GPUS": "accelerator count probe, read before init (the "
                   "port's counterpart of RT_NUM_TPUS)",
}


def rtcheck():
    """tools.rtcheck.core, imported from this checkout: a foreign
    top-level `tools` package (or an installed entry point run outside the
    repo) is purged from sys.modules and the checkout's taken instead.
    Raises ImportError when the checkout has no tools/rtcheck."""
    try:
        from tools.rtcheck import core
        if os.path.dirname(os.path.dirname(os.path.abspath(
                core.__file__))) == os.path.join(REPO_ROOT, "tools"):
            return core
    except ImportError:
        pass
    if not os.path.isdir(os.path.join(REPO_ROOT, "tools", "rtcheck")):
        raise ImportError(f"no tools/rtcheck under {REPO_ROOT}")
    for mod in [m for m in sys.modules
                if m == "tools" or m.startswith("tools.")]:
        del sys.modules[mod]
    sys.path.insert(0, REPO_ROOT)
    from tools.rtcheck import core
    return core


def passes() -> list:
    """The six passes of tools/rtcheck, pointed at the port."""
    core = rtcheck()
    from tools.rtcheck.passes import (async_blocking, event_kinds,
                                      exception_taxonomy, knob_registry,
                                      lock_discipline, wire_schema)
    Finding = core.Finding

    class AsyncBlocking(async_blocking.AsyncBlockingPass):
        def wants(self, relpath: str) -> bool:
            return relpath.startswith((PREFIX + "_private/",
                                       PREFIX + "serve/"))

    class LockDiscipline(lock_discipline.LockDisciplinePass):
        def wants(self, relpath: str) -> bool:
            return relpath.startswith(PREFIX)

    class EventKinds(event_kinds.EventKindsPass):
        def wants(self, relpath: str) -> bool:
            return relpath.startswith(PREFIX)

        def check_file(self, ctx):
            facts = {}
            if ctx.path == EVENTS_PATH:
                kinds = event_kinds._declared_kinds(ctx.tree)
                if kinds:
                    facts["kinds"] = kinds
            uses = event_kinds._emit_sites(ctx)
            if uses:
                facts["uses"] = uses
            return [], facts or None

        def finalize(self, facts, project):
            kinds = {}
            for fact in facts.values():
                kinds.update(fact.get("kinds", {}))
            if not kinds:
                src = project.read_text(EVENTS_PATH)
                kinds = event_kinds._declared_kinds(ast.parse(src)) \
                    if src is not None else {}
            if not kinds:
                return [Finding(self.id, EVENTS_PATH, 1,
                                "no declared event kinds found in the "
                                "port's KINDS registry")]
            return [Finding(self.id, path, use["line"],
                            f"event kind {use['kind']!r} is not declared "
                            f"in the port's events.py KINDS registry")
                    for path, fact in sorted(facts.items())
                    for use in fact.get("uses", ())
                    if use["kind"] not in kinds]

    class ExceptionTaxonomy(exception_taxonomy.ExceptionTaxonomyPass):
        def wants(self, relpath: str) -> bool:
            return relpath.startswith(PREFIX)

        def check_file(self, ctx):
            findings, facts = [], {}
            if ctx.path in TAXONOMY_FILES:
                facts["taxonomy"] = sorted(
                    exception_taxonomy._exception_classes(ctx.tree))
            if ctx.path.startswith(PREFIX + "_private/"):
                findings.extend(exception_taxonomy._check_swallowed(ctx))
            raises = exception_taxonomy._handler_raises(ctx)
            if raises:
                facts["raises"] = raises
            return findings, facts or None

        def finalize(self, facts, project):
            taxonomy = (set(exception_taxonomy._BUILTIN_EXCS)
                        | exception_taxonomy._STDLIB_EXTRA)
            scanned = [f["taxonomy"] for f in facts.values()
                       if f.get("taxonomy")]
            for names in scanned:
                taxonomy.update(names)
            if not scanned:
                for relp in TAXONOMY_FILES:
                    src = project.read_text(relp)
                    if src is not None:
                        taxonomy |= exception_taxonomy._exception_classes(
                            ast.parse(src))
            return [Finding(self.id, path, r["line"],
                            f"RPC handler `{r['fn']}` raises {r['exc']}, "
                            f"which is not in ray_tpu_torch.exceptions / "
                            f"rpc transport errors / stdlib builtins")
                    for path, fact in sorted(facts.items())
                    for r in fact.get("raises", ())
                    if r["exc"] not in taxonomy]

    class KnobRegistry(knob_registry.KnobRegistryPass):
        def wants(self, relpath: str) -> bool:
            return relpath.startswith(PREFIX)

        def check_file(self, ctx):
            if ctx.path == REGISTRY_PATH:
                flags = knob_registry._registered_flags(ctx.tree)
                return [], ({"flags": flags} if flags else None)
            uses = knob_registry._env_literal_uses(ctx)
            return [], ({"uses": uses} if uses else None)

        def finalize(self, facts, project):
            flags = {}
            for fact in facts.values():
                flags.update(fact.get("flags", {}))
            if not flags:
                src = project.read_text(REGISTRY_PATH)
                flags = knob_registry._registered_flags(ast.parse(src)) \
                    if src is not None else {}
            if not flags:
                return [Finding(self.id, REGISTRY_PATH, 1,
                                "no registered flags found in the port's "
                                "rtconfig registry")]
            allow = {**knob_registry.BOOTSTRAP_ALLOWLIST, **PORT_BOOTSTRAP}
            env_of = {f"RT_{name.upper()}": name for name in flags}
            findings = []
            for path, fact in sorted(facts.items()):
                for use in fact.get("uses", ()):
                    name, line, kind = use["name"], use["line"], use["kind"]
                    if name in allow:
                        continue
                    if name in env_of:
                        if kind == "read":
                            findings.append(Finding(
                                self.id, path, line,
                                f"direct env read of {name} bypasses the "
                                f"port's rtconfig registry — use "
                                f"`CONFIG.{env_of[name]}`"))
                    elif kind in ("read", "write"):
                        findings.append(Finding(
                            self.id, path, line,
                            f"{name} is not a registered flag of the "
                            f"port's rtconfig (and not bootstrap-"
                            f"allowlisted) — add a `_flag(...)` entry and "
                            f"read it via CONFIG"))
                    else:
                        findings.append(Finding(
                            self.id, path, line,
                            f"unknown knob name {name} in a string "
                            f"literal — typo, or an unregistered knob being "
                            f"documented"))
            readme = project.read_text(knob_registry.README_PATH) or ""
            for name in sorted(flags):
                if f"RT_{name.upper()}" not in readme:
                    findings.append(Finding(
                        self.id, REGISTRY_PATH, flags[name],
                        f"registered flag '{name}' (RT_{name.upper()}) is "
                        f"missing from the README knob table"))
            return findings

    class WireSchema(wire_schema.WireSchemaPass):
        def wants(self, relpath: str) -> bool:
            return relpath.startswith(PREFIX)

        def finalize(self, facts, project):
            # The pass's own required-wire check names the reference's
            # files, which a port run never scans; this is its copy for the
            # port's.
            findings = []
            if all(p in project.analyzed for p in WIRE_FILES):
                marked = {site["wire"] for fact in facts.values()
                          for site in fact.get("sites", ())}
                findings += [Finding(
                    self.id, WIRE_FILES[0], 1,
                    f"required wire '{wire}' has no `# rtcheck: wire=` "
                    f"marked sites in the port")
                    for wire in wire_schema.REQUIRED_WIRES
                    if wire not in marked]
            return findings + super().finalize(facts, project)

    return [AsyncBlocking(), WireSchema(), KnobRegistry(), LockDiscipline(),
            ExceptionTaxonomy(), EventKinds()]


def run(roots=ROOTS, *, root: str = REPO_ROOT,
        baseline_path: str = BASELINE_PATH):
    """tools.rtcheck.core.run with the port's passes and baseline, cold."""
    return rtcheck().run(tuple(roots), root=root, use_cache=False,
                         baseline_path=baseline_path, passes=passes())


def main(paths=(), as_json: bool = False) -> int:
    """Print the findings (or one JSON object) of a run over `paths` (the
    port by default); 0 when none is left after the baseline."""
    res = run(tuple(paths) or ROOTS)
    if as_json:
        print(json.dumps({
            "ok": res.ok,
            "findings": [f.to_json() for f in res.findings],
            "baselined": [f.to_json() for f in res.baselined],
            "stale_baseline": res.stale_baseline,
            "files": res.files,
            "elapsed_s": round(res.elapsed_s, 3),
        }, indent=2))
        return 0 if res.ok else 1
    for f in res.findings:
        print(f.render())
    for key in res.stale_baseline:
        print(f"warning: stale baseline entry (no longer found): {key}")
    tail = (f"{res.files} files, {len(res.findings)} finding(s), "
            f"{len(res.baselined)} baselined, {res.elapsed_s:.2f}s")
    if res.ok:
        print(f"ray-tpu-torch lint: clean — {tail}")
        return 0
    print(f"ray-tpu-torch lint: FAILED — {tail}", file=sys.stderr)
    return 1
