"""Front 1: the AST lint (rules L1-L4) over the port's sources.

The port's counterpart of ``repro.analysis.lint``, with its machinery
(import-alias resolution, the ``# repro: noqa(RULE)`` suppression) as the
reference has it: pure stdlib ``ast``, so the lint runs anywhere.  Names
are resolved through the module's import aliases -- ``import
torch.distributed as dist; dist.all_reduce`` and ``from torch.distributed
import all_reduce`` both resolve to ``torch.distributed.all_reduce`` -- so
the rules fire on what the code means, not on how it spells it.
"""
from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.analysis import Finding

# --- per-rule allow-lists (repo-relative posix paths) ----------------------
L1_ALLOWED = ("src/repro_torch/parallel/comm.py",
              "src/repro_torch/testing/nccl_probe.py")
L2_ENV_ALLOWED = ("tests/conftest.py",)
L3_ALLOWED: tuple = ()
L4_ALLOWED = ("src/repro_torch/testing/timing.py",)

#: L1: the torch.distributed calls that move data between ranks; a
#: barrier moves none and stays legal
L1_BANNED = tuple(f"torch.distributed.{n}" for n in (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "broadcast_object_list", "reduce", "gather", "gather_object",
    "scatter", "scatter_object_list", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "P2POp"))

#: L4: wall-clock sources (time.sleep stays legal: it waits, not measures)
L4_BANNED = {
    "time.time", "time.time_ns", "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns", "time.process_time",
    "time.process_time_ns", "timeit.default_timer",
}
#: L4: calls that resolve into the sanctioned module are never findings
L4_SANCTIONED_PREFIX = "repro_torch.testing.timing"


def _is_test_module(relpath: str) -> bool:
    name = pathlib.PurePosixPath(relpath).name
    return relpath.startswith("tests/") and (name.startswith("test_torch_")
                                             or name.startswith("torch_"))


_NOQA = re.compile(r"#\s*repro:\s*noqa\(\s*([A-Z0-9,\s]+?)\s*\)")


def _noqa_map(source: str) -> dict[int, frozenset[str]]:
    out = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _NOQA.search(text)
        if m:
            out[i] = frozenset(r.strip() for r in m.group(1).split(",")
                               if r.strip())
    return out


def _package_of(relpath: str) -> str:
    """Dotted package of a repo-relative module path (for relative imports):
    ``src/repro_torch/core/ring.py`` -> ``repro_torch.core``."""
    parts = pathlib.PurePosixPath(relpath).parts
    if parts and parts[0] == "src":
        parts = parts[1:]
    return ".".join(parts[:-1])


def _collect_aliases(tree: ast.AST, relpath: str) -> dict[str, str]:
    """Local name -> fully dotted import path, module-wide."""
    pkg = _package_of(relpath)
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:                     # relative import
                base = pkg.split(".") if pkg else []
                base = base[: max(0, len(base) - (node.level - 1))]
                module = ".".join(base + ([module] if module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                full = f"{module}.{a.name}" if module else a.name
                aliases[a.asname or a.name] = full
    return aliases


def _resolve(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Dotted name of an attribute chain rooted at an imported name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = aliases.get(node.id)
    if base is None:
        return None
    parts.append(base)
    return ".".join(reversed(parts))


def _matches(resolved: str, banned: str) -> bool:
    return resolved == banned or resolved.startswith(banned + ".")


def _str_consts(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def _is_environ(node: ast.AST, aliases: dict[str, str]) -> bool:
    resolved = _resolve(node, aliases)
    return resolved in ("os.environ", "os.environb")


class _Linter:
    def __init__(self, tree: ast.AST, relpath: str, aliases: dict[str, str]):
        self.relpath = relpath
        self.aliases = aliases
        self.findings: list[Finding] = []
        self.in_tests = _is_test_module(relpath)
        self._walk(tree, depth=0)

    def _add(self, rule: str, node: ast.AST, message: str, hint: str):
        line = getattr(node, "lineno", 0)
        for f in self.findings:           # one finding per (rule, line)
            if f.rule == rule and f.line == line:
                return
        self.findings.append(Finding(rule, self.relpath, line, message, hint))

    # -- rules --------------------------------------------------------------

    def _check_l1_name(self, node: ast.AST):
        if self.relpath in L1_ALLOWED:
            return
        resolved = _resolve(node, self.aliases)
        if resolved is None:
            return
        for banned in L1_BANNED:
            if _matches(resolved, banned):
                self._add("L1", node,
                          f"direct torch.distributed collective `{resolved}`",
                          "route it through repro_torch.parallel.comm (the one "
                          "place that records and prices collectives)")
                return

    def _check_l1_import(self, node: ast.Import | ast.ImportFrom):
        if self.relpath in L1_ALLOWED or not isinstance(node, ast.ImportFrom) \
                or node.level:
            return
        mod = node.module or ""
        for a in node.names:
            full = f"{mod}.{a.name}" if mod else a.name
            if any(_matches(full, banned) for banned in L1_BANNED):
                self._add("L1", node, f"imports the collective `{full}`",
                          "route it through repro_torch.parallel.comm")
                return

    def _check_l2_env(self, node: ast.stmt, depth: int):
        """Import-time os.environ mutation in a test module of the port."""
        if not self.in_tests or depth > 0 or self.relpath in L2_ENV_ALLOWED:
            return
        mutating = False
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            mutating = any(isinstance(t, ast.Subscript)
                           and _is_environ(t.value, self.aliases) for t in targets)
        elif isinstance(node, ast.Delete):
            mutating = any(isinstance(t, ast.Subscript)
                           and _is_environ(t.value, self.aliases)
                           for t in node.targets)
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            func = node.value.func
            mutating = (isinstance(func, ast.Attribute)
                        and func.attr in ("setdefault", "update", "pop", "clear")
                        and _is_environ(func.value, self.aliases)) \
                or _resolve(func, self.aliases) in ("os.putenv", "os.unsetenv")
        if mutating:
            self._add("L2", node,
                      "test module mutates os.environ at import time (it leaks "
                      "into every test the worker runs after it)",
                      "set it in tests/conftest.py, in a fixture "
                      "(monkeypatch.setenv), or in a subprocess env copy")

    def _check_l3(self, node: ast.Call):
        if self.relpath in L3_ALLOWED:
            return
        func = node.func
        is_write = (isinstance(func, ast.Attribute)
                    and func.attr in ("write_text", "write_bytes"))
        resolved = _resolve(func, self.aliases)
        if resolved == "json.dump":
            is_write = True
        if isinstance(func, ast.Name) and func.id == "open" \
                and func.id not in self.aliases:
            mode = None
            if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if isinstance(mode, str) and any(c in mode for c in "wa+"):
                is_write = True
        if not is_write:
            return
        if any("BENCH_" in s for s in _str_consts(node)):
            self._add("L3", node,
                      "BENCH_*.json write: the port writes no benchmark record "
                      "yet",
                      "the port's benchmark brings its writer (and its place "
                      "in L3_ALLOWED)")

    def _check_l4(self, node: ast.Call):
        if self.relpath in L4_ALLOWED:
            return
        resolved = _resolve(node.func, self.aliases)
        if resolved is None or _matches(resolved, L4_SANCTIONED_PREFIX):
            return
        if resolved in L4_BANNED:
            self._add("L4", node,
                      f"wall-clock timing via `{resolved}` outside "
                      f"repro_torch.testing.timing",
                      "use repro_torch.testing.timing.now() for intervals, "
                      "timing.monotonic() for liveness deadlines, or "
                      "measure_us() for measurements")

    # -- walk ---------------------------------------------------------------

    def _walk(self, node: ast.AST, depth: int):
        for child in ast.iter_child_nodes(node):
            child_depth = depth
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                self._check_l1_import(child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                child_depth = depth + 1
            elif isinstance(child, ast.Call):
                self._check_l3(child)
                self._check_l4(child)
            elif isinstance(child, (ast.Attribute, ast.Name)) \
                    and isinstance(getattr(child, "ctx", None), ast.Load):
                self._check_l1_name(child)
            if isinstance(child, ast.stmt):
                self._check_l2_env(child, depth)
            self._walk(child, child_depth)


def lint_source(source: str, relpath: str) -> list[Finding]:
    """Lint one module given its repo-relative posix path (the path decides
    which allow-list applies)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("L1", relpath, e.lineno or 0,
                        f"syntax error: {e.msg}", "fix the parse error")]
    aliases = _collect_aliases(tree, relpath)
    findings = _Linter(tree, relpath, aliases).findings
    noqa = _noqa_map(source)
    kept = [f for f in findings if f.rule not in noqa.get(f.line, ())]
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule))


def lint_file(path: pathlib.Path, root: pathlib.Path) -> list[Finding]:
    relpath = path.resolve().relative_to(root.resolve()).as_posix()
    return lint_source(path.read_text(), relpath)


def port_sources(root: pathlib.Path) -> list[pathlib.Path]:
    """The port's python sources: the package, its tests and their
    helpers, and ``chip_smoke.py``."""
    files = [p for p in sorted((root / "src" / "repro_torch").rglob("*.py"))
             if "__pycache__" not in p.parts]
    files += sorted((root / "tests").glob("test_torch_*.py"))
    files += sorted((root / "tests").glob("torch_*.py"))
    if (root / "chip_smoke.py").exists():
        files.append(root / "chip_smoke.py")
    return files


def lint_repo(root: pathlib.Path) -> list[Finding]:
    """Lint every one of :func:`port_sources`."""
    findings: list[Finding] = []
    for path in port_sources(root):
        findings += lint_file(path, root)
    return findings
