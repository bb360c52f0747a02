"""gwlint core: the port's static-analysis plumbing.

The port's copy of the JAX package's ``analysis/core.py``.  The engine's
correctness story rests on invariants that generic linters cannot see
-- bit-exact enter/leave parity with the CPU oracle, no hidden host
syncs inside the per-tick device path, a hand-maintained wire protocol.
Each checker in this package encodes ONE such invariant as an AST pass;
this module provides the shared plumbing: source loading,
allow-comments, the suppression file, and the runner.

Suppression mechanisms (both explicit and commented -- a bare entry is
rejected):

* inline: ``# gwlint: allow[rule]`` (or ``allow[rule1,rule2]``) on the
  flagged line, followed by ``-- <reason>``.  Placed on a ``def`` line it
  allows the rule for the WHOLE function body -- the idiom for intentional
  drain points (a harvest function whose entire job is D2H).
* the port's file: ``suppressions.txt`` beside this module
  (:data:`DEFAULT_SUPPRESSIONS`) grandfathers existing sites.  Entries
  are ``path::rule`` (whole file) or ``path::rule::qualname`` (one
  function), paths relative to the repo root, each requiring a trailing
  ``-- reason``.

"Referenced from tests" means the port's tests, ``tests/test_torch_*.py``
(:data:`TEST_GLOB`): no other test touches the port.

Checkers are stdlib-only (ast + tokenize): gwlint must run where neither
torch nor msgpack is installed.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import sys
import tokenize

# the port's suppression file, and the test files its coverage rules read
DEFAULT_SUPPRESSIONS = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "suppressions.txt")
TEST_GLOB = re.compile(r"^test_torch_.*\.py$")

_ALLOW_RE = re.compile(r"#\s*gwlint:\s*allow\[([a-z0-9_,\- ]+)\]")

# every ast.parse rides SourceFile.__init__; --profile prints this to
# prove the 15-rule run parses each file exactly once
PARSE_COUNT = {"n": 0}


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str
    symbol: str = ""  # enclosing qualname -- the suppression-file key

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed python file plus the lookup tables checkers share."""

    def __init__(self, abspath: str, rel: str, text: str):
        self.abspath = abspath
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        PARSE_COUNT["n"] += 1
        self.tree = ast.parse(text, filename=rel)
        # every node, BFS order -- checkers iterate this instead of
        # re-walking the tree (ast.walk dominates a 15-rule run otherwise)
        self.nodes: list[ast.AST] = list(ast.walk(self.tree))
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in self.nodes:
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        # line -> set of allowed rules ("*" = all)
        self.allow: dict[int, set[str]] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    m = _ALLOW_RE.search(tok.string)
                    if m:
                        rules = {r.strip() for r in m.group(1).split(",")}
                        self.allow.setdefault(tok.start[0], set()).update(rules)
        except tokenize.TokenError:
            pass
        # function spans: (qualname, def_line, end_line)
        self.functions: list[tuple[str, int, int]] = []
        self._index_functions(self.tree, "")

    def _index_functions(self, node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                self.functions.append(
                    (qual, child.lineno, child.end_lineno or child.lineno))
                self._index_functions(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                self._index_functions(child, f"{prefix}{child.name}.")
            else:
                self._index_functions(child, prefix)

    def enclosing_function(self, line: int) -> tuple[str, int] | None:
        """Innermost (qualname, def_line) containing ``line``."""
        best: tuple[str, int] | None = None
        best_span = None
        for qual, lo, hi in self.functions:
            if lo <= line <= hi and (best_span is None or hi - lo < best_span):
                best, best_span = (qual, lo), hi - lo
        return best

    def allowed(self, rule: str, line: int) -> bool:
        for probe in (line,):
            rules = self.allow.get(probe)
            if rules and (rule in rules or "*" in rules):
                return True
        enc = self.enclosing_function(line)
        if enc is not None:
            rules = self.allow.get(enc[1])
            if rules and (rule in rules or "*" in rules):
                return True
        return False


class Suppressions:
    """The grandfather file (see module docstring for format)."""

    def __init__(self):
        self.file_rules: set[tuple[str, str]] = set()
        self.func_rules: set[tuple[str, str, str]] = set()
        self.errors: list[str] = []

    @classmethod
    def load(cls, path: str | None) -> "Suppressions":
        sup = cls()
        if path is None or not os.path.exists(path):
            return sup
        with open(path, encoding="utf-8") as fh:
            for ln, raw in enumerate(fh, 1):
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                entry, sep, reason = line.partition("--")
                if not sep or not reason.strip():
                    sup.errors.append(
                        f"{path}:{ln}: suppression without a '-- reason'")
                    continue
                parts = [p.strip() for p in entry.strip().split("::")]
                if len(parts) == 2:
                    sup.file_rules.add((parts[0], parts[1]))
                elif len(parts) == 3:
                    sup.func_rules.add((parts[0], parts[1], parts[2]))
                else:
                    sup.errors.append(
                        f"{path}:{ln}: expected 'path::rule[::qualname] -- reason'")
        return sup

    def covers(self, f: Finding) -> bool:
        if (f.path, f.rule) in self.file_rules:
            return True
        return bool(f.symbol) and (f.path, f.rule, f.symbol) in self.func_rules


class Context:
    """Everything a checker sees: parsed sources + repo layout."""

    def __init__(self, files: list[SourceFile], root: str, tests_dir: str | None):
        self.files = files
        self.root = root
        self.tests_dir = tests_dir
        self._tests_text: str | None = None
        self._tests_idents: set[str] | None = None
        self._index = None

    @property
    def index(self):
        """The shared ProjectIndex, built lazily ONCE per run."""
        if self._index is None:
            from .index import ProjectIndex
            self._index = ProjectIndex(self.files)
        return self._index

    def files_matching(self, *suffixes: str) -> list[SourceFile]:
        """Files whose rel path ends with (or contains a dir named by) any
        suffix.  A suffix ending in '/' matches a directory prefix segment."""
        out = []
        for sf in self.files:
            for suf in suffixes:
                if suf.endswith("/"):
                    if ("/" + suf) in ("/" + sf.rel):
                        out.append(sf)
                        break
                elif sf.rel.endswith(suf):
                    out.append(sf)
                    break
        return out

    def tests_text(self) -> str:
        """Concatenated source of every port test file
        (``tests/test_torch_*.py``; gate-coverage lookups)."""
        if self._tests_text is None:
            chunks = []
            if self.tests_dir and os.path.isdir(self.tests_dir):
                for dirpath, _dirs, names in os.walk(self.tests_dir):
                    for name in sorted(names):
                        if TEST_GLOB.match(name):
                            p = os.path.join(dirpath, name)
                            try:
                                with open(p, encoding="utf-8") as fh:
                                    chunks.append(fh.read())
                            except OSError:
                                pass
            self._tests_text = "\n".join(chunks)
        return self._tests_text

    def tests_reference(self, symbol: str) -> bool:
        if symbol.isidentifier():
            # one tokenization pays for every identifier lookup
            if self._tests_idents is None:
                self._tests_idents = set(
                    re.findall(r"[A-Za-z_][A-Za-z0-9_]*", self.tests_text()))
            return symbol in self._tests_idents
        return re.search(
            r"(?<![A-Za-z0-9_])" + re.escape(symbol) + r"(?![A-Za-z0-9_])",
            self.tests_text()) is not None


def collect_files(paths: list[str], root: str) -> list[SourceFile]:
    seen = set()
    out: list[SourceFile] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            for dirpath, dirs, names in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git") and not d.startswith("."))
                for name in sorted(names):
                    if name.endswith(".py"):
                        _add_file(os.path.join(dirpath, name), root, seen, out)
        elif p.endswith(".py"):
            _add_file(p, root, seen, out)
    return out


def _add_file(abspath: str, root: str, seen: set, out: list[SourceFile]):
    if abspath in seen:
        return
    seen.add(abspath)
    rel = os.path.relpath(abspath, root)
    with open(abspath, encoding="utf-8") as fh:
        text = fh.read()
    try:
        out.append(SourceFile(abspath, rel, text))
    except SyntaxError as e:
        raise SystemExit(f"gwlint: cannot parse {rel}: {e}")


def find_repo_root(start: str) -> str:
    """Nearest ancestor holding gwlint.suppressions, tests/, or .git."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        for marker in ("gwlint.suppressions", ".git", "tests"):
            if os.path.exists(os.path.join(cur, marker)):
                return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return os.path.abspath(start)
        cur = nxt


def _rule_name(checker) -> str:
    mod = sys.modules.get(getattr(checker, "__module__", ""), None)
    return getattr(mod, "RULE", getattr(checker, "__name__", "?"))


def run(paths: list[str], *, root: str | None = None,
        tests_dir: str | None = None, suppressions: str | None = None,
        checkers=None, profile: dict | None = None,
        only_files: set[str] | None = None) -> tuple[list[Finding], list[str]]:
    """Run every checker; returns (findings, config_errors).

    ``profile`` (a dict the caller owns) is filled with per-rule wall
    times plus the parse ledger: ``{"rules": [(rule, secs)], "files": n,
    "parses": n}`` -- parses == files is the parse-once contract.
    ``only_files`` (rel paths) filters FINDINGS, not the scan: whole-
    program rules still see the full tree (--changed-only).
    """
    import time

    if root is None:
        root = find_repo_root(paths[0])
    if tests_dir is None:
        cand = os.path.join(root, "tests")
        tests_dir = cand if os.path.isdir(cand) else None
    if suppressions is None:
        suppressions = DEFAULT_SUPPRESSIONS
    sup = Suppressions.load(suppressions)
    parses0 = PARSE_COUNT["n"]
    files = collect_files(paths, root)
    ctx = Context(files, root, tests_dir)
    findings: list[Finding] = []
    from . import CHECKERS
    for checker in (checkers if checkers is not None else CHECKERS):
        t0 = time.perf_counter()
        batch = list(checker(ctx))
        if profile is not None:
            profile.setdefault("rules", []).append(
                (_rule_name(checker), time.perf_counter() - t0))
        for f in batch:
            sf = next((s for s in files if s.rel == f.path), None)
            if sf is not None:
                if not f.symbol:
                    enc = sf.enclosing_function(f.line)
                    f.symbol = enc[0] if enc else ""
                if sf.allowed(f.rule, f.line):
                    continue
            if sup.covers(f):
                continue
            if only_files is not None and f.path not in only_files:
                continue
            findings.append(f)
    if profile is not None:
        profile["files"] = len(files)
        profile["parses"] = PARSE_COUNT["n"] - parses0
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, sup.errors


# -- shared AST helpers ------------------------------------------------------

def call_name(node: ast.Call) -> str:
    """Dotted name of a call target: 'torch.zeros', 'float', 'x.item'."""
    return dotted(node.func)


def dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def const_int(node: ast.AST) -> int | None:
    """Evaluate int-constant expressions (handles (1 << 20)-style shifts)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_int(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        lo, hi = const_int(node.left), const_int(node.right)
        if lo is None or hi is None:
            return None
        try:
            if isinstance(node.op, ast.LShift):
                return lo << hi
            if isinstance(node.op, ast.Mult):
                return lo * hi
            if isinstance(node.op, ast.Add):
                return lo + hi
            if isinstance(node.op, ast.Sub):
                return lo - hi
            if isinstance(node.op, ast.Pow):
                return lo ** hi
        except (OverflowError, ValueError):
            return None
    return None
