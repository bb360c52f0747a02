"""gwlint whole-program index: the tables every checker shares.

The port's copy of the JAX package's ``analysis/index.py``; its sync
taxonomy (:func:`sync_msg`) is torch's.

gwlint parses each file exactly once (``SourceFile`` in core.py;
``--profile`` prints the proof).  ProjectIndex is the second layer,
built once per run on top of those parses (``Context.index``): a
project-wide symbol table -- modules, imports, classes + MRO, module
functions, ``self.X`` attribute write/read sites, CUDA-graph and
kernel-library construction sites, thread-spawn sites -- plus ONE unified
call-graph resolution that ``flush-phase``, ``fused-dispatch`` and
``thread-discipline`` all walk instead of each re-deriving private
method tables from the ASTs.

Name resolution is import-aware: a bare callee resolves same-file
first, then through the file's ``import``/``from .. import`` table,
then (fixture convenience) to a project-unique definition; an
ambiguous name resolves to nothing -- the walk stops rather than
guessing across modules.  Class bases resolve the same way, so
``class MeshBucket(_Bucket)`` finds ``_Bucket`` in engine/aoi.py
through the real import, not by global name luck.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, call_name, dotted
from .host_sync import _SYNC_ATTRS, _SYNC_CALLS


class ClassInfo:
    """One class definition: bases (AST exprs), methods, self.X sites."""

    __slots__ = ("name", "node", "sf", "bases", "methods",
                 "attr_writes", "attr_reads")

    def __init__(self, node: ast.ClassDef, sf: SourceFile):
        self.name = node.name
        self.node = node
        self.sf = sf
        self.bases = list(node.bases)
        self.methods: dict[str, tuple[ast.AST, SourceFile]] = {
            m.name: (m, sf) for m in node.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # attr -> [(innermost enclosing def node, access node)]
        self.attr_writes: dict[str, list] = {}
        self.attr_reads: dict[str, list] = {}


class JitSite:
    """One construction call of a compiled artifact: a CUDA graph
    (``torch.cuda.CUDAGraph``), a kernel library (``ctypes.CDLL``), or a
    ``torch.compile``."""

    __slots__ = ("sf", "node", "kind")

    def __init__(self, sf: SourceFile, node: ast.Call, kind: str):
        self.sf = sf
        self.node = node
        self.kind = kind


class ThreadSpawn:
    """One ``threading.Thread(target=...)`` (or Timer) construction."""

    __slots__ = ("sf", "node", "target")

    def __init__(self, sf: SourceFile, node: ast.Call, target: ast.AST):
        self.sf = sf
        self.node = node
        self.target = target


_JIT_KINDS = {"CUDAGraph", "CDLL", "LoadLibrary", "compile"}
_THREAD_KINDS = {"Thread", "Timer"}


class ProjectIndex:
    def __init__(self, files: list[SourceFile]):
        self.files = files
        self.by_rel: dict[str, SourceFile] = {sf.rel: sf for sf in files}
        # rel -> dotted module; both a/b/c.py -> a.b.c and a/b/__init__.py
        # -> a.b are registered in rel_of_module
        self.module_of: dict[str, str] = {}
        self.rel_of_module: dict[str, str] = {}
        # rel -> {local name: (module dotted, symbol | None)}
        self.imports: dict[str, dict[str, tuple[str, str | None]]] = {}
        # rel -> {name: (node, sf)}; module level only (the _Graph table)
        self.mod_funcs: dict[str, dict[str, tuple]] = {}
        # rel -> {name: ClassInfo}; plus the global name -> [ClassInfo]
        self.classes_by_rel: dict[str, dict[str, ClassInfo]] = {}
        self.classes_by_name: dict[str, list[ClassInfo]] = {}
        self.jit_sites: list[JitSite] = []
        self.thread_spawns: list[ThreadSpawn] = []
        for sf in files:
            mod = sf.rel[:-3].replace("/", ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            self.module_of[sf.rel] = mod
            self.rel_of_module[mod] = sf.rel
        for sf in files:
            self._index_file(sf)

    # -- construction --------------------------------------------------------

    def _index_file(self, sf: SourceFile):
        imps = self.imports.setdefault(sf.rel, {})
        funcs = self.mod_funcs.setdefault(sf.rel, {})
        classes = self.classes_by_rel.setdefault(sf.rel, {})
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                ci = ClassInfo(node, sf)
                classes[node.name] = ci
                self.classes_by_name.setdefault(node.name, []).append(ci)
                self._index_attrs(ci)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs[node.name] = (node, sf)
        for node in sf.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imps[alias.asname or alias.name.split(".")[0]] = (
                        alias.name, None)
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(sf, node)
                if base is not None:
                    for alias in node.names:
                        imps[alias.asname or alias.name] = (base, alias.name)
            elif isinstance(node, ast.Call):
                name = call_name(node)
                last = name.rsplit(".", 1)[-1]
                if last in _JIT_KINDS and (last != "compile"
                                           or name == "torch.compile"):
                    self.jit_sites.append(JitSite(sf, node, last))
                elif last in _THREAD_KINDS:
                    target = next((kw.value for kw in node.keywords
                                   if kw.arg == "target"), None)
                    if target is not None:
                        self.thread_spawns.append(
                            ThreadSpawn(sf, node, target))

    def _import_base(self, sf: SourceFile, node: ast.ImportFrom) -> str | None:
        """Absolute dotted module an ImportFrom pulls names from."""
        if not node.level:
            return node.module
        parts = self.module_of[sf.rel].split(".")
        if not sf.rel.endswith("/__init__.py"):
            parts = parts[:-1]  # level 1 = the file's own package
        drop = node.level - 1  # each extra level one package higher
        if drop > len(parts):
            return None
        if drop:
            parts = parts[:-drop]
        if node.module:
            parts += node.module.split(".")
        return ".".join(parts) if parts else None

    def _index_attrs(self, ci: ClassInfo):
        """self.X write/read sites per innermost enclosing def."""
        sf = ci.sf
        for meth, _sf in ci.methods.values():
            for node in ast.walk(meth):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"):
                    continue
                fn = node
                while fn is not None and not isinstance(
                        fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = sf.parents.get(fn)
                parent = sf.parents.get(node)
                is_write = (
                    isinstance(node.ctx, (ast.Store, ast.Del))
                    or (isinstance(parent, ast.AugAssign)
                        and parent.target is node)
                    # element mutation: self.X[i] = ... / self.X[i] += ...
                    or (isinstance(parent, ast.Subscript)
                        and parent.value is node
                        and (isinstance(parent.ctx, (ast.Store, ast.Del))
                             or (isinstance(sf.parents.get(parent),
                                            ast.AugAssign)
                                 and sf.parents[parent].target is parent))))
                table = ci.attr_writes if is_write else ci.attr_reads
                table.setdefault(node.attr, []).append((fn, node))

    # -- resolution ----------------------------------------------------------

    def resolve_import(self, rel: str, name: str) -> str | None:
        """rel path of the project module a local name is imported as."""
        imp = self.imports.get(rel, {}).get(name)
        if imp is None:
            return None
        mod, sym = imp
        for cand in ([f"{mod}.{sym}", mod] if sym else [mod]):
            if cand in self.rel_of_module:
                return self.rel_of_module[cand]
        return None

    def resolve_class(self, rel: str, name: str) -> ClassInfo | None:
        ci = self.classes_by_rel.get(rel, {}).get(name)
        if ci is not None:
            return ci
        imp = self.imports.get(rel, {}).get(name)
        if imp is not None:
            mod, sym = imp
            trel = self.rel_of_module.get(mod)
            if trel and sym:
                ci = self.classes_by_rel.get(trel, {}).get(sym)
                if ci is not None:
                    return ci
        hits = self.classes_by_name.get(name, [])
        return hits[0] if len(hits) == 1 else None

    def resolve_method(self, rel: str, cls: str, name: str):
        """(node, sf) for cls.name, MRO breadth-first; bases resolve
        through the defining file's imports (mesh/rowshard inherit from
        engine/aoi.py), then by project-unique name."""
        seen = set()
        queue = [(cls, rel)]
        while queue:
            cname, crel = queue.pop(0)
            if (cname, crel) in seen:
                continue
            seen.add((cname, crel))
            ci = self.resolve_class(crel, cname)
            if ci is None:
                continue
            if name in ci.methods:
                return ci.methods[name]
            for base in ci.bases:
                if isinstance(base, ast.Name):
                    queue.append((base.id, ci.sf.rel))
                elif isinstance(base, ast.Attribute) \
                        and isinstance(base.value, ast.Name):
                    trel = self.resolve_import(ci.sf.rel, base.value.id)
                    if trel:
                        queue.append((base.attr, trel))
        return None

    def resolve_function(self, rel: str, name: str):
        """(node, sf) for a bare-name call from ``rel``."""
        hit = self.mod_funcs.get(rel, {}).get(name)
        if hit is not None:
            return hit
        imp = self.imports.get(rel, {}).get(name)
        if imp is not None:
            mod, sym = imp
            trel = self.rel_of_module.get(mod)
            if trel and sym:
                hit = self.mod_funcs.get(trel, {}).get(sym)
                if hit is not None:
                    return hit
        hits = [funcs[name] for funcs in self.mod_funcs.values()
                if name in funcs]
        return hits[0] if len(hits) == 1 else None

    def resolve_module_func(self, rel: str, alias: str, name: str):
        """(node, sf) for an ``alias.name(...)`` call where alias is an
        imported project module (``from .. import telemetry as _T``)."""
        trel = self.resolve_import(rel, alias)
        if trel is None:
            return None
        return self.mod_funcs.get(trel, {}).get(name)


# -- the shared no-host-sync call-graph walk ---------------------------------

def _numpy_rooted(node: ast.AST) -> bool:
    """An expression whose root is a numpy call (``np.unique(a).tolist()``,
    ``int(np.uint32(m).view(np.int32))``), or a comparison or boolean
    expression (``int(prev is not None)``): a host value, never a
    tensor."""
    if isinstance(node, (ast.Compare, ast.BoolOp)):
        return True
    while True:
        if isinstance(node, ast.Call):
            if call_name(node).startswith(("np.", "numpy.")):
                return True
            node = node.func
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        else:
            return False


def sync_msg(node: ast.Call) -> str | None:
    """The host-sync detection (one taxonomy: host-sync, flush-phase,
    fused-dispatch all agree on what a blocking fetch is): torch's
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``, any
    ``.synchronize()`` (the device, an event, a stream),
    ``torch.nonzero`` / ``.nonzero()`` without ``size=``, ``bool()`` /
    ``int()`` / ``float()`` of a non-constant and ``np.asarray``.  An
    expression rooted at a numpy call is a host value and never counts
    (:func:`_numpy_rooted`)."""
    name = call_name(node)
    if name in _SYNC_CALLS:
        return _SYNC_CALLS[name]
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _SYNC_ATTRS and attr != "synchronize" \
                and _numpy_rooted(node.func.value):
            return None
        if attr in _SYNC_ATTRS:
            verb = ("waits for the device" if attr == "synchronize"
                    else "is a D2H fetch")
            return f".{attr}() {verb}"
        if attr == "nonzero" and not name.startswith(("np.", "numpy.")) \
                and not any(kw.arg == "size" for kw in node.keywords):
            return (f"{name or '.nonzero'}() without size= sizes its output "
                    "from device data: the host waits for it")
    if name in ("float", "int", "bool") and len(node.args) == 1 \
            and not node.keywords \
            and not isinstance(node.args[0], ast.Constant) \
            and not _numpy_rooted(node.args[0]):
        return f"{name}() on a possibly-device value is a scalar D2H fetch"
    return None


def fused_entries(index: ProjectIndex, sf: SourceFile):
    """The entry points of the fused tick's module: ``("", name, node,
    sf)`` for every module function and ``(class, name, node, sf)`` for
    every method of its classes."""
    for name, (fn, fsf) in index.mod_funcs.get(sf.rel, {}).items():
        yield "", name, fn, fsf
    for cname, ci in index.classes_by_rel.get(sf.rel, {}).items():
        for name, (fn, fsf) in ci.methods.items():
            yield cname, name, fn, fsf


def _has_allow(sf: SourceFile, line: int, rule: str) -> bool:
    rules = sf.allow.get(line)
    return bool(rules) and (rule in rules or "*" in rules)


def walk_no_sync(index: ProjectIndex, rule: str, reason: str, hint: str,
                 cls: str, entry_name: str, entry_node, entry_sf: SourceFile):
    """BFS the call graph from one entry; yield a Finding per reachable
    host-sync call.  ``# gwlint: allow[<rule>]`` on a call line or a
    callee def line is an explicit boundary that stops the traversal."""
    visited: set[tuple[str, int]] = set()
    display = f"{cls}.{entry_name}" if cls else entry_name
    queue = [(entry_node, entry_sf, display)]
    while queue:
        fn, sf, path = queue.pop(0)
        key = (sf.rel, fn.lineno)
        if key in visited:
            continue
        visited.add(key)
        if _has_allow(sf, fn.lineno, rule):
            continue  # whole callee is a declared boundary
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            msg = sync_msg(node)
            if msg is not None:
                yield Finding(
                    rule, sf.rel, node.lineno, node.col_offset,
                    f"{msg}, reachable from {path} -- {reason}; {hint} "
                    f"or mark the boundary '# gwlint: allow[{rule}] "
                    "-- <why>'")
                continue
            if _has_allow(sf, node.lineno, rule):
                continue  # declared boundary at the call site
            callee = None
            label = ""
            if isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name):
                base = node.func.value.id
                if base == "self":
                    callee = index.resolve_method(
                        entry_sf.rel, cls, node.func.attr)
                    label = f"self.{node.func.attr}"
                else:
                    callee = index.resolve_module_func(
                        sf.rel, base, node.func.attr)
                    label = f"{base}.{node.func.attr}"
            elif isinstance(node.func, ast.Name):
                callee = index.resolve_function(sf.rel, node.func.id)
                label = node.func.id
            if callee is not None:
                queue.append((callee[0], callee[1], f"{path} -> {label}"))


def reachable_methods(index: ProjectIndex, rel: str, cls: str,
                      entry_node, entry_sf: SourceFile) -> set:
    """Function nodes reachable from an entry through self.X / bare /
    module-alias calls (thread-discipline's background closure).

    Indirect dispatch is closed over conservatively: ANY ``self.X``
    reference that names a method counts as reachable (the handler-table
    ``h(self, pkt)`` pattern, ``run_panicless(self._dispatch, ...)``,
    callbacks handed to constructors), and reading a class-body dict
    (``_HANDLERS = {MT...: _h_x}``) pulls in its method values.  Over-
    approximating the background set only ever HIDES races, never
    invents them -- the right bias for a convention checker."""
    ci = index.resolve_class(rel, cls)
    body_dicts: dict[str, ast.AST] = {}
    if ci is not None:
        for stmt in ci.node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Dict):
                body_dicts[stmt.targets[0].id] = stmt.value
    out = set()
    queue = [(entry_node, entry_sf)]
    while queue:
        fn, sf = queue.pop(0)
        if fn in out:
            continue
        out.add(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                hit = index.resolve_method(rel, cls, node.attr)
                if hit is not None:
                    queue.append(hit)
                elif node.attr in body_dicts:
                    for v in body_dicts[node.attr].values:
                        if isinstance(v, ast.Name):
                            hit = index.resolve_method(rel, cls, v.id)
                            if hit is not None:
                                queue.append(hit)
                continue
            if not isinstance(node, ast.Call):
                continue
            callee = None
            if isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name):
                if node.func.value.id != "self":
                    callee = index.resolve_module_func(
                        sf.rel, node.func.value.id, node.func.attr)
            elif isinstance(node.func, ast.Name):
                callee = index.resolve_function(sf.rel, node.func.id)
            if callee is not None:
                queue.append((callee[0], callee[1]))
    return out
