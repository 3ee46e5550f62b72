"""AST engine: syntactic contract rules for torch (CA1xx), stdlib ``ast`` only.

Port of ``repro.analysis.astpass``.  The engine imports nothing of torch:
it parses source, so it runs on any file without touching a device.  Per
module it resolves import origins first (``dist`` -> ``torch.distributed``,
``np`` -> ``numpy``), so rules key on where a name came from, not on
spelling, then runs the rule visitor:

  * CA103 — mutable default arguments, on every function (the port
    traces nothing, so the reference's "traced function" scope is moot);
  * CA104 — narrow float literals in the f64-contract modules:
    ``torch.float32/float16/bfloat16/half``, ``np.float32/float16``,
    a narrow ``dtype=`` string, and ``.float()``/``.half()``/
    ``.bfloat16()``;
  * CA105 — ``torch.distributed`` collectives, barriers and group set-up
    outside the collective layer, whatever the import alias;
  * CA106 — device-to-host pulls inside a loop body or comprehension
    element: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``float()``/``int()``/``bool()`` over a ``torch.``/``np.``
    expression, ``torch.cuda.synchronize()``.  A ``for`` loop's iterable
    (and a comprehension's first) is evaluated once and is not inside
    the loop.

Inline suppression, as in the reference: a line containing ``# ca:
allow=CA1xx`` (comma list, or ``allow=*``) suppresses findings on that
line; state the reason beside it.  A module-level assignment to a name
ending in ``_DTYPE`` is the named narrow-dtype policy and is exempt from
CA104.
"""
from __future__ import annotations

import ast
import re

from .findings import Finding
from .rules import Profile

# -- name sets --------------------------------------------------------------

#: method pulls that copy device data to the host (CA106)
HOST_PULL_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: builtins that pull a scalar to the host when given a device value
HOST_SCALAR_BUILTINS = frozenset({"float", "int", "bool"})

#: torch.distributed entry points that must stay inside the collective
#: layer (CA105); names ending in ``*`` match as prefixes
DIST_COLLECTIVES = (
    "all_reduce", "all_gather*", "reduce_scatter*", "broadcast",
    "all_to_all*", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "barrier", "new_group", "init_process_group",
)

NARROW_FLOAT_DTYPES = frozenset({"float32", "float16", "bfloat16", "half"})
_NARROW_DTYPE_STRINGS = frozenset({"float32", "float16", "bfloat16", "half",
                                   "f32", "f16", "bf16"})
#: tensor methods that cast to a narrow float
NARROW_CAST_METHODS = frozenset({"float", "half", "bfloat16"})

_ALLOW_RE = re.compile(r"#\s*ca:\s*allow=([A-Z0-9*,\s]+)")


def _line_allows(source_lines: list[str], lineno: int, rule_id: str) -> bool:
    if not (1 <= lineno <= len(source_lines)):
        return False
    m = _ALLOW_RE.search(source_lines[lineno - 1])
    if not m:
        return False
    allowed = {t.strip() for t in m.group(1).split(",")}
    return "*" in allowed or rule_id in allowed


# -- import-origin resolution -----------------------------------------------

def _collect_imports(tree: ast.Module) -> dict[str, str]:
    """alias -> dotted origin ('dist' -> 'torch.distributed'); relative
    imports keep their module path with the leading dots stripped."""
    origins: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                origins[(a.asname or a.name.split(".")[0])] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = (node.module or "").lstrip(".") or ""
            for a in node.names:
                if a.name == "*":
                    continue
                origin = f"{mod}.{a.name}" if mod else a.name
                origins[a.asname or a.name] = origin
    return origins


def _origin_of(node: ast.AST, imports: dict[str, str]) -> str | None:
    """Dotted origin of a Name/Attribute chain, or None if the base name
    was not imported (a local def, builtin, or parameter)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        base = imports.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))
    return None


def _is_arrayish(origin: str | None) -> bool:
    """An origin whose calls make device or array values: torch, numpy
    (and the reference's jax spellings, so a shared snippet reads the
    same in both packages)."""
    return origin is not None and (
        origin in ("torch", "jax") or origin.startswith(
            ("torch.", "jax.", "numpy")))


def _contains_array_call(node: ast.AST, imports) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            if _is_arrayish(_origin_of(n.func, imports)):
                return True
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("any", "all")):
                return True
    return False


_STATIC_ATTRS = ("shape", "ndim", "dtype", "size", "device")


def _is_static_metadata(node: ast.AST) -> bool:
    """A (possibly subscripted) ``.shape``/``.ndim``/``.size``/``.dtype``
    read: host metadata, not device data — never a sync."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set"))


def _is_dist_collective(origin: str) -> bool:
    if not origin.startswith("torch.distributed."):
        return False
    leaf = origin.rsplit(".", 1)[-1]
    return any(leaf.startswith(n[:-1]) if n.endswith("*") else leaf == n
               for n in DIST_COLLECTIVES)


class _RuleVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, source_lines: list[str],
                 imports: dict[str, str], profile: Profile):
        self.relpath = relpath
        self.lines = source_lines
        self.imports = imports
        self.profile = profile
        self.findings: list[Finding] = []
        self._scope: list[str] = []     # class and function qualnames
        self._fns: list[str] = []       # enclosing function qualnames
        self._loop_depth = 0
        self._dtype_exempt: set[int] = set()     # node ids inside *_DTYPE =
        self._in_f64_module = any(
            relpath.endswith(m) for m in profile.f64_modules)
        self._in_collective_layer = any(
            s in relpath or relpath.endswith(s.rstrip("/"))
            for s in profile.collective_layer)

    # -- emission ----------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str):
        if rule not in self.profile.rules:
            return
        line = getattr(node, "lineno", 0)
        if _line_allows(self.lines, line, rule):
            return
        snippet = (self.lines[line - 1].strip()
                   if 1 <= line <= len(self.lines) else "")
        ctx = self._fns[-1] if self._fns else "<module>"
        self.findings.append(Finding(
            rule=rule, path=self.relpath, line=line, message=message,
            context=ctx, snippet=snippet))

    # -- module prep -------------------------------------------------

    def scan_module(self, tree: ast.Module):
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.endswith("_DTYPE")):
                for sub in ast.walk(node):
                    self._dtype_exempt.add(id(sub))
        self.visit(tree)

    # -- scope bookkeeping -------------------------------------------

    def _qual(self, name: str) -> str:
        """The reference's qualname: inside a function, the function's;
        else the enclosing class's."""
        scope = self._fns[-1:] or self._scope[-1:]
        return f"{scope[0]}.{name}" if scope else name

    def visit_ClassDef(self, node: ast.ClassDef):
        self._scope.append(self._qual(node.name))
        self.generic_visit(node)
        self._scope.pop()

    def _visit_fn(self, node):
        qual = self._qual(node.name)
        self._scope.append(qual)
        self._fns.append(qual)
        self._check_defaults(node, qual)
        outer_loops = self._loop_depth
        self._loop_depth = 0
        self.generic_visit(node)
        self._loop_depth = outer_loops
        self._fns.pop()
        self._scope.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- CA103: mutable defaults ---------------------------------------

    def _check_defaults(self, node, qual: str):
        a = node.args
        positional = a.posonlyargs + a.args
        pairs = list(zip(positional[len(positional) - len(a.defaults):],
                         a.defaults))
        pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if _is_mutable_default(default):
                self._emit(
                    "CA103", default,
                    f"function '{qual}' has a mutable default for "
                    f"'{arg.arg}': the default is created once and aliased "
                    f"across every call (default to None and build it "
                    f"inside)")

    # -- loops (for CA106) --------------------------------------------

    def _in_loop(self, nodes):
        self._loop_depth += 1
        for n in nodes:
            self.visit(n)
        self._loop_depth -= 1

    def visit_For(self, node):
        # the iterable is evaluated once, before the loop
        self.visit(node.target)
        self.visit(node.iter)
        self._in_loop(node.body + node.orelse)

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        self._in_loop([node.test] + node.body + node.orelse)

    def _visit_comp(self, node):
        gens = node.generators
        # the first generator's iterable is evaluated once, outside
        self.visit(gens[0].iter)
        self._in_loop([gens[0].target, *gens[0].ifs, *gens[1:]]
                      + [getattr(node, f) for f in ("elt", "key", "value")
                         if hasattr(node, f)])

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # -- calls: CA104 / CA105 / CA106 ---------------------------------

    def visit_Call(self, node: ast.Call):
        origin = _origin_of(node.func, self.imports)
        self._check_collective(node, origin)
        self._check_host_sync_loop(node, origin)
        self._check_narrow_cast(node)
        self.generic_visit(node)

    def _check_collective(self, node: ast.Call, origin: str | None):
        if origin is None or self._in_collective_layer:
            return
        if _is_dist_collective(origin):
            self._emit(
                "CA105", node,
                f"raw `{origin}` outside the collective layer (comm/, "
                f"core/distributed.py): route it through comm.group so "
                f"the collective watcher sees it")

    def _check_host_sync_loop(self, node: ast.Call, origin: str | None):
        if self._loop_depth == 0:
            return
        func = node.func
        if origin == "torch.cuda.synchronize":
            self._emit(
                "CA106", node,
                "torch.cuda.synchronize() inside a loop/comprehension: "
                "each iteration drains the launch queue")
            return
        if isinstance(func, ast.Attribute) and func.attr in HOST_PULL_METHODS:
            if node.args or _is_static_metadata(func.value):
                return          # .cpu(x)/.numpy(x) are not tensor pulls
            self._emit(
                "CA106", node,
                f"device->host pull `.{func.attr}()` inside a loop/"
                f"comprehension: each iteration blocks on a transfer — "
                f"stack the device values and pull once outside the loop")
            return
        if (isinstance(func, ast.Name) and func.id in HOST_SCALAR_BUILTINS
                and node.args):
            probe = node.args[0]
            if _is_static_metadata(probe):
                return
            if _contains_array_call(probe, self.imports):
                self._emit(
                    "CA106", node,
                    f"device->host scalar pull `{func.id}()` inside a "
                    f"loop/comprehension: each iteration blocks on a "
                    f"transfer — stack the device values and pull once "
                    f"outside the loop")

    # -- CA104: dtype literals in f64-contract modules ----------------

    def _narrow_ok(self, node) -> bool:
        return not self._in_f64_module or id(node) in self._dtype_exempt

    def _check_narrow_cast(self, node: ast.Call):
        func = node.func
        if (self._narrow_ok(node) or not isinstance(func, ast.Attribute)
                or func.attr not in NARROW_CAST_METHODS or node.args
                or node.keywords):
            return
        if _origin_of(func, self.imports) is not None:
            return      # a module function (np.half, ...), not a method
        self._emit(
            "CA104", node,
            f"narrowing cast `.{func.attr}()` in an f64-contract module: "
            f"name the narrow policy once in a module-level *_DTYPE "
            f"constant and cast with .to(...)")

    def visit_Attribute(self, node: ast.Attribute):
        if not self._narrow_ok(node):
            origin = _origin_of(node, self.imports)
            if origin:
                parts = origin.split(".")
                if (parts[-1] in NARROW_FLOAT_DTYPES
                        and parts[0] in ("torch", "numpy", "jax")):
                    self._emit(
                        "CA104", node,
                        f"narrow float dtype literal `{origin}` in an "
                        f"f64-contract module: derive the dtype from the "
                        f"operand, or name the policy once in a "
                        f"module-level *_DTYPE constant")
        self.generic_visit(node)

    def visit_keyword(self, node: ast.keyword):
        if (node.arg == "dtype" and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and node.value.value in _NARROW_DTYPE_STRINGS
                and not self._narrow_ok(node.value)):
            self._emit(
                "CA104", node.value,
                f"narrow float dtype string {node.value.value!r} in an "
                f"f64-contract module")
        self.generic_visit(node)


# -- entry point ------------------------------------------------------------

def scan_source(relpath: str, source: str, profile: Profile) -> list[Finding]:
    """Run the AST rules over one file's source text."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Finding(rule="CA100", path=relpath, line=e.lineno or 0,
                        message=f"syntax error: {e.msg}", context="<module>")]
    visitor = _RuleVisitor(relpath, source.splitlines(),
                           _collect_imports(tree), profile)
    visitor.scan_module(tree)
    return visitor.findings


def scan_file(path, relpath: str, profile: Profile) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return scan_source(relpath, f.read(), profile)
