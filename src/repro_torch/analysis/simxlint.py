"""simxlint: AST lint rules for the round step of the port's simx runtime
(port of ``repro/analysis/simxlint.py``).

The port runs a round as a few hundred eager torch launches, driven by a
host loop (``PERF.md``: every round is host-bound).  The lever is to
capture a chunk of rounds, or a stream segment, as one CUDA graph, and any
device->host read inside a step blocks that: it waits for the device, and
a graph cannot hold it.  This pass finds those reads statically, with
stable codes and ``file:line`` output, over ``src/repro_torch/simx``.

Rule catalog:

  TH001  host read inside step scope: ``.item()`` / ``.tolist()`` /
         ``.cpu()`` / ``.numpy()``; ``bool()`` / ``int()`` / ``float()``
         of a device expression; a Python ``if`` / ``while`` on one.  Each
         is a device->host sync that breaks a CUDA graph of the round.
  SC101  dispatch stage writes a runtime-owned state field
         (``runtime.RUNTIME_OWNED_FIELDS``: ``t`` / ``rnd`` / ``lost``
         belong to the runtime per ``runtime.STAGE_TABLE``)
  SC102  ``register_rule(Rule(...))`` missing a required key
         (``name`` / ``init`` / ``build_step``)

TH001 takes the place of the reference's JH001-JH003 (Python branches on
traced values and host syncs under ``jax.jit``).  The reference's RC101
(a ``jax.jit`` built per call, which defeats the compile cache) and PT101
(a dataclass not registered as a pytree) have no torch meaning: eager
torch compiles nothing, and the port's dataclasses are walked by
``runtime.tree_map``, which needs no registration.  Neither is ported.

**Step scope** is decided statically.  A function is in step scope when
it is (b) named ``dispatch`` (the rule's stage of ``compose_step``); (d)
the function a step factory (``make_*_step`` / ``_build_step`` /
``compose_step`` / ``stream._segment_core``, whose returned ``seg`` is
the round body of a stream segment) returns by name; (e) marked
``# simxlint: jit-scope`` on its ``def`` line; or, transitively, (f)
nested inside a step-scope function or (g) called by name from one
(megha's ``piggyback``, the runtime's ``completion_masks``).  The letters
are the reference's rules; (a) and (c), ``jax.jit`` decorators and
functions handed to ``lax`` control flow, have no torch counterpart.
Factory *bodies* are host code: megha's ``layout is None`` branch never
fires.

A *device expression* is one holding a call rooted at ``torch`` or a
parameter of an enclosing step-scope function (unannotated, or annotated
as a tensor: ``width: int`` is host data), once metadata reads are set
aside: ``.shape`` / ``.dim()`` / ``.numel()`` / ``.dtype`` / ``.device``,
``len()`` / ``isinstance()``, and ``is`` / ``is not`` comparisons read no
device memory.  What another function returns is not known statically, so
its arguments are not followed (the function is linted itself when it is
in step scope).

Suppression: ``# simxlint: disable=CODE[,CODE...]`` on the flagged line
silences it there; ``# simxlint: disable-file=CODE`` at any line silences
the code for the whole file.  A suppression is for a deliberate host read
and its comment says why (megha's borrow check); ``ROADMAP.md`` lists
every one under its costs.

CLI::

    python -m repro_torch.analysis.simxlint src/repro_torch/simx
    python -m repro_torch.analysis.simxlint --report lint_report.json PATH...

Exit 0 when clean, 1 when any finding survives suppression, 2 on usage
errors.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

#: step factories whose NESTED functions are the step (their own
#: bodies are host code)
_FACTORY_RE = re.compile(r"^(make_\w+_step|_?build_step|compose_step|_segment_core)$")

#: methods that copy a tensor to the host
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")

#: attribute reads and methods that give a tensor's metadata, not its data
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad"}
_META_METHODS = {"dim", "size", "numel", "nelement", "element_size", "is_contiguous",
                 "stride", "is_floating_point", "get_device"}
_META_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "callable", "id"}

_DISABLE_LINE_RE = re.compile(r"#\s*simxlint:\s*disable=([A-Z0-9, ]+)")
_DISABLE_FILE_RE = re.compile(r"#\s*simxlint:\s*disable-file=([A-Z0-9, ]+)")
_JIT_SCOPE_MARK_RE = re.compile(r"#\s*simxlint:\s*jit-scope")

_REQUIRED_RULE_KEYS = ("name", "init", "build_step")


def _runtime_owned_fields() -> tuple:
    """The SC101 reserved-write set, read from the port's runtime so that
    the rule and the runtime cannot drift."""
    from repro_torch.simx.runtime import RUNTIME_OWNED_FIELDS

    return tuple(RUNTIME_OWNED_FIELDS)


@dataclass(frozen=True)
class Finding:
    """One lint violation, formatted ``file:line: CODE message``."""

    file: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.code} {self.message}"


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` -> that string; '' if not a plain
    name/attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _root(node: ast.AST) -> str:
    d = _dotted(node)
    return d.split(".", 1)[0] if d else ""


def _is_metadata(node: ast.AST) -> bool:
    """Does this sub-expression read only metadata (or identity)?"""
    if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr in _META_METHODS:
            return True
        if _dotted(node.func) in _META_CALLS:
            return True
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return True
    return False


def _device_expr(expr: ast.AST, params: frozenset) -> bool:
    """Does the expression read device data: a ``torch.*`` call or a
    step-scope tensor parameter, outside metadata reads?  The arguments of
    another call are not followed: what a helper returns is not known here
    (a step-scope helper is linted on its own), but a method of a parameter
    (``x.any()``) is."""
    if _is_metadata(expr):
        return False
    if isinstance(expr, ast.Call):
        if _root(expr.func) == "torch":
            return True
        return _device_expr(expr.func, params)
    if isinstance(expr, ast.Name) and expr.id in params:
        return True
    if isinstance(expr, ast.Lambda):
        return False
    return any(_device_expr(c, params) for c in ast.iter_child_nodes(expr))


def _tensor_params(fn: ast.AST) -> set:
    """The parameters of ``fn`` that may hold a tensor: unannotated ones
    and those whose annotation names ``Tensor`` (``num_rounds: int`` or
    ``cfg: SimxConfig`` hold none)."""
    out = set()
    for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        if a.arg == "self":
            continue
        ann = a.annotation
        if ann is None or "Tensor" in ast.unparse(ann):
            out.add(a.arg)
    return out


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------


def _module_name(path: Path) -> str:
    """``src/repro_torch/simx/runtime.py`` -> ``repro_torch.simx.runtime``
    (a file outside the package keeps its stem)."""
    parts = path.with_suffix("").parts
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
        return ".".join(parts).removesuffix(".__init__")
    return path.stem


class _FileLinter:
    """One file: its suppressions, its function index (parents, the names
    each body calls or mentions, what factories return) and its import
    aliases, so that a step-scope call ``rt.take(...)`` reaches
    ``runtime.take`` in another linted file."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.findings: list[Finding] = []
        self.file_disabled: set = set()
        for line in self.lines:
            m = _DISABLE_FILE_RE.search(line)
            if m:
                self.file_disabled |= {c.strip() for c in m.group(1).split(",")}
        self.module = _module_name(Path(path))
        self.tree: Optional[ast.Module] = None
        try:
            self.tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            self.findings.append(
                Finding(self.path, e.lineno or 0, "E000", f"syntax error: {e.msg}"))
            return
        self._index()

    # -- suppression ----------------------------------------------------

    def _line_disabled(self, line: int, code: str) -> bool:
        if code in self.file_disabled:
            return True
        if 1 <= line <= len(self.lines):
            m = _DISABLE_LINE_RE.search(self.lines[line - 1])
            if m and code in {c.strip() for c in m.group(1).split(",")}:
                return True
        return False

    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if self._line_disabled(line, code):
            return
        # one finding per line and code: `if bool(torch.any(x)):` is one read
        if any(f.line == line and f.code == code for f in self.findings):
            return
        self.findings.append(Finding(self.path, line, code, message))

    def _marked_step_scope(self, fn: ast.AST) -> bool:
        line = getattr(fn, "lineno", 0)
        if 1 <= line <= len(self.lines):
            return bool(_JIT_SCOPE_MARK_RE.search(self.lines[line - 1]))
        return False

    # -- index ----------------------------------------------------------

    def _index(self) -> None:
        self.funcs: dict = {}      # id -> node
        self.parent: dict = {}     # id -> enclosing function id (or None)
        self.method: set = set()   # ids defined directly in a class body
        self.refs: dict = {}       # id -> names / dotted callees in own body
        self.returned: set = set() # (factory id, name it returns)
        self.aliases: dict = {}    # local name -> dotted module or function

        def own_body(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                yield child
                yield from own_body(child)

        def index(node, enclosing, in_class):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fid = id(child)
                    self.funcs[fid] = child
                    self.parent[fid] = enclosing
                    if in_class:
                        self.method.add(fid)
                    body = list(own_body(child))
                    self.refs[fid] = (
                        {_dotted(n.func) for n in body if isinstance(n, ast.Call)}
                        | {n.id for n in body if isinstance(n, ast.Name)})
                    if _FACTORY_RE.match(child.name):
                        for n in body:
                            if isinstance(n, ast.Return) and isinstance(n.value, ast.Name):
                                self.returned.add((fid, n.value.id))
                    index(child, fid, False)
                else:
                    index(child, enclosing, isinstance(child, ast.ClassDef))

        index(self.tree, None, False)
        for n in ast.walk(self.tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
                for a in n.names:
                    self.aliases[a.asname or a.name] = f"{n.module}.{a.name}"

    def seeds(self) -> set:
        """Step-scope roots: ``dispatch``, marked defs, factory returns."""
        return {
            fid for fid, fn in self.funcs.items()
            if fn.name == "dispatch" or self._marked_step_scope(fn)
            or (self.parent[fid], fn.name) in self.returned
        }

    def top_level(self, name: str) -> list:
        """Module-level functions named ``name``."""
        return [fid for fid, fn in self.funcs.items()
                if fn.name == name and self.parent[fid] is None and fid not in self.method]

    # -- rules ----------------------------------------------------------

    def check_register_rules(self) -> None:
        for n in ast.walk(self.tree):
            if not (isinstance(n, ast.Call) and _dotted(n.func).endswith("register_rule")):
                continue
            for a in n.args:
                if isinstance(a, ast.Call) and _dotted(a.func).split(".")[-1] == "Rule":
                    given = {k.arg for k in a.keywords if k.arg}
                    missing = [k for k in _REQUIRED_RULE_KEYS if k not in given]
                    # positional args fill name/init/build_step in order
                    missing = missing[len(a.args):] if a.args else missing
                    if missing:
                        self._emit(
                            a, "SC102",
                            "register_rule(Rule(...)) missing required "
                            f"key(s): {', '.join(missing)}: the registry "
                            "contract needs name, init, and build_step",
                        )

    def lint_step(self, fid: int, step: set) -> None:
        """TH001 (and SC101 for ``dispatch``) over one step-scope function,
        with the parameter names of it and its step-scope ancestors."""
        fn = self.funcs[fid]
        params: set = set()
        cur = fid
        while cur is not None:
            if (self, cur) in step:
                params |= _tensor_params(self.funcs[cur])
            cur = self.parent[cur]
        self._lint_step_body(fn, frozenset(params))
        if fn.name == "dispatch":
            self._check_dispatch_writes(fn)

    def _lint_step_body(self, fn: ast.AST, params: frozenset) -> None:
        """TH001 over one step-scope function body (nested defs get their
        own pass, so stop at them)."""
        def iter_own(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                yield child
                yield from iter_own(child)

        for n in iter_own(fn):
            if isinstance(n, (ast.If, ast.While)) and _device_expr(n.test, params):
                kind = "if" if isinstance(n, ast.If) else "while"
                self._emit(
                    n, "TH001",
                    f"Python `{kind}` on a device value inside step scope: the "
                    "host waits for the device to read it, and a CUDA graph of "
                    "the round cannot hold the branch; keep it on the device "
                    "(torch.where) or decide it when the step is built",
                )
            elif isinstance(n, ast.Call):
                d = _dotted(n.func)
                if isinstance(n.func, ast.Attribute) and n.func.attr in _HOST_METHODS:
                    self._emit(
                        n, "TH001",
                        f".{n.func.attr}() inside step scope: a device->host "
                        "copy, one sync a call; keep the value on the device",
                    )
                elif d in ("float", "int", "bool") and n.args and any(
                    _device_expr(a, params) for a in n.args
                ):
                    self._emit(
                        n, "TH001",
                        f"{d}() of a device value inside step scope: a "
                        "device->host sync; keep the tensor (.to(dtype)) or "
                        "decide it when the step is built",
                    )

    def _check_dispatch_writes(self, fn: ast.FunctionDef) -> None:
        """SC101: the dispatch stage's update dict must not contain
        runtime-owned fields (``runtime.STAGE_TABLE`` gives ``t``/``rnd``
        to the metrics stage and ``lost`` to the fault stage)."""
        owned = set(_runtime_owned_fields())

        def check_keys(node: ast.AST, keys: Iterable) -> None:
            bad = sorted(owned & set(keys))
            if bad:
                self._emit(
                    node, "SC101",
                    f"dispatch writes runtime-owned field(s) {', '.join(bad)}"
                    ": the runtime advances t/rnd and folds lost itself "
                    "(see runtime.STAGE_TABLE); returning them from dispatch "
                    "double-applies the update",
                )

        for n in ast.walk(fn):
            if isinstance(n, ast.Dict):
                check_keys(n, (
                    k.value for k in n.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)
                ))
            elif isinstance(n, ast.Call) and _dotted(n.func) == "dict":
                check_keys(n, (k.arg for k in n.keywords if k.arg))
            elif (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Subscript)
                and isinstance(n.targets[0].slice, ast.Constant)
                and isinstance(n.targets[0].slice.value, str)
            ):
                check_keys(n, (n.targets[0].slice.value,))


def _resolve(lf: _FileLinter, ref: str, by_module: dict) -> list:
    """The ``(file linter, function id)`` pairs a name or dotted callee in
    ``lf`` refers to: a non-method function of that name in the same file
    (the reference's rule (g)), or, through an import alias, a module-level
    function of another linted file (``rt.take``, an imported
    ``apply_worker_faults``)."""
    head, _, rest = ref.partition(".")
    out = []
    if not rest:
        out += [(lf, fid) for fid, fn in lf.funcs.items()
                if fn.name == ref and fid not in lf.method]
    target = lf.aliases.get(head)
    if target is not None:
        mod, name = (target, rest) if rest else target.rpartition(".")[::2]
        if "." not in name and mod in by_module:
            other = by_module[mod]
            out += [(other, fid) for fid in other.top_level(name)]
    return out


def _lint_all(linters: list) -> None:
    """Resolve step scope across the files to a fixpoint, then lint every
    step-scope function."""
    by_module = {lf.module: lf for lf in linters if lf.tree is not None}
    parsed = list(by_module.values())
    step = {(lf, fid) for lf in parsed for fid in lf.seeds()}
    todo = list(step)
    while todo:
        lf, fid = todo.pop()
        found = [(lf, c) for c, p in lf.parent.items() if p == fid]
        for ref in lf.refs[fid]:
            found += _resolve(lf, ref, by_module)
        for key in found:
            # a factory's body is host code even where a segment calls it
            if key not in step and not _FACTORY_RE.match(key[0].funcs[key[1]].name):
                step.add(key)
                todo.append(key)
    for lf in parsed:
        lf.check_register_rules()
    for lf, fid in step:
        lf.lint_step(fid, step)


# ---------------------------------------------------------------------------
# driver / CLI
# ---------------------------------------------------------------------------


def lint_file(path) -> list[Finding]:
    """Lint one file, as ``lint_paths([path])`` does: step scope is
    resolved within that file alone.  A path that cannot be read raises
    (``FileNotFoundError`` for a missing one), as in the reference."""
    p = Path(path)
    linter = _FileLinter(str(p), p.read_text())
    _lint_all([linter])
    return sorted(linter.findings, key=lambda x: (x.file, x.line, x.code))


def lint_paths(paths: Iterable) -> list[Finding]:
    """Lint every ``.py`` file under the given files/directories; findings
    sorted by (file, line, code)."""
    files: list[Path] = []
    for p in map(Path, paths):
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
        else:
            raise FileNotFoundError(f"{p}: not a .py file or directory")
    linters = [_FileLinter(str(f), f.read_text()) for f in files]
    _lint_all(linters)
    findings = [x for lf in linters for x in lf.findings]
    return sorted(findings, key=lambda x: (x.file, x.line, x.code))


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    report: Optional[str] = None
    if "--report" in argv:
        i = argv.index("--report")
        try:
            report = argv[i + 1]
        except IndexError:
            print("simxlint: --report needs a file argument", file=sys.stderr)
            return 2
        del argv[i : i + 2]
    if not argv:
        print(
            "usage: python -m repro_torch.analysis.simxlint [--report FILE] PATH...",
            file=sys.stderr,
        )
        return 2
    try:
        findings = lint_paths(argv)
    except FileNotFoundError as e:
        print(f"simxlint: {e}", file=sys.stderr)
        return 2
    for f in findings:
        print(f)
    if report:
        Path(report).write_text(
            json.dumps([dataclasses.asdict(f) for f in findings], indent=2) + "\n"
        )
    if findings:
        print(f"simxlint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"simxlint: clean over {len(argv)} path(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
