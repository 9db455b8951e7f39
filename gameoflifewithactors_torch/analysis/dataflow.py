"""Flow-sensitive AST analyses feeding rules GOL008-GOL010 -- stdlib only.

Counterpart of ``gameoflifewithactors_tpu.analysis.dataflow``. The
line-local rules cannot see a value travelling several hops (a
``self`` store in one method, an in-place write in another) or the
*order* in which two locks are taken across classes. This module holds
the def-use and graph machinery those rules need; the rules in
:mod:`.rules` are thin adapters that turn results into Findings.

Three analyses:

- :func:`in_place_alias_findings` -- per-module def-use tracking of
  caller-owned arrays through aliasing producers (``torch.from_numpy``,
  ``torch.as_tensor`` and their ``.view``/``.reshape``/slices, forwarding
  helpers, ``self`` attribute stores) into an in-place write or the state
  argument of a runner that steps in place. In torch, stepping in place is
  what donation was in JAX: the caller's buffer changes under it.
  ``.clone()`` and ``torch.tensor(x)`` copy, and break the chain.
- :class:`LockGraph` -- the project-wide lock-acquisition graph over the
  classes of ``obs/``, ``serve/`` and ``resilience/`` (GOL009).
- :func:`collect_metric_decls` / :func:`per_chip_gauge_names` -- the
  constant-string metric declarations and the ``PER_CHIP_GAUGES`` set of
  ``obs/aggregate.py``, for GOL010.

Heuristic on purpose, tuned for zero false positives on this tree: when a
chain cannot be proven, it is dropped, not guessed at.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

# -- tiny shared helpers (rules.py imports these) -----------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return tuple(e.value for e in node.elts)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    return None


def const_int_tuple(node: ast.AST) -> Optional[Tuple[int, ...]]:
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, int)
            for e in node.elts):
        return tuple(e.value for e in node.elts)
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    return None


def param_names(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in getattr(a, "posonlyargs", [])]
    names += [p.arg for p in a.args]
    names += [p.arg for p in a.kwonlyargs]
    return names


def lock_attr_types(cls: ast.ClassDef) -> Dict[str, str]:
    """``self`` attributes assigned a threading.Lock()/RLock() anywhere
    in the class (typically __init__), mapped to which kind -- the
    distinction matters: re-acquiring a plain Lock self-deadlocks."""
    locks: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call):
            d = dotted(node.value.func) or ""
            kind = d.split(".")[-1]
            if kind in ("Lock", "RLock"):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and isinstance(
                            t.value, ast.Name) and t.value.id == "self":
                        locks[t.attr] = kind
    return locks


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' when ``node`` is exactly ``self.x``."""
    if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _walk_scope(root: ast.AST) -> Iterable[ast.AST]:
    """ast.walk that does NOT descend into nested function/lambda bodies:
    their parameters shadow the enclosing scope (two sibling lambdas both
    taking ``s`` share nothing), so flow facts must not leak across."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)) and child is not root:
                continue
            stack.append(child)


# =============================================================================
# in-place aliasing (GOL008)
# =============================================================================

# producers whose result shares the buffer of their first argument
_ALIASING_PRODUCERS = ("torch.from_numpy", "torch.as_tensor", "from_numpy",
                       "as_tensor")
# tensor methods whose result is a view of the receiver
VIEW_METHODS = {"view", "reshape", "view_as", "reshape_as", "transpose",
                "permute", "flatten", "squeeze", "unsqueeze", "narrow",
                "select", "expand", "t", "unflatten", "as_strided",
                "movedim", "unbind", "split", "chunk", "contiguous",
                "detach"}
# factories (and functions) of this package whose runner writes its first
# argument in place: the state argument belongs to the runner once passed
IN_PLACE_FACTORIES = {"make_multi_step_paged",
                      "make_multi_step_packed_sparse_tiled",
                      "make_multi_step_generations_packed_sparse_tiled"}
IN_PLACE_FUNCTIONS = {"_write_slot", "_zero_slot"}
IN_PLACE_DECORATOR = "steps_in_place"


def is_in_place_method(name: str) -> bool:
    """``x.add_(...)``-style: a torch method that writes its receiver."""
    return name.endswith("_") and not name.startswith("_")


def declares_in_place(fn: ast.AST) -> bool:
    """A def decorated ``@steps_in_place`` (any dotted spelling)."""
    return any((dotted(d) or "").split(".")[-1] == IN_PLACE_DECORATOR
               for d in getattr(fn, "decorator_list", []))


@dataclasses.dataclass(frozen=True)
class Alias:
    """A value proven to share the caller's buffer."""

    root: str       # the caller-owned name it aliases (a parameter)
    producer: str   # "torch.from_numpy", "torch.as_tensor", "helper()"
    line: int       # where the alias was made (for the message)


def _producer(call: ast.Call) -> Optional[str]:
    d = dotted(call.func) or ""
    if call.args and (d in _ALIASING_PRODUCERS):
        return d
    return None


def _view_base(expr: ast.AST) -> ast.AST:
    """Unwrap view-preserving syntax -- slices, ``.view(...)``,
    ``.reshape(...)``, ... -- down to the expression whose buffer is
    shared."""
    while True:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Call) and isinstance(
                expr.func, ast.Attribute) and expr.func.attr in VIEW_METHODS:
            expr = expr.func.value
        else:
            return expr


class _FnAnalysis:
    """One function's linear pass: the environment of proven aliases,
    checked at every in-place write and in-place runner call."""

    def __init__(self, owner: "_InPlaceAnalysis", fn: ast.AST,
                 owned: Set[str], attr_aliases: Dict[str, Alias]):
        self.owner = owner
        self.fn = fn
        self.owned = owned                # caller-owned names (parameters)
        self.attr_aliases = attr_aliases  # class-wide: attr -> Alias
        self.env: Dict[str, Alias] = {}
        self.findings: List[Tuple[ast.AST, str]] = []

    def alias_of(self, expr: ast.AST) -> Optional[Alias]:
        """The Alias a value expression carries, if provable."""
        expr = _view_base(expr)
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id)
        attr = _self_attr(expr)
        if attr is not None:
            return self.attr_aliases.get(attr)
        if isinstance(expr, ast.Call):
            producer = _producer(expr)
            if producer is not None:
                base = _view_base(expr.args[0])
                if isinstance(base, ast.Name) and base.id in self.owned:
                    return Alias(base.id, producer, expr.lineno)
                inner = self.alias_of(expr.args[0])
                if inner is not None:
                    return inner
            # one level of helper forwarding: y = prep(buf) where
            # ``def prep(x): return torch.from_numpy(x)``
            fname = (dotted(expr.func) or "").split(".")[-1]
            idx = self.owner.forwarders.get(fname)
            if idx is not None and idx < len(expr.args):
                base = _view_base(expr.args[idx])
                if isinstance(base, ast.Name) and base.id in self.owned:
                    return Alias(base.id, f"{fname}() (returns an alias of "
                                          f"its argument)", expr.lineno)
        return None

    def run(self) -> None:
        for stmt in self.fn.body:
            self._stmt(stmt)

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return  # nested scope: analysed on its own
        if isinstance(node, ast.Assign):
            self._visit_calls(node.value)
            for t in node.targets:
                self._check_store(t, node)
            alias = self.alias_of(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if alias is not None:
                        self.env[t.id] = alias
                    else:
                        self.env.pop(t.id, None)
            return
        if isinstance(node, ast.AugAssign):
            self._visit_calls(node.value)
            self._check_store(node.target, node)
            return
        if isinstance(node, ast.Call):
            self._check_call(node)
        for child in ast.iter_child_nodes(node):
            self._stmt(child)

    def _visit_calls(self, node: ast.AST) -> None:
        for sub in _walk_scope(node):
            if isinstance(sub, ast.Call):
                self._check_call(sub)

    def _flag(self, node: ast.AST, alias: Alias, how: str) -> None:
        self.findings.append((node, (
            f"{how} writes caller-owned array '{alias.root}' in place "
            f"(aliased via {alias.producer} at line {alias.line}): the "
            "caller's buffer changes under it -- copy first with "
            ".clone() or torch.tensor(x)")))

    def _check_store(self, target: ast.AST, node: ast.AST) -> None:
        if isinstance(target, ast.Subscript):
            alias = self.alias_of(target.value)
            if alias is not None:
                self._flag(node, alias, "an indexed store")

    def _check_call(self, call: ast.Call) -> None:
        f = call.func
        if isinstance(f, ast.Attribute) and is_in_place_method(f.attr):
            alias = self.alias_of(f.value)
            if alias is not None:
                self._flag(call, alias, f"`.{f.attr}()`")
        for kw in call.keywords:
            if kw.arg == "out":
                alias = self.alias_of(kw.value)
                if alias is not None:
                    self._flag(call, alias, "`out=`")
        fname = dotted(f)
        if fname is not None and call.args and (
                fname in self.owner.in_place_callables
                or fname.split(".")[-1] in IN_PLACE_FUNCTIONS):
            alias = self.alias_of(call.args[0])
            if alias is not None:
                self._flag(call, alias,
                           f"the in-place runner `{fname}` (its state "
                           "argument)")


class _InPlaceAnalysis:
    """Module-level orchestration: in-place callables, forwarding
    helpers, per-class attribute aliases, then every function body."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        # dotted callee names proven to step their first argument in place
        self.in_place_callables: Set[str] = set()
        # helper name -> index of the param its return value aliases
        self.forwarders: Dict[str, int] = {}
        self.findings: List[Tuple[ast.AST, str]] = []
        self._collect_module_facts()

    def _collect_module_facts(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if declares_in_place(node):
                    self.in_place_callables.add(node.name)
                params = param_names(node)
                ret = node.body[-1] if node.body else None
                if isinstance(ret, ast.Return) and isinstance(
                        ret.value, ast.Call) and _producer(ret.value):
                    base = _view_base(ret.value.args[0])
                    if isinstance(base, ast.Name) and base.id in params:
                        self.forwarders[node.name] = params.index(base.id)
            elif isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                tail = (dotted(node.value.func) or "").split(".")[-1]
                if tail in IN_PLACE_FACTORIES or tail == IN_PLACE_DECORATOR:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.in_place_callables.add(t.id)
                        attr = _self_attr(t)
                        if attr is not None:
                            self.in_place_callables.add(f"self.{attr}")

    def run(self) -> List[Tuple[ast.AST, str]]:
        class_fns: Set[int] = set()
        for cls in [n for n in ast.walk(self.tree)
                    if isinstance(n, ast.ClassDef)]:
            attr_aliases = self._class_attr_aliases(cls)
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    class_fns.add(id(fn))
                    owned = set(param_names(fn)) - {"self", "cls"}
                    fa = _FnAnalysis(self, fn, owned, attr_aliases)
                    fa.run()
                    self.findings.extend(fa.findings)
        for fn in ast.walk(self.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(fn) not in class_fns:
                fa = _FnAnalysis(self, fn, set(param_names(fn)), {})
                fa.run()
                self.findings.extend(fa.findings)
        return self.findings

    def _class_attr_aliases(self, cls: ast.ClassDef) -> Dict[str, Alias]:
        """self attributes that alias a caller-owned array in ANY method
        (an aliased store is sticky: one clean re-assignment elsewhere
        does not un-alias the caller's copy)."""
        out: Dict[str, Alias] = {}
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            owned = set(param_names(fn)) - {"self", "cls"}
            fa = _FnAnalysis(self, fn, owned, {})
            for node in _walk_scope(fn):
                if not isinstance(node, ast.Assign):
                    continue
                alias = fa.alias_of(node.value)
                for t in node.targets:
                    if isinstance(t, ast.Name) and alias is not None:
                        fa.env[t.id] = alias
                    attr = _self_attr(t)
                    if attr is not None and alias is not None \
                            and attr not in out:
                        out[attr] = alias
        return out


def in_place_alias_findings(tree: ast.Module) -> List[Tuple[ast.AST, str]]:
    """GOL008's engine: (node, message) pairs for caller-owned arrays
    whose alias is written in place or handed to an in-place runner."""
    return _InPlaceAnalysis(tree).run()


# =============================================================================
# lock-order graph (GOL009)
# =============================================================================


@dataclasses.dataclass
class _Acquisition:
    """One 'acquired B while holding A' event inside a method."""

    held: str                      # lock attr currently held (same class)
    target: Tuple                  # ("lock", attr) | ("self", meth)
    #                              | ("attr", obj_attr, meth)
    node: ast.AST


@dataclasses.dataclass
class ClassLockSummary:
    """Everything the project pass needs to know about one class."""

    path: str
    name: str
    locks: Dict[str, str]                    # lock attr -> Lock | RLock
    attr_types: Dict[str, str]               # self._x = Cls(...) -> Cls
    entry_acquires: Dict[str, List[Tuple[str, ast.AST]]]  # method ->
    #                                        locks taken while holding none
    held_events: Dict[str, List[_Acquisition]]            # method -> events


def summarize_class_locks(cls: ast.ClassDef, path: str) -> ClassLockSummary:
    locks = lock_attr_types(cls)
    attr_types: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call):
            ctor = dotted(node.value.func)
            if ctor and ctor.split(".")[-1][:1].isupper():
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        attr_types[attr] = ctor.split(".")[-1]
    entry: Dict[str, List[Tuple[str, ast.AST]]] = {}
    events: Dict[str, List[_Acquisition]] = {}

    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        e_list: List[Tuple[str, ast.AST]] = []
        ev_list: List[_Acquisition] = []

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in locks:
                        acquired.append((attr, item.context_expr))
                for attr, site in acquired:
                    if held:
                        ev_list.append(_Acquisition(
                            held=held[-1], target=("lock", attr),
                            node=site))
                    else:
                        e_list.append((attr, site))
                new_held = held + tuple(a for a, _ in acquired)
                for child in node.body:
                    walk(child, new_held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.Call) and held:
                f = node.func
                if isinstance(f, ast.Attribute):
                    owner = _self_attr(f.value)
                    if isinstance(f.value, ast.Name) \
                            and f.value.id == "self":
                        ev_list.append(_Acquisition(
                            held=held[-1], target=("self", f.attr),
                            node=node))
                    elif owner is not None:
                        ev_list.append(_Acquisition(
                            held=held[-1],
                            target=("attr", owner, f.attr), node=node))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for child in fn.body:
            walk(child, ())
        if e_list:
            entry[fn.name] = e_list
        if ev_list:
            events[fn.name] = ev_list

    return ClassLockSummary(path=path, name=cls.name, locks=locks,
                            attr_types=attr_types, entry_acquires=entry,
                            held_events=events)


@dataclasses.dataclass
class LockEdge:
    """src lock-node acquires dst lock-node while held."""

    src: str                       # "Class.attr"
    dst: str
    path: str                      # module emitting the edge
    node: ast.AST
    how: str                       # human phrasing for the finding
    cross_class: bool


class LockGraph:
    """The project-wide acquired-while-holding graph."""

    def __init__(self, summaries: Iterable[ClassLockSummary]):
        self.classes: Dict[str, ClassLockSummary] = {}
        for s in summaries:
            if s.locks:
                self.classes[s.name] = s
        self.edges: List[LockEdge] = []
        # (summary, method, ast node, description) -- re-entry of a plain
        # threading.Lock, the guaranteed-deadlock case. Self-loop edges
        # never enter the graph: RLock re-entry is legal and a plain-Lock
        # re-entry is reported here, not as a "cycle".
        self.self_deadlocks: List[Tuple[ClassLockSummary, str,
                                        ast.AST, str]] = []
        self._build()

    def _node(self, cls: str, attr: str) -> str:
        return f"{cls}.{attr}"

    def _build(self) -> None:
        for s in self.classes.values():
            for meth, events in s.held_events.items():
                for ev in events:
                    src = self._node(s.name, ev.held)
                    kind = ev.target[0]
                    if kind == "lock":
                        attr = ev.target[1]
                        if attr == ev.held:
                            if s.locks.get(attr) == "Lock":
                                self.self_deadlocks.append((
                                    s, meth, ev.node,
                                    f"{s.name}.{meth} nests `with "
                                    f"self.{attr}` inside `with "
                                    f"self.{attr}`"))
                            continue
                        self.edges.append(LockEdge(
                            src=src,
                            dst=self._node(s.name, attr),
                            path=s.path, node=ev.node,
                            how=f"{s.name}.{meth} nests "
                                f"`with self.{attr}` inside "
                                f"`with self.{ev.held}`",
                            cross_class=False))
                    elif kind == "self":
                        callee = ev.target[1]
                        for attr, _ in s.entry_acquires.get(callee, []):
                            if attr == ev.held:
                                if s.locks.get(attr) == "Lock":
                                    self.self_deadlocks.append((
                                        s, meth, ev.node,
                                        f"{s.name}.{meth} calls "
                                        f"self.{callee}() while holding "
                                        f"self.{ev.held}, and {callee} "
                                        f"re-acquires self.{ev.held}"))
                                continue
                            self.edges.append(LockEdge(
                                src=src, dst=self._node(s.name, attr),
                                path=s.path, node=ev.node,
                                how=f"{s.name}.{meth} calls "
                                    f"self.{callee}() (which takes "
                                    f"self.{attr}) while holding "
                                    f"self.{ev.held}",
                                cross_class=False))
                    else:
                        _, obj_attr, callee = ev.target
                        tcls = self.classes.get(
                            s.attr_types.get(obj_attr, ""))
                        if tcls is None:
                            continue
                        for attr, _ in tcls.entry_acquires.get(callee, []):
                            self.edges.append(LockEdge(
                                src=src,
                                dst=self._node(tcls.name, attr),
                                path=s.path, node=ev.node,
                                how=f"{s.name}.{meth} calls "
                                    f"self.{obj_attr}.{callee}() (which "
                                    f"takes {tcls.name}.{attr}) while "
                                    f"holding self.{ev.held}",
                                cross_class=True))

    def cycles(self) -> List[List[LockEdge]]:
        """Elementary cycles in the acquisition graph, each reported once
        (deduped on the canonical node set)."""
        adj: Dict[str, List[LockEdge]] = {}
        for e in self.edges:
            adj.setdefault(e.src, []).append(e)
        seen_sets: Set[frozenset] = set()
        out: List[List[LockEdge]] = []

        def dfs(node: str, path_edges: List[LockEdge],
                on_path: Dict[str, int]) -> None:
            for e in adj.get(node, []):
                if e.dst in on_path:
                    cyc = path_edges[on_path[e.dst]:] + [e]
                    key = frozenset(x.src for x in cyc)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        out.append(cyc)
                    continue
                on_path[e.dst] = len(path_edges) + 1
                dfs(e.dst, path_edges + [e], on_path)
                del on_path[e.dst]

        for start in sorted(adj):
            dfs(start, [], {start: 0})
        return out


# =============================================================================
# metric discipline (GOL010)
# =============================================================================

_METRIC_KINDS = ("counter", "gauge", "histogram")


@dataclasses.dataclass(frozen=True)
class MetricDecl:
    name: str
    kind: str        # counter | gauge | histogram
    path: str
    node: ast.AST = dataclasses.field(compare=False, hash=False)


def collect_metric_decls(tree: ast.Module, path: str) -> List[MetricDecl]:
    """Constant-string ``*.counter/gauge/histogram("name", ...)`` calls.
    Dynamic names are invisible to the registry-discipline checks on
    purpose -- guessing would produce noise, and the runtime registry
    still enforces kind conflicts for those."""
    out: List[MetricDecl] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_KINDS):
            continue
        if not (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        out.append(MetricDecl(name=node.args[0].value,
                              kind=node.func.attr, path=path, node=node))
    return out


def per_chip_gauge_names(tree: ast.Module) -> Optional[Set[str]]:
    """The literal ``PER_CHIP_GAUGES`` set out of obs/aggregate.py's AST,
    or None when no such constant assignment exists."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "PER_CHIP_GAUGES"
                   for t in node.targets):
            continue
        names: Set[str] = set()
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                names.add(sub.value)
        return names
    return None
