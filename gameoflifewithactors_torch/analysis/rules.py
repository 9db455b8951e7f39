"""The built-in goltpu-lint rules of the port (GOL001...GOL010).

Counterpart of ``gameoflifewithactors_tpu.analysis.rules``. The codes are
the JAX package's, each naming the same failure class, restated for
PyTorch: there is no trace to stay inside, so the hot path is the *step
loop* -- the ``run`` closure a runner factory returns (in ``ops/``,
``memory/``, ``parallel/sharded.py`` and ``parallel/batched.py``, with
the sibling closures it calls) and the body of a
``with ...no_implicit_host_transfers(...)`` block anywhere. Inside an
``allow_host_transfers(reason)`` block a sync is declared, not hidden.
AST-level and heuristic, tuned to zero false positives on this tree;
when a rule cannot decide, it stays quiet.

| code   | invariant                                                    |
| ------ | ------------------------------------------------------------ |
| GOL001 | no host sync in a step loop: ``.item()``, ``.tolist()``,     |
|        | ``.cpu()``, ``.numpy()``, ``int/float/bool`` of a tensor     |
|        | expression, ``torch.nonzero``, ``print``                     |
| GOL002 | no Python ``if``/``while``/``assert`` on a tensor expression |
|        | in a step loop (each is a hidden sync)                       |
| GOL003 | a runner writes no tensor parameter in place unless its      |
|        | closure declares ``@steps_in_place`` (the caller-visible     |
|        | opt-in that donation was in JAX)                             |
| GOL004 | obs/ classes that own a ``_lock`` mutate their shared        |
|        | ``self._*`` state only under it                              |
| GOL005 | no raw ``time.time()``                                       |
| GOL006 | no kernel-library build or load outside ``_build.py``, no    |
|        | CUDA-graph capture outside ``aot/registry.py``, no           |
|        | ``torch.compile``: untracked builds escape the compile log   |
| GOL007 | obs/ classes that own a ``_lock`` read their ``self._cache`` |
|        | only under it                                                |
| GOL008 | no alias of a caller-owned array (``torch.from_numpy`` /     |
|        | ``torch.as_tensor`` of a parameter) reaches an in-place      |
|        | write or an in-place runner's state argument                 |
| GOL009 | the obs/serve/resilience lock-acquisition graph is acyclic   |
| GOL010 | registry counters end ``_total``; per-chip gauges are listed |
|        | in obs/aggregate.py PER_CHIP_GAUGES; one kind per name       |
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import dataflow
from .lint import Finding, ModuleContext, ProjectContext, register, \
    register_project

# list/dict/set/deque mutators for the lock-discipline rule
_MUTATORS = {"append", "appendleft", "extend", "insert", "pop", "popleft",
             "remove", "clear", "update", "setdefault", "add", "discard"}

_dotted = dataflow.dotted


# -- step loops (GOL001-GOL003) -----------------------------------------------

GUARD_SCOPE = "no_implicit_host_transfers"
ALLOW_SCOPE = "allow_host_transfers"

# tensor methods that read a device value back to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NONZERO = {"nonzero", "argwhere"}
# methods whose result is a tensor holding data (a reduction or a test):
# int()/bool()/if of one reads it back
_TENSOR_METHODS = {"sum", "any", "all", "max", "min", "amax", "amin",
                   "mean", "prod", "count_nonzero", "nonzero", "eq", "ne",
                   "gt", "lt", "ge", "le", "equal", "allclose", "argmax",
                   "argmin", "abs", "norm"}
# torch.* calls that return host values
_TORCH_HOST_CALLS = {"device", "Size", "is_tensor", "get_default_dtype",
                     "is_grad_enabled", "dtype", "iinfo", "finfo"}


def _scope_call(item: ast.withitem, name: str) -> bool:
    e = item.context_expr
    return isinstance(e, ast.Call) and \
        (_dotted(e.func) or "").split(".")[-1] == name


def _numpy_rooted(expr: ast.AST) -> bool:
    """The expression is built from numpy (``np.x(...)``): a host value,
    whose reductions read nothing back."""
    return any(isinstance(sub, ast.Name) and sub.id in ("np", "numpy")
               for sub in ast.walk(expr))


def _tensor_expr(node: ast.AST) -> bool:
    """Heuristic: the expression computes a tensor value -- a ``torch.*``
    call (not one of the host-valued ones) or a reduction or test method
    whose receiver is not numpy."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        parts = (_dotted(sub.func) or "").split(".")
        if parts[0] == "torch" and len(parts) > 1 and parts[1] != "cuda" \
                and parts[-1] not in _TORCH_HOST_CALLS:
            return True
        f = sub.func
        if isinstance(f, ast.Attribute) and f.attr in _TENSOR_METHODS \
                and not _numpy_rooted(f.value):
            return True
    return False


class _StepBody:
    """One step-loop body: the statements to scan, why they count, the
    runner's tensor parameters reaching it (GOL003), and whether the
    runner declares that it steps them in place."""

    def __init__(self, stmts: List[ast.stmt], why: str,
                 params: Set[str], in_place: bool):
        self.stmts = stmts
        self.why = why
        self.params = params
        self.in_place = in_place


def _runner_bodies(tree: ast.Module) -> List[_StepBody]:
    """The closures that runner factories return, and the sibling
    closures they call, each with the runner parameters it receives
    positionally."""
    out: List[_StepBody] = []
    for fac in ast.walk(tree):
        if not isinstance(fac, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        nested = {n.name: n for n in fac.body
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if not nested:
            continue
        roots: Dict[str, bool] = {}
        for node in dataflow._walk_scope(fac):
            if not (isinstance(node, ast.Return) and node.value is not None):
                continue
            wrapped = isinstance(node.value, ast.Call) and (
                _dotted(node.value.func) or "").split(".")[-1] == \
                dataflow.IN_PLACE_DECORATOR
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name) and sub.id in nested:
                    roots[sub.id] = roots.get(sub.id, False) or wrapped
        params: Dict[str, Set[str]] = {}
        declared: Dict[str, bool] = {}
        for name, wrapped in roots.items():
            params[name] = set(dataflow.param_names(nested[name]))
            declared[name] = wrapped or dataflow.declares_in_place(
                nested[name])
        # breadth first through calls by name, carrying runner parameters
        # and the in-place declaration to the callees
        todo = list(roots)
        while todo:
            name = todo.pop()
            for call in dataflow._walk_scope(nested[name]):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)
                        and call.func.id in nested
                        and call.func.id != name):
                    continue
                callee = call.func.id
                cparams = dataflow.param_names(nested[callee])
                passed = {cparams[i] for i, a in enumerate(call.args)
                          if i < len(cparams) and isinstance(a, ast.Name)
                          and a.id in params[name]}
                before = (set(params.get(callee, set())),
                          declared.get(callee))
                params.setdefault(callee, set()).update(passed)
                declared[callee] = bool(
                    declared.get(callee) or declared[name]
                    or dataflow.declares_in_place(nested[callee]))
                if (params[callee], declared[callee]) != before:
                    todo.append(callee)
        for name, ps in params.items():
            out.append(_StepBody(nested[name].body,
                                 f"the runner closure {fac.name}.{name}",
                                 ps, declared[name]))
    return out


def _guard_bodies(tree: ast.Module) -> List[_StepBody]:
    return [_StepBody(node.body, f"a {GUARD_SCOPE} scope", set(), False)
            for node in ast.walk(tree)
            if isinstance(node, (ast.With, ast.AsyncWith))
            and any(_scope_call(i, GUARD_SCOPE) for i in node.items)]


def _step_bodies(ctx: ModuleContext) -> List[_StepBody]:
    bodies = _guard_bodies(ctx.tree)
    if ctx.in_step_modules:
        bodies = _runner_bodies(ctx.tree) + bodies
    return bodies


def _walk_body(stmts: List[ast.stmt]) -> Iterable[ast.AST]:
    """Every node of a step-loop body, not descending into nested
    functions, lambdas or classes, nor into an allow_host_transfers
    block (a declared sync point)."""
    stack = list(reversed(stmts))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _scope_call(i, ALLOW_SCOPE) for i in node.items):
            continue
        yield node
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


def _dedupe(findings: List[Finding]) -> List[Finding]:
    """A guard block inside a runner closure is seen twice."""
    seen, out = set(), []
    for f in findings:
        if (f.line, f.col, f.code) not in seen:
            seen.add((f.line, f.col, f.code))
            out.append(f)
    return out


def _sync_kind(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        if f.id == "print":
            return "print()"
        if f.id in ("int", "float", "bool") and call.args \
                and _tensor_expr(call.args[0]):
            return f"{f.id}() of a tensor expression"
        return None
    if isinstance(f, ast.Attribute) and not _numpy_rooted(f.value):
        if f.attr in _SYNC_METHODS:
            return f".{f.attr}()"
        if f.attr in _NONZERO:
            return f"{_dotted(f) or '.' + f.attr}()"
    return None


# -- GOL001: host sync in a step loop ------------------------------------------


@register("GOL001", "host-sync-in-step-loop",
          "no device-to-host sync in a step loop")
def _host_sync_in_step_loop(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for body in _step_bodies(ctx):
        for node in _walk_body(body.stmts):
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_kind(node)
            if kind is not None:
                out.append(ctx.finding(
                    "GOL001", node,
                    f"{kind} inside {body.why} waits for the device and "
                    "reads a value back to the host; keep the value on "
                    "the device, or declare the sync with "
                    "`with allow_host_transfers(reason):`"))
    return _dedupe(out)


# -- GOL002: Python branching on a tensor --------------------------------------


@register("GOL002", "tensor-branch",
          "no Python if/while/assert on a tensor expression in a step loop")
def _tensor_branch(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for body in _step_bodies(ctx):
        for node in _walk_body(body.stmts):
            if not isinstance(node, (ast.If, ast.While, ast.Assert)):
                continue
            if _tensor_expr(node.test):
                kind = {ast.If: "if", ast.While: "while",
                        ast.Assert: "assert"}[type(node)]
                out.append(ctx.finding(
                    "GOL002", node,
                    f"Python `{kind}` on a tensor expression inside "
                    f"{body.why}: its truth value is a hidden device-to-"
                    "host sync; select on the device (torch.where), or "
                    "read the value back once, declared"))
    return _dedupe(out)


# -- GOL003: a runner writing its parameter in place ---------------------------


def _param_base(expr: ast.AST, names: Set[str]) -> Optional[str]:
    base = dataflow._view_base(expr)
    if isinstance(base, ast.Name) and base.id in names:
        return base.id
    return None


def _in_place_write(node: ast.AST, names: Set[str]
                    ) -> Optional[Tuple[str, str]]:
    """(parameter, how) when ``node`` writes one of ``names`` in place."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and \
                dataflow.is_in_place_method(f.attr):
            p = _param_base(f.value, names)
            if p is not None:
                return p, f"`.{f.attr}()`"
        for kw in node.keywords:
            p = _param_base(kw.value, names) if kw.arg == "out" else None
            if p is not None:
                return p, "`out=`"
    elif isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            p = _param_base(t.value, names) \
                if isinstance(t, ast.Subscript) else None
            if p is not None:
                return p, "an indexed store"
    return None


@register("GOL003", "undeclared-in-place",
          "a runner writes a tensor parameter in place only by declaration")
def _undeclared_in_place(ctx: ModuleContext) -> Iterable[Finding]:
    if not ctx.in_step_modules:
        return []
    out: List[Finding] = []
    for body in _runner_bodies(ctx.tree):
        if body.in_place or not body.params:
            continue
        nodes = list(_walk_body(body.stmts))
        # local views of a parameter write it too
        names = set(body.params)
        for node in sorted((n for n in nodes if isinstance(n, ast.Assign)),
                           key=lambda n: n.lineno):
            if _param_base(node.value, names) is not None:
                names |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
        for node in nodes:
            hit = _in_place_write(node, names)
            if hit is not None:
                out.append(ctx.finding(
                    "GOL003", node,
                    f"{hit[1]} writes the runner's tensor argument "
                    f"'{hit[0]}' in place inside {body.why}: the caller's "
                    "tensor changes under it. Return a new tensor, or "
                    "declare in-place stepping with @steps_in_place "
                    "(ops/_builders.py), the caller-visible opt-in that "
                    "donation was"))
    return out


# -- GOL004: obs/ lock discipline ---------------------------------------------


def _lock_attr_names(cls: ast.ClassDef) -> Set[str]:
    """Attributes assigned a threading.Lock()/RLock() anywhere in the
    class (typically __init__)."""
    return set(dataflow.lock_attr_types(cls))


@register("GOL004", "lock-discipline",
          "obs/ shared state mutations must hold the owning class's lock")
def _lock_discipline(ctx: ModuleContext) -> Iterable[Finding]:
    if not ctx.in_obs:
        return []
    out: List[Finding] = []
    for cls in [n for n in ast.walk(ctx.tree)
                if isinstance(n, ast.ClassDef)]:
        locks = _lock_attr_names(cls)
        if not locks:
            continue

        def check_fn(fn: ast.FunctionDef) -> None:
            def walk(node: ast.AST, in_lock: bool) -> None:
                if isinstance(node, ast.With):
                    holds = any(
                        isinstance(item.context_expr, ast.Attribute)
                        and isinstance(item.context_expr.value, ast.Name)
                        and item.context_expr.value.id == "self"
                        and item.context_expr.attr in locks
                        for item in node.items)
                    for child in node.body:
                        walk(child, in_lock or holds)
                    return
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)) \
                        and node is not fn:
                    return  # nested scope: judged on its own if reached
                self_attr = None
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        base = t.value if isinstance(t, ast.Subscript) \
                            else t
                        if isinstance(base, ast.Attribute) and isinstance(
                                base.value, ast.Name) \
                                and base.value.id == "self" \
                                and base.attr.startswith("_") \
                                and base.attr not in locks:
                            self_attr = base.attr
                elif isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr in _MUTATORS:
                    v = node.func.value
                    if isinstance(v, ast.Attribute) and isinstance(
                            v.value, ast.Name) and v.value.id == "self" \
                            and v.attr.startswith("_") \
                            and v.attr not in locks:
                        self_attr = v.attr
                if self_attr is not None and not in_lock:
                    out.append(ctx.finding(
                        "GOL004", node,
                        f"`self.{self_attr}` mutated outside "
                        f"`with self.{sorted(locks)[0]}:` in "
                        f"{cls.name}.{fn.name} -- obs/ recorders are "
                        "read from monitor/exporter threads; hold the "
                        "lock or pragma why this access is safe"))
                for child in ast.iter_child_nodes(node):
                    walk(child, in_lock)

            for child in fn.body:
                walk(child, False)

        for fn in cls.body:
            if isinstance(fn, ast.FunctionDef) and fn.name != "__init__":
                check_fn(fn)
    return out


# -- GOL007: obs/ scrape-cache read discipline --------------------------------


@register("GOL007", "cache-read-discipline",
          "obs/ scrape caches are read only under the owning class's lock")
def _cache_read_discipline(ctx: ModuleContext) -> Iterable[Finding]:
    """GOL004's mirror for *reads*: a TTL scrape cache like
    ``FleetAggregator._cache`` holds a (stamp, payload) tuple replaced
    wholesale under the lock -- reading it lock-free can observe the
    swap mid-publication on a free-threaded build, and the pattern
    invites "just peek at it" drift. Narrow on purpose: only ``self``
    attributes whose name contains ``cache``, only in obs/ classes that
    own a lock, and never inside ``__init__`` (publication happens
    before the object escapes)."""
    if not ctx.in_obs:
        return []
    out: List[Finding] = []
    for cls in [n for n in ast.walk(ctx.tree)
                if isinstance(n, ast.ClassDef)]:
        locks = _lock_attr_names(cls)
        if not locks:
            continue

        def check_fn(fn: ast.FunctionDef) -> None:
            def walk(node: ast.AST, in_lock: bool) -> None:
                if isinstance(node, ast.With):
                    holds = any(
                        isinstance(item.context_expr, ast.Attribute)
                        and isinstance(item.context_expr.value, ast.Name)
                        and item.context_expr.value.id == "self"
                        and item.context_expr.attr in locks
                        for item in node.items)
                    for child in node.body:
                        walk(child, in_lock or holds)
                    return
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)) \
                        and node is not fn:
                    return
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Load) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr.startswith("_") \
                        and "cache" in node.attr \
                        and node.attr not in locks and not in_lock:
                    out.append(ctx.finding(
                        "GOL007", node,
                        f"`self.{node.attr}` read outside "
                        f"`with self.{sorted(locks)[0]}:` in "
                        f"{cls.name}.{fn.name} -- the scrape cache is "
                        "republished wholesale under the lock; snapshot "
                        "it under the lock and work on the local"))
                for child in ast.iter_child_nodes(node):
                    walk(child, in_lock)

            for child in fn.body:
                walk(child, False)

        for fn in cls.body:
            if isinstance(fn, ast.FunctionDef) and fn.name != "__init__":
                check_fn(fn)
    return out


# -- GOL005: raw wall-clock timing --------------------------------------------


@register("GOL005", "wall-clock-timing",
          "time.time() is neither monotonic nor span-attributed")
def _wall_clock(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _dotted(node.func) == "time.time":
            out.append(ctx.finding(
                "GOL005", node,
                "raw time.time(): intervals want time.perf_counter() "
                "(monotonic), instrumented phases want obs.spans.span() "
                "so the RunReport sees them; a genuine wall-clock stamp "
                "needs a pragma saying so"))
    return out


# -- GOL006: builds and graphs outside their choke points ----------------------

_LIBRARY_LOADS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary", "CDLL",
                  "ctypes.PyDLL", "torch.ops.load_library"}
_CPP_EXTENSION = ("load", "load_inline")
_GRAPH_CALLS = {"torch.cuda.graph", "torch.cuda.CUDAGraph",
                "torch.cuda.make_graphed_callables", "CUDAGraph",
                "make_graphed_callables"}


def _runs_nvcc(call: ast.Call) -> bool:
    if not (_dotted(call.func) or "").startswith("subprocess."):
        return False
    for sub in ast.walk(call):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and "nvcc" in sub.value:
            return True
        if isinstance(sub, ast.Call) and \
                (_dotted(sub.func) or "").split(".")[-1] == "find_nvcc":
            return True
    return False


@register("GOL006", "untracked-build",
          "kernel builds and loads only in _build.py, graph capture only "
          "in aot/registry.py, no torch.compile")
def _untracked_build(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and node.attr == "compile" \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "torch":
            out.append(ctx.finding(
                "GOL006", node,
                "torch.compile generates and builds kernels that no "
                "compile event records (the retrace sentinel cannot see "
                "them), and it ports no kernel: write the kernel by hand "
                "(csrc/) and build it through _build.py"))
            continue
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func) or ""
        if not ctx.is_build_choke_point and (
                d in _LIBRARY_LOADS or _runs_nvcc(node)
                or ("cpp_extension" in d.split(".")
                    and d.split(".")[-1] in _CPP_EXTENSION)):
            out.append(ctx.finding(
                "GOL006", node,
                f"{d}: a kernel library built or loaded outside "
                "_build.py escapes obs.compile.COMPILE_LOG (no cache_miss "
                "event, so the retrace sentinel and the RunReport cannot "
                "see it) and the build cache root; go through "
                "_build.load or _build.build_variant"))
        elif not ctx.is_graph_choke_point and d in _GRAPH_CALLS:
            out.append(ctx.finding(
                "GOL006", node,
                f"{d}: CUDA-graph capture outside aot/registry.py escapes "
                "the warm-start registry's records and its aot_loaded "
                "events; serve graphs through aot.registry"))
    return out


# -- GOL008: caller-owned arrays written in place -----------------------------


@register("GOL008", "in-place-aliasing",
          "no caller-owned array alias reaches an in-place write")
def _in_place_aliasing(ctx: ModuleContext) -> Iterable[Finding]:
    """``torch.from_numpy(param)`` and ``torch.as_tensor(param)`` share
    the caller's buffer; writing one in place (directly, through a view,
    through a ``self`` attribute stored in one method and written in
    another, or as the state argument of a runner that steps in place)
    changes an array the caller still holds. ``.clone()`` and
    ``torch.tensor(x)`` copy, and stay clean."""
    return [ctx.finding("GOL008", node, msg)
            for node, msg in dataflow.in_place_alias_findings(ctx.tree)]


# -- GOL009: lock-order across obs/serve/resilience ---------------------------

_LOCK_ORDER_DIRS = ("obs/", "serve/", "resilience/")


def _in_lock_order_scope(path: str) -> bool:
    return any(f"/{d}" in path or path.startswith(d)
               for d in _LOCK_ORDER_DIRS)


@register_project("GOL009", "lock-order",
                  "the cross-class lock-acquisition graph must be acyclic")
def _lock_order(pctx: ProjectContext) -> Iterable[Finding]:
    """GOL004/007 prove each access holds *a* lock; this rule proves the
    locks compose. It builds the acquired-while-holding graph across the
    threaded subsystems (obs/, serve/, resilience/) -- nested ``with``,
    self-method calls under a lock, cross-object calls through
    constructor-typed attributes -- and flags (a) re-entering a plain
    ``threading.Lock`` (guaranteed self-deadlock), (b) cycles (deadlock
    under the right interleaving), and (c) cross-class
    acquire-while-holding, which is where future cycles come from and
    must carry a pragma explaining why the callee can never call back."""
    by_path = {}
    summaries = []
    for m in pctx.modules:
        if not _in_lock_order_scope(m.path) or m.in_tests:
            continue
        for cls in [n for n in ast.walk(m.tree)
                    if isinstance(n, ast.ClassDef)]:
            s = dataflow.summarize_class_locks(cls, m.path)
            if s.locks:
                summaries.append(s)
        by_path[m.path] = m
    if not summaries:
        return []
    graph = dataflow.LockGraph(summaries)
    out: List[Finding] = []

    def emit(path: str, node: ast.AST, msg: str) -> None:
        m = by_path.get(path)
        if m is not None:
            out.append(m.finding("GOL009", node, msg))

    for s, meth, node, desc in graph.self_deadlocks:
        emit(s.path, node,
             f"self-deadlock: {desc} -- threading.Lock is not reentrant; "
             "inline the locked body or switch to an unlocked _locked() "
             "helper")
    for cyc in graph.cycles():
        chain = " -> ".join([e.src for e in cyc] + [cyc[0].src])
        e = cyc[-1]
        emit(e.path, e.node,
             f"lock-order cycle {chain}: {e.how} closes the cycle -- two "
             "threads entering from different ends deadlock; impose one "
             "global acquisition order or drop the lock before the call")
    # a call into a lock-LEAF class (one that never calls out while
    # holding its own lock -- e.g. a pure store) cannot deadlock today;
    # flag only callees that themselves acquire-and-call, which is where
    # the next cycle comes from
    outgoing = {e.src.split(".")[0] for e in graph.edges}
    for e in graph.edges:
        if e.cross_class and e.dst.split(".")[0] in outgoing:
            emit(e.path, e.node,
                 f"cross-class acquire-while-holding: {e.how} -- if "
                 f"{e.dst.split('.')[0]} ever calls back under its lock "
                 "this deadlocks; move the call outside the lock or "
                 "pragma why the callee cannot re-enter")
    return out


# -- GOL010: metric-name discipline -------------------------------------------

_PER_CHIP_SUFFIXES = ("_per_sec", "_ratio", "_fraction", "_duty_cycle")


@register_project("GOL010", "metric-discipline",
                  "metric names follow the registry/aggregation contract")
def _metric_discipline(pctx: ProjectContext) -> Iterable[Finding]:
    """Today these contracts only fail in production: a counter without
    ``_total`` breaks the PromQL conventions the dashboards assume, a
    per-chip gauge missing from PER_CHIP_GAUGES gets silently summed
    across the fleet (the exact bug PerChipSumError exists to refuse),
    and a name declared as both gauge and histogram raises at import
    time on whichever process loads both modules. All three are visible
    in the AST. Tests are exempt (throwaway metric names are the point
    there); the per-chip membership check only runs when
    obs/aggregate.py is part of the scanned tree."""
    decls: List[dataflow.MetricDecl] = []
    by_path = {m.path: m for m in pctx.modules}
    for m in pctx.modules:
        if m.in_tests:
            continue
        decls.extend(dataflow.collect_metric_decls(m.tree, m.path))
    out: List[Finding] = []

    def emit(d: dataflow.MetricDecl, msg: str) -> None:
        m = by_path.get(d.path)
        if m is not None:
            out.append(m.finding("GOL010", d.node, msg))

    per_chip: Optional[Set[str]] = None
    agg = pctx.module("obs/aggregate.py")
    if agg is not None:
        per_chip = dataflow.per_chip_gauge_names(agg.tree)

    for d in decls:
        if d.kind == "counter" and not d.name.endswith("_total"):
            emit(d, f"counter '{d.name}' does not end in '_total': the "
                    "fleet plane and dashboards key on the Prometheus "
                    "counter convention -- rename, or pragma why this "
                    "series name is frozen")
        if d.kind == "gauge" and per_chip is not None \
                and d.name not in per_chip \
                and (d.name.startswith("hbm_")
                     or d.name.endswith(_PER_CHIP_SUFFIXES)):
            emit(d, f"per-chip-shaped gauge '{d.name}' is not listed in "
                    "obs/aggregate.py PER_CHIP_GAUGES: fleet aggregation "
                    "would sum it across chips into a meaningless number "
                    "-- add it to the set (or pragma why summing is "
                    "correct here)")

    kinds: Dict[str, dataflow.MetricDecl] = {}
    flagged: Set[Tuple[str, str]] = set()
    for d in decls:
        first = kinds.setdefault(d.name, d)
        if first.kind != d.kind and (d.name, d.path) not in flagged:
            flagged.add((d.name, d.path))
            emit(d, f"metric '{d.name}' declared as {d.kind} here but as "
                    f"{first.kind} in {first.path}: "
                    "MetricsRegistry raises on the kind conflict at "
                    "runtime -- rename one of them")
    return out
