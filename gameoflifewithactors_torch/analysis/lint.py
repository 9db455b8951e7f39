"""goltpu-lint engine for the port: AST rules, pragmas, baseline -- stdlib
only.

Counterpart of ``gameoflifewithactors_tpu.analysis.lint``, nearly
verbatim: the same registry, pragmas, baseline and reports, with the
rules of :mod:`.rules` restated for PyTorch. The telemetry of
:mod:`..obs` *reports* the failure classes that cost card time (a host
sync in a step loop, a kernel built outside the build cache, a lock slip
in a recorder) after they happen; this module machine-checks the
invariants that prevent them, over the package's own source. Importing
it touches neither torch nor jax nor numpy.

Three layers:

- **Rule registry** -- rules register under a stable ``GOLxxx`` code via
  :func:`register`; each is a callable ``(ModuleContext) -> [Finding]``.
  *Project* rules (:func:`register_project`) see every parsed module at
  once -- ``(ProjectContext) -> [Finding]`` -- for cross-file invariants
  like lock ordering (GOL009) and metric-name discipline (GOL010).
  The codes are API: pragmas and baselines reference them, so a rule may
  be retired but its code never reused.
- **Pragmas** -- ``# goltpu: ignore[GOL001] -- reason`` suppresses
  matching findings on its own line or the line directly below a
  standalone pragma comment. The reason is mandatory: a suppression
  without a written justification is itself a finding (GOL000).
- **Baseline** -- a JSON file of grandfathered findings (matched by
  ``(code, path, message)`` so line drift does not invalidate it). The
  port's is ``lint_baseline.json`` beside this module; it ships empty.

The CLI (exit 0 clean, 1 unsuppressed findings, 2 bad input)::

    python -m gameoflifewithactors_torch.analysis.lint [paths] [--json]
        [--sarif F] [--baseline F] [--write-baseline] [--strict-baseline]

With no paths it lints the package, ``chip_smoke.py`` and
``tests/test_torch_*.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

BASELINE_VERSION = 1

# the engine's own code: pragma/baseline bookkeeping problems. Not a
# registered rule -- it cannot be pragma-suppressed (fix the pragma).
PRAGMA_ERROR_CODE = "GOL000"

_PRAGMA_RE = re.compile(
    r"#\s*goltpu:\s*ignore\[(?P<codes>[^\]]*)\]"
    r"(?:\s*--\s*(?P<reason>.*\S))?")
_CODE_RE = re.compile(r"^GOL\d{3}$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    code: str
    path: str          # as handed to the engine (relative paths keep the
                       # baseline portable across checkouts)
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers drift with unrelated edits, so
        grandfathering matches on (code, path, message)."""
        return (self.code, self.path, self.message)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: " \
               f"{self.code} {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str
    check: Callable[["ModuleContext"], Iterable[Finding]]


RULES: Dict[str, Rule] = {}

# the modules whose runner factories return step loops (GOL001-003)
STEP_LOOP_DIRS = ("ops/", "memory/")
STEP_LOOP_FILES = ("parallel/sharded.py", "parallel/batched.py")

# cross-file rules: ``check`` takes a ProjectContext (every parsed module
# in the run) instead of one ModuleContext. Same code space as RULES --
# pragmas and baselines cannot tell the layers apart, by design.
PROJECT_RULES: Dict[str, Rule] = {}


def register(code: str, name: str, summary: str):
    """Decorator: file a rule under ``code`` (stable, never reused)."""
    if not _CODE_RE.match(code):
        raise ValueError(f"rule code must match GOLnnn, got {code!r}")

    def deco(fn):
        if code in RULES or code in PROJECT_RULES:
            raise ValueError(f"duplicate rule code {code}")
        RULES[code] = Rule(code=code, name=name, summary=summary, check=fn)
        return fn

    return deco


def register_project(code: str, name: str, summary: str):
    """Decorator: file a *project-level* rule -- its check runs once per
    lint run over a :class:`ProjectContext` and may emit findings against
    any scanned file (per-file pragmas still suppress them)."""
    if not _CODE_RE.match(code):
        raise ValueError(f"rule code must match GOLnnn, got {code!r}")

    def deco(fn):
        if code in RULES or code in PROJECT_RULES:
            raise ValueError(f"duplicate rule code {code}")
        PROJECT_RULES[code] = Rule(code=code, name=name, summary=summary,
                                   check=fn)
        return fn

    return deco


@dataclasses.dataclass
class ModuleContext:
    """Everything a rule may look at for one source file."""

    path: str                 # reporting path (normalized, '/'-separated)
    source: str
    tree: ast.Module
    in_obs: bool              # under the obs/ subpackage (lock rules)
    is_build_choke_point: bool   # _build.py: builds and loads libraries
    is_graph_choke_point: bool   # aot/registry.py: captures CUDA graphs
    in_step_modules: bool     # ops/, memory/, parallel/{sharded,batched}.py
    in_tests: bool

    @classmethod
    def from_source(cls, source: str, path: str) -> "ModuleContext":
        norm = path.replace(os.sep, "/")
        return cls(
            path=norm,
            source=source,
            tree=ast.parse(source, filename=path),
            in_obs="/obs/" in norm or norm.startswith("obs/"),
            is_build_choke_point=norm == "_build.py"
            or norm.endswith("/_build.py"),
            is_graph_choke_point=norm.endswith("aot/registry.py"),
            in_step_modules=any(
                f"/{d}" in norm or norm.startswith(d)
                for d in STEP_LOOP_DIRS) or norm.endswith(STEP_LOOP_FILES),
            in_tests="/tests/" in norm or norm.startswith("tests/"),
        )

    def finding(self, code: str, node: ast.AST, message: str) -> Finding:
        return Finding(code=code, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message)


@dataclasses.dataclass
class ProjectContext:
    """What a project-level rule may look at: every module that parsed,
    in scan order. Findings are emitted via the owning module's
    :meth:`ModuleContext.finding` so pragma suppression keeps working."""

    modules: List[ModuleContext]

    def module(self, path_suffix: str) -> Optional[ModuleContext]:
        """First scanned module whose path ends with ``path_suffix``
        (e.g. ``"obs/aggregate.py"``), or None if it was not scanned --
        rules use this to gate sub-checks that need a specific anchor
        file rather than guessing from a partial tree."""
        for m in self.modules:
            if m.path.endswith(path_suffix):
                return m
        return None


# -- pragmas ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pragma:
    line: int                 # 1-based line the comment sits on
    codes: Tuple[str, ...]
    reason: Optional[str]
    standalone: bool          # comment-only line: applies to the next line


def parse_pragmas(source: str) -> List[Pragma]:
    """Pragmas live in COMMENT tokens only -- a regex over raw lines would
    also match the pragma syntax quoted inside string literals (this
    module's own docstrings being exhibit A)."""
    import io
    import tokenize

    out = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return out  # the ast parse decides whether the file is bad input
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if not m:
            continue
        codes = tuple(c.strip() for c in m.group("codes").split(",")
                      if c.strip())
        out.append(Pragma(
            line=tok.start[0], codes=codes, reason=m.group("reason"),
            standalone=tok.line[:tok.start[1]].strip() == ""))
    return out


def _pragma_errors(pragmas: List[Pragma], path: str) -> List[Finding]:
    errs = []
    for p in pragmas:
        bad = [c for c in p.codes if not _CODE_RE.match(c)]
        if bad or not p.codes:
            errs.append(Finding(
                code=PRAGMA_ERROR_CODE, path=path, line=p.line, col=0,
                message="malformed pragma: expected "
                        "'# goltpu: ignore[GOLnnn] -- reason'"
                        + (f" (bad code(s): {', '.join(bad)})" if bad
                           else " (no codes)")))
        if p.reason is None:
            errs.append(Finding(
                code=PRAGMA_ERROR_CODE, path=path, line=p.line, col=0,
                message="pragma without a reason: every suppression must "
                        "say why ('-- <reason>')"))
    return errs


def _suppressed_by(finding: Finding, by_line: Dict[int, List[Pragma]]) -> bool:
    """A well-formed pragma suppresses findings on its own line, and -- when
    it is a standalone comment line -- on the line directly below."""
    candidates = list(by_line.get(finding.line, []))
    candidates += [p for p in by_line.get(finding.line - 1, [])
                   if p.standalone]
    return any(finding.code in p.codes and p.reason is not None
               and all(_CODE_RE.match(c) for c in p.codes)
               for p in candidates)


# -- baseline -----------------------------------------------------------------


def load_baseline(path: str) -> List[dict]:
    """Parse a baseline file; raises BaselineError on malformed input
    (the CLI maps that to exit 2: a broken baseline silently
    grandfathering nothing, or everything, is worse than failing)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != BASELINE_VERSION:
        raise BaselineError(
            f"{path}: expected {{'version': {BASELINE_VERSION}, "
            "'findings': [...]}")
    entries = data.get("findings")
    if not isinstance(entries, list) or not all(
            isinstance(e, dict) and {"code", "path", "message"} <= set(e)
            for e in entries):
        raise BaselineError(
            f"{path}: each finding needs code/path/message keys")
    return entries


def baseline_payload(findings: Iterable[Finding]) -> dict:
    """What ``--write-baseline`` writes: current findings
    as grandfathered entries (sorted, line recorded for humans only)."""
    return {
        "version": BASELINE_VERSION,
        "findings": [f.to_dict() for f in sorted(
            findings, key=lambda f: (f.path, f.line, f.code))],
    }


class BaselineError(ValueError):
    """Unusable baseline file (CLI exit 2)."""


# -- the engine ---------------------------------------------------------------


@dataclasses.dataclass
class FileReport:
    path: str
    findings: List[Finding]            # unsuppressed (pre-baseline)
    suppressed: List[Finding]          # pragma'd out
    error: Optional[str] = None        # unreadable / unparseable


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]            # after pragmas AND baseline
    suppressed: List[Finding]          # by pragma
    baselined: List[Finding]           # grandfathered
    unused_baseline: List[dict]        # stale grandfather entries
    files: List[FileReport]
    errors: List[str]                  # bad-input problems (CLI exit 2)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "baselined": [f.to_dict() for f in self.baselined],
            "unused_baseline": list(self.unused_baseline),
            "errors": list(self.errors),
            "files_scanned": len([r for r in self.files if r.error is None]),
        }


def _lint_file(source: str, path: str, rules: Dict[str, Rule]):
    """Per-file pass. Returns (FileReport, ModuleContext | None, by_line
    pragma map) -- the context and pragma map feed the project-rule pass,
    which must route its findings through the same suppression."""
    try:
        ctx = ModuleContext.from_source(source, path)
    except SyntaxError as exc:
        return (FileReport(path=path, findings=[], suppressed=[],
                           error=f"{path}: not parseable as Python: {exc}"),
                None, {})
    pragmas = parse_pragmas(source)
    by_line: Dict[int, List[Pragma]] = {}
    for p in pragmas:
        by_line.setdefault(p.line, []).append(p)
    raw: List[Finding] = list(_pragma_errors(pragmas, ctx.path))
    for rule in rules.values():
        raw.extend(rule.check(ctx))
    findings, suppressed = [], []
    for f in sorted(raw, key=lambda f: (f.line, f.col, f.code)):
        if f.code != PRAGMA_ERROR_CODE and _suppressed_by(f, by_line):
            suppressed.append(f)
        else:
            findings.append(f)
    return (FileReport(path=ctx.path, findings=findings,
                       suppressed=suppressed), ctx, by_line)


def lint_source(source: str, path: str,
                rules: Optional[Dict[str, Rule]] = None) -> FileReport:
    """Lint one file's source with the per-file rules. SyntaxError
    surfaces as FileReport.error (bad input), never as an exception --
    the CLI keeps scanning. Project rules need the whole run's modules
    and so only fire from lint_paths/lint_sources."""
    return _lint_file(source, path, RULES if rules is None else rules)[0]


def _apply_project_rules(reports_by_path, ctxs, by_lines,
                         project_rules: Optional[Dict[str, Rule]]) -> None:
    """Run the cross-file rules and fold their findings into the owning
    FileReports, honoring that file's pragmas."""
    prules = PROJECT_RULES if project_rules is None else project_rules
    if not ctxs or not prules:
        return
    pctx = ProjectContext(modules=list(ctxs))
    for rule in prules.values():
        for f in rule.check(pctx):
            rep = reports_by_path.get(f.path)
            if rep is None or rep.error is not None:
                continue  # rules only emit against scanned modules
            if _suppressed_by(f, by_lines.get(f.path, {})):
                rep.suppressed.append(f)
            else:
                rep.findings.append(f)
    for rep in reports_by_path.values():
        rep.findings.sort(key=lambda f: (f.line, f.col, f.code))
        rep.suppressed.sort(key=lambda f: (f.line, f.col, f.code))


def iter_python_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for name in sorted(names):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def _aggregate(reports: List[FileReport], errors: List[str],
               baseline: Optional[List[dict]]) -> LintResult:
    baseline_keys = {(e["code"], e["path"], e["message"])
                     for e in (baseline or [])}
    matched_keys = set()
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    for rep in reports:
        if rep.error:
            errors.append(rep.error)
            continue
        suppressed.extend(rep.suppressed)
        for f in rep.findings:
            if f.key() in baseline_keys:
                matched_keys.add(f.key())
                baselined.append(f)
            else:
                findings.append(f)
    unused = [e for e in (baseline or [])
              if (e["code"], e["path"], e["message"]) not in matched_keys]
    return LintResult(findings=findings, suppressed=suppressed,
                      baselined=baselined, unused_baseline=unused,
                      files=reports, errors=errors)


def _run_lint(files, pre_errors: List[str],
              baseline: Optional[List[dict]],
              rules: Optional[Dict[str, Rule]],
              project_rules: Optional[Dict[str, Rule]]) -> LintResult:
    """Shared core: ``files`` is [(path, source | None, error | None)] --
    per-file rules, then project rules, then the baseline."""
    per_file = RULES if rules is None else rules
    reports: List[FileReport] = []
    reports_by_path: Dict[str, FileReport] = {}
    ctxs: List[ModuleContext] = []
    by_lines: Dict[str, Dict[int, List[Pragma]]] = {}
    for path, source, error in files:
        if error is not None:
            rep = FileReport(path=path, findings=[], suppressed=[],
                             error=error)
        else:
            rep, ctx, by_line = _lint_file(source, path, per_file)
            if ctx is not None:
                ctxs.append(ctx)
                by_lines[ctx.path] = by_line
        reports.append(rep)
        reports_by_path[rep.path] = rep
    _apply_project_rules(reports_by_path, ctxs, by_lines, project_rules)
    return _aggregate(reports, list(pre_errors), baseline)


def lint_sources(sources: Dict[str, str], *,
                 baseline: Optional[List[dict]] = None,
                 rules: Optional[Dict[str, Rule]] = None,
                 project_rules: Optional[Dict[str, Rule]] = None
                 ) -> LintResult:
    """Lint an in-memory {path: source} set as one run -- the project
    rules see all of them together. This is how cross-file rule fixtures
    are pinned without touching disk."""
    return _run_lint([(p, s, None) for p, s in sources.items()],
                     [], baseline, rules, project_rules)


def lint_paths(paths: Iterable[str], *,
               baseline: Optional[List[dict]] = None,
               rules: Optional[Dict[str, Rule]] = None,
               project_rules: Optional[Dict[str, Rule]] = None
               ) -> LintResult:
    """Lint files/trees; run per-file then project rules; apply the
    baseline; aggregate."""
    files = []
    errors: List[str] = []
    seen = set()
    any_path = False
    for path in paths:
        any_path = True
        if not os.path.exists(path):
            errors.append(f"{path}: no such file or directory")
            continue
        for fp in iter_python_files([path]):
            if fp in seen:
                continue
            seen.add(fp)
            try:
                with open(fp, encoding="utf-8") as f:
                    src = f.read()
            except OSError as exc:
                files.append((fp, None, f"{fp}: {exc}"))
                continue
            files.append((fp, src, None))
    if not any_path:
        errors.append("no paths given")
    return _run_lint(files, errors, baseline, rules, project_rules)


# -- the CLI ------------------------------------------------------------------

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PACKAGE)
DEFAULT_BASELINE = os.path.join(_PACKAGE, "analysis", "lint_baseline.json")


def default_paths() -> List[str]:
    """The port's tree, repo-relative: the package, ``chip_smoke.py`` and
    the port's tests."""
    import glob

    out = [os.path.basename(_PACKAGE)]
    if os.path.exists(os.path.join(_REPO, "chip_smoke.py")):
        out.append("chip_smoke.py")
    out += sorted(os.path.relpath(p, _REPO) for p in glob.glob(
        os.path.join(_REPO, "tests", "test_torch_*.py")))
    return out


def sarif_payload(result: LintResult) -> dict:
    """A minimal SARIF 2.1.0 document: one run, the rule registry in the
    tool descriptor, one result per unsuppressed finding."""
    registry = dict(RULES)
    registry.update(PROJECT_RULES)
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "goltpu-lint",
                "rules": [
                    {"id": code, "name": rule.name,
                     "shortDescription": {"text": rule.summary}}
                    for code, rule in sorted(registry.items())],
            }},
            "results": [
                {"ruleId": f.code, "level": "error",
                 "message": {"text": f.message},
                 "locations": [{"physicalLocation": {
                     "artifactLocation": {
                         "uri": f.path.replace(os.sep, "/")},
                     "region": {"startLine": f.line,
                                "startColumn": f.col + 1}}}]}
                for f in result.findings],
        }],
    }


def main(argv: Optional[List[str]] = None) -> int:
    """The CLI: 0 clean, 1 unsuppressed findings (or stale baseline
    entries with ``--strict-baseline``), 2 bad input (a missing path, an
    unparseable file, a broken baseline)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m gameoflifewithactors_torch.analysis.lint",
        description="static analysis of the PyTorch/CUDA port (rules "
                    "GOL001-GOL010; README 'Static analysis, sanitizers "
                    "and the contract gate of the port')")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: the package, "
                         "chip_smoke.py and tests/test_torch_*.py)")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="grandfathered-findings file (default: "
                         "analysis/lint_baseline.json; 'none' disables)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings into the baseline "
                         "file and exit 0")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object instead of text")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="stale (unmatched) baseline entries fail the run")
    ap.add_argument("--sarif", metavar="OUT.json", default=None,
                    help="also write the findings as SARIF 2.1.0")
    args = ap.parse_args(argv)

    baseline_path = args.baseline or DEFAULT_BASELINE
    baseline = None
    if baseline_path != "none" and not (
            args.write_baseline and not os.path.exists(baseline_path)):
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, json.JSONDecodeError, BaselineError) as exc:
            print(f"goltpu-lint: unusable baseline: {exc}", file=sys.stderr)
            return 2

    # default paths are repo-relative, so finding paths (and baseline
    # keys) read alike from any working directory
    paths = args.paths
    if not paths:
        paths = [os.path.relpath(os.path.join(_REPO, p))
                 for p in default_paths()]
    result = lint_paths(paths, baseline=baseline)

    if args.sarif:
        with open(args.sarif, "w") as f:
            json.dump(sarif_payload(result), f, indent=1)
            f.write("\n")
    if args.write_baseline:
        payload = baseline_payload(result.findings + result.baselined)
        with open(baseline_path, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        print(f"goltpu-lint: wrote {len(payload['findings'])} "
              f"grandfathered finding(s) to {baseline_path}")
        return 0 if not result.errors else 2

    stale_fails = args.strict_baseline and result.unused_baseline
    code = 2 if result.errors else 1 if result.findings or stale_fails else 0
    if args.json:
        doc = result.to_dict()
        doc["exit_code"] = code
        print(json.dumps(doc, indent=1))
    else:
        for f in result.findings:
            print(f.format())
        for err in result.errors:
            print(f"goltpu-lint: error: {err}", file=sys.stderr)
        for e in result.unused_baseline:
            print(f"goltpu-lint: stale baseline entry (fixed? remove it): "
                  f"{e.get('path')}: {e.get('code')} {e.get('message')}",
                  file=sys.stderr)
        n_files = len([r for r in result.files if r.error is None])
        print(f"goltpu-lint: {n_files} file(s), {len(result.findings)} "
              f"finding(s), {len(result.suppressed)} suppressed by pragma, "
              f"{len(result.baselined)} baselined", file=sys.stderr)
    return code


# registering the built-in rules populates RULES as a side effect; the
# import sits at the bottom so rules.py can import the registry above
from . import rules as _rules  # noqa: E402,F401  (registration import)


if __name__ == "__main__":
    # run as ``-m``, this file is ``__main__``: the rules registered into
    # the package's module of the same name, so run that one's main
    from gameoflifewithactors_torch.analysis.lint import main as _main

    raise SystemExit(_main())
