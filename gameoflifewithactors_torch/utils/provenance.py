"""Version provenance for persisted performance evidence.

A copy of ``gameoflifewithactors_tpu.utils.provenance`` (stdlib and a
``git`` subprocess), pointed at this repository and this package's files.
A persisted measurement served after the measured code path was
rewritten silently reports numbers for code that no longer exists. Every
persisted record therefore carries the git commit of the tree it
measured, and consumers (``obs.diff.record_staleness``, the ``report
--diff`` subcommand) call :func:`staleness` to learn whether the record's
measured paths changed since that stamp.

- :data:`BACKEND_PATHS` -- the measured file set of each engine backend,
  the fallback for records that carry none of their own.
- New records carry a ``measured_paths`` field stamped at capture time
  (:func:`head_stamp`), which :func:`staleness` prefers over the in-code
  map.
- The timing protocol (the bench's ``bench/run.py`` and
  ``bench/timing.py``) is part of each backend's measured set, and the
  whole bench package of the conservative superset: an edit to it flags
  the records it produced, not just kernel edits.

*Comment-only* edits do not stale: when git reports a measured ``.py``
file changed, :func:`staleness` compares the token stream (comments and
blank lines dropped) at the stamp vs the working tree, and certifies the
record fresh when the executable code is identical. Docstrings are
STRING tokens and still count as code -- only ``#`` comments are exempt.

Degrades to "unknown provenance" (which consumers treat as stale) when
git is unavailable or the repo is absent -- evidence must never look
*fresher* than it can be proven to be.
"""

from __future__ import annotations

import io
import os
import subprocess
import tokenize

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PKG = "gameoflifewithactors_torch"
# Shared substrate: the Topology / shift plumbing and the bit-packing
# layout feed every measured op; the engine picks and drives the runner.
_CORE = [f"{_PKG}/ops/stencil.py", f"{_PKG}/ops/bitpack.py",
         f"{_PKG}/engine.py"]
_RULES = [f"{_PKG}/models/rules.py", f"{_PKG}/models/generations.py",
          f"{_PKG}/models/ltl.py"]
_MESHY = [f"{_PKG}/parallel/sharded.py", f"{_PKG}/parallel/halo.py",
          f"{_PKG}/parallel/mesh.py"]
_PROTOCOL = f"{_PKG}/bench"
# the files of the protocol every bench record was timed by
_TIMING = [f"{_PROTOCOL}/run.py", f"{_PROTOCOL}/timing.py"]

# The measured code path per engine backend: if any of these files
# changed after a record's commit stamp, the record describes a
# predecessor and must be flagged.
BACKEND_PATHS = {
    "cuda": [f"{_PKG}/ops/cuda_stencil.py", f"{_PKG}/csrc", f"{_PKG}/_build.py",
             *_CORE, *_RULES, *_MESHY, *_TIMING],
    "packed": [f"{_PKG}/ops/packed.py", f"{_PKG}/ops/packed_generations.py",
               f"{_PKG}/ops/packed_ltl.py", *_CORE, *_RULES, *_MESHY,
               *_TIMING],
    "dense": [f"{_PKG}/ops/generations.py", f"{_PKG}/ops/ltl.py",
              *_CORE, *_RULES, *_MESHY, *_TIMING],
    "sparse": [f"{_PKG}/ops/sparse.py", f"{_PKG}/ops/packed.py",
               *_CORE, *_RULES, *_MESHY, f"{_PKG}/models/seeds.py",
               *_TIMING],
    "paged": [f"{_PKG}/memory", f"{_PKG}/ops/sparse.py",
              f"{_PKG}/ops/packed.py", *_CORE, *_RULES, *_TIMING],
}
# Fallback when the backend can't be parsed out of a record: everything.
ALL_OPS_PATHS = [f"{_PKG}/ops", f"{_PKG}/csrc", f"{_PKG}/parallel",
                 f"{_PKG}/models", f"{_PKG}/memory", f"{_PKG}/engine.py",
                 _PROTOCOL]


def repo_root() -> str:
    """Absolute path of the repository this package lives in — where the
    persisted evidence (results/) is found."""
    return _REPO


def _git(*args: str, repo: str | None = None) -> str | None:
    try:
        r = subprocess.run(["git", *args], cwd=repo or _REPO,
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout if r.returncode == 0 else None


def git_head(repo: str | None = None) -> str | None:
    """Short hash of HEAD, or None when unknowable."""
    out = _git("rev-parse", "--short", "HEAD", repo=repo)
    return out.strip() if out is not None else None


def changed_since(commit: str, paths: list[str], repo: str | None = None) -> list[str] | None:
    """Files under ``paths`` changed in ``commit..HEAD`` (committed changes),
    plus any with uncommitted modifications now. None = cannot determine."""
    log = _git("log", "--name-only", "--format=", f"{commit}..HEAD", "--", *paths,
               repo=repo)
    if log is None:
        return None
    dirty = _git("status", "--porcelain", "--", *paths, repo=repo)
    if dirty is None:
        # can't tell whether the tree is dirty -> can't certify freshness
        return None
    files = {ln.strip() for ln in log.splitlines() if ln.strip()}
    files |= {ln[3:].strip() for ln in dirty.splitlines() if ln.strip()}
    return sorted(files)


_EQUIV_CACHE: dict[tuple, bool] = {}


def _code_tokens(src: str) -> list[tuple[int, str]] | None:
    """Token stream with comments and non-logical newlines dropped; None
    when the source doesn't tokenize (treat as not-comparable)."""
    try:
        return [(t.type, t.string)
                for t in tokenize.generate_tokens(io.StringIO(src).readline)
                if t.type not in (tokenize.COMMENT, tokenize.NL)]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return None


def code_equivalent(commit: str, path: str, repo: str | None = None) -> bool:
    """True when ``path``'s executable code is identical between ``commit``
    and the working tree — i.e. every difference git sees is a ``#`` comment
    or blank line. Only certifies ``.py`` files; anything else (or a file
    that fails to read/tokenize on either side) counts as really changed.

    Memoized: the report loop asks the same question once per record
    sharing a changed file, and each miss costs a ``git show`` subprocess
    plus two tokenizations. The commit side is immutable; the working-tree
    side is keyed by the file's (mtime_ns, size) so an edit mid-process
    invalidates the entry instead of serving the pre-edit answer."""
    try:
        st = os.stat(os.path.join(repo or _REPO, path))
        tree_key = (st.st_mtime_ns, st.st_size)
    except OSError:
        tree_key = None
    key = (commit, path, repo, tree_key)
    if key not in _EQUIV_CACHE:
        _EQUIV_CACHE[key] = _code_equivalent_uncached(commit, path, repo)
    return _EQUIV_CACHE[key]


def _code_equivalent_uncached(commit: str, path: str, repo: str | None) -> bool:
    if not path.endswith(".py"):
        return False
    old = _git("show", f"{commit}:{path}", repo=repo)
    if old is None:
        return False
    try:
        with open(os.path.join(repo or _REPO, path)) as f:
            new = f.read()
    except OSError:
        return False
    old_t, new_t = _code_tokens(old), _code_tokens(new)
    return old_t is not None and old_t == new_t


def explicit_record_paths(record: dict) -> list[str] | None:
    """The measured file set a record can *specifically* claim, most
    specific source first: its own capture-time ``measured_paths``, the
    metric-named backend's set. None when only the conservative superset
    would apply -- callers embedding a set into a new record must not
    embed the superset (that would lock coarseness into the record and
    defeat later precision fixes)."""
    own = record.get("measured_paths")
    if isinstance(own, list) and own:
        return own
    metric = record.get("metric", "")
    if "(" in metric:  # "... (cuda, 50% soup, gpu)" names the resolved backend
        backend = metric.rsplit("(", 1)[1].split(",")[0].strip()
        if backend in BACKEND_PATHS:
            return BACKEND_PATHS[backend]
    return None


def record_paths(record: dict) -> list[str]:
    """Like :func:`explicit_record_paths` but falling back to the
    conservative everything-superset for staleness checking."""
    return explicit_record_paths(record) or ALL_OPS_PATHS


def head_stamp(paths: list[str] | None = None, repo: str | None = None) -> dict:
    """Provenance stamp for a measurement taken NOW: ``{"commit": <head>}``,
    plus ``"commit_dirty": True`` when the measured paths have uncommitted
    edits (or dirtiness can't be determined) — a dirty-tree measurement ran
    code that exists at no commit, so it must never get clean provenance.
    When ``paths`` is given the stamp also embeds it as ``measured_paths``
    so the record self-describes what it measured."""
    stamp: dict = {"commit": git_head(repo=repo)}
    dirty = _git("status", "--porcelain", "--", *(paths or ALL_OPS_PATHS), repo=repo)
    if dirty is None:
        stamp["commit_dirty"] = True
    elif dirty.strip():
        # comment-only uncommitted edits (e.g. a freeze notice awaiting its
        # commit) don't brand the capture dirty: the executable code IS the
        # stamped commit's, provable via the same token comparison
        # staleness() uses. Untracked files and non-.py edits fail the
        # equivalence check and keep the dirty brand.
        dirty_files = [ln[3:].strip() for ln in dirty.splitlines() if ln.strip()]
        head = stamp["commit"]
        if not head or not all(code_equivalent(head, f, repo=repo)
                               for f in dirty_files):
            stamp["commit_dirty"] = True
    if paths:
        stamp["measured_paths"] = list(paths)
    return stamp


def staleness(record: dict, repo: str | None = None) -> dict:
    """Classify a persisted measurement record's provenance.

    Returns ``{"stale": bool, "reason": str}`` — ``stale`` is True when the
    record has no commit stamp, the stamp can't be checked, or the measured
    code (see :func:`record_paths`) changed since the stamp. Comment-only
    edits to measured ``.py`` files do not stale.
    """
    commit = record.get("commit")
    if not commit:
        return {"stale": True, "reason": "record has no commit stamp"}
    if record.get("commit_dirty"):
        return {"stale": True,
                "reason": f"measured tree had uncommitted changes at record time ({commit})"}
    if record.get("commit_approx"):
        # hand-backfilled stamp: the true measured tree is a guess, so the
        # record can never be certified fresh even if paths look unchanged
        return {"stale": True,
                "reason": f"commit stamp {commit} is approximate (backfilled), "
                          "cannot certify the measured tree"}
    paths = record_paths(record)
    changed = changed_since(commit, paths, repo=repo)
    if changed is None:
        return {"stale": True, "reason": f"cannot verify commit {commit} (git unavailable)"}
    benign, really = [], []
    for f in changed:
        if code_equivalent(commit, f, repo=repo):
            benign.append(f"{f} (comment-only)")
            continue
        really.append(f)
    if really:
        return {"stale": True,
                "reason": f"measured paths changed since {commit}: {', '.join(really[:4])}"
                          + (f" (+{len(really) - 4} more)" if len(really) > 4 else "")}
    if benign:
        return {"stale": False,
                "reason": f"measured code unchanged since {commit} "
                          f"(benign edits: {', '.join(benign[:4])})"}
    return {"stale": False, "reason": f"measured paths unchanged since {commit}"}
