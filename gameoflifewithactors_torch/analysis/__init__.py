"""goltpu-lint for the port: static analysis, runtime sanitizers and the
runner contract gate.

Counterpart of ``gameoflifewithactors_tpu.analysis``. Three parts with one
job -- *prevent* the failure classes that obs/ can only report: host syncs
hidden in a dispatch loop, kernels built outside the build cache, runners
that write the caller's tensors, lock slips in the telemetry recorders.

- :mod:`.lint` / :mod:`.rules` / :mod:`.dataflow` -- the AST engine and
  the GOL001-GOL010 rules, restated for PyTorch (``python -m
  gameoflifewithactors_torch.analysis.lint``). Standard library only.
- :mod:`.sanitizers` -- ``GOLTPU_SANITIZE=1`` runtime checks: the
  transfer guard around the engine's dispatch (``torch.cuda``'s sync
  debug mode, with declared allow scopes at every sanctioned readback)
  and the retrace budget over the kernel builds.
- :mod:`.contracts` -- each registered runner (``ops/_builders.py``) run
  under ``torch.profiler`` and held to its host syncs, in-place writes,
  halo bytes, gathers and kernel launches (``python -m
  gameoflifewithactors_torch.analysis.contracts``).
"""

from .sanitizers import (  # noqa: F401
    ENV_SANITIZE,
    RetraceError,
    RetraceSentinel,
    allow_host_transfers,
    no_implicit_host_transfers,
    retrace_budget,
)

_LINT_NAMES = ("Finding", "LintResult", "RULES", "lint_paths", "lint_source")


def __getattr__(name):
    """The lint engine and the contract gate load on first use: the
    engine imports this package for its sanitizers alone, and ``python -m
    ...analysis.lint`` / ``...analysis.contracts`` must find their module
    not yet imported."""
    import importlib

    if name in _LINT_NAMES:
        return getattr(importlib.import_module(".lint", __name__), name)
    if name == "contracts":
        return importlib.import_module(".contracts", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Finding", "LintResult", "RULES", "lint_paths", "lint_source",
    "ENV_SANITIZE", "RetraceError", "RetraceSentinel",
    "allow_host_transfers", "no_implicit_host_transfers",
    "retrace_budget", "contracts",
]
