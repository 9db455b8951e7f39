"""The runner registry of the contract gate, and the in-place declaration.

Counterpart of the registry half of ``gameoflifewithactors_tpu.ops._jit``
(``BuiltRunner``, ``BuilderSpec``, ``BUILDERS``, ``register_builder``);
its jit half has no counterpart, since torch has no trace to compile.
Every runner family registers a zero-arg factory here under the JAX
package's name; :mod:`..analysis.contracts` builds each one, runs it on
its example under ``torch.profiler`` and holds it to the contracts the
:class:`BuiltRunner` states. Registration is a dict insert: meshes,
grids and kernels are built only when the gate calls the factory.

:func:`steps_in_place` is the caller-visible opt-in that donation was in
JAX: a runner that writes its state argument (or the state it returned
last) in place says so, and lint rule GOL003 holds every other runner to
returning new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple


def steps_in_place(run: Callable) -> Callable:
    """Declare that ``run`` writes its state argument in place (the
    caller's tensor changes under it). Sets ``run.in_place``."""
    run.in_place = True
    return run


@dataclasses.dataclass
class BuiltRunner:
    """What a contract factory returns: the runner, the example to call
    it on, and the contracts to hold it to.

    - ``runner(*example_args)`` is one call; the gate calls it once to
      warm (kernel builds, caches), then once more on the first call's
      result (``chain`` maps the result to the next call's arguments), and
      measures that call.
    - ``in_place`` -- whether the measured call writes its arguments
      (default: ``runner.in_place``, set by :func:`steps_in_place`).
    - ``host_syncs`` / ``host_sync_reason`` -- the declared budget of
      host syncs in one call (0 unless a reason says why).
    - ``expected_halo_bytes`` -- the closed-form halo bytes of one call
      (``ghost_exchange_bytes``, ``deep_exchange_bytes``), a hard contract;
      None pins the measured bytes instead.
    - ``require_gather`` -- the call must index or gather (the paged
      runner resolves its neighbours through the page table).
    - ``kernel`` / ``launches`` -- a ``cuda`` runner's kernel (the launch
      counter's name in ``ops.cuda_stencil``) and the launches one call
      makes; it launches no other kernel.
    """

    runner: Callable
    example_args: tuple
    chain: Optional[Callable] = None
    in_place: Optional[bool] = None
    host_syncs: int = 0
    host_sync_reason: str = ""
    expected_halo_bytes: Optional[int] = None
    halo_model: str = ""
    require_gather: bool = False
    kernel: Optional[str] = None
    launches: Optional[int] = None

    def __post_init__(self):
        if self.in_place is None:
            self.in_place = bool(getattr(self.runner, "in_place", False))
        if self.host_syncs and not self.host_sync_reason:
            raise ValueError("a host-sync budget needs a reason")


@dataclasses.dataclass(frozen=True)
class BuilderSpec:
    name: str
    factory: Callable[[], BuiltRunner]
    tags: Tuple[str, ...] = ()


BUILDERS: Dict[str, BuilderSpec] = {}


def register_builder(name: str, factory: Callable = None, *,
                     tags: Sequence[str] = ()):
    """Register a zero-arg contract factory under ``name`` (usable as a
    decorator factory or called directly). Duplicate names are refused:
    the manifest keys on them, so a silent overwrite would let one
    runner's contracts mask another's."""
    if factory is None:
        return lambda f: register_builder(name, f, tags=tags)
    if name in BUILDERS:
        raise ValueError(f"duplicate builder registration: {name!r}")
    BUILDERS[name] = BuilderSpec(name=name, factory=factory, tags=tuple(tags))
    return factory
