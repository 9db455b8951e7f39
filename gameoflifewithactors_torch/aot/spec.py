"""EngineSpec: the canonical identity of a runner configuration.

Counterpart of ``gameoflifewithactors_tpu.aot.spec``. A registry record
(:mod:`.registry`) is valid only for the configuration that produced it
(rule, grid shape, backend, topology, mesh, exchange depth) and the
environment it was made in (torch and CUDA versions, the card).
``EngineSpec`` pins the first as one hashable value, with the JAX
package's seven fields and the same :meth:`EngineSpec.canonical` form;
:func:`environment_fingerprint` pins the second; :meth:`EngineSpec.cache_key`
folds both into the content hash the registry files records under, so a
record from another environment is never served: it hashes elsewhere.

The device an engine runs on is not a field: it is an argument of
:meth:`EngineSpec.build_engine` (``"cuda"`` unless the caller asks for the
CPU), so that the canonical form matches the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple


def environment_fingerprint() -> dict:
    """What must match for a record to be loadable here: the torch and
    CUDA versions and the platform, device name, compute capability and
    device count."""
    import torch

    platform, name, capability = "cpu", "cpu", None
    if torch.cuda.is_available():
        platform = "cuda"
        name = torch.cuda.get_device_name(0)
        capability = "{}.{}".format(*torch.cuda.get_device_capability(0))
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": platform,
        "device_name": name,
        "capability": capability,
        "device_count": torch.cuda.device_count() if platform == "cuda" else 0,
    }


def _mesh_shape(mesh) -> Tuple[int, int]:
    from ..parallel import mesh as mesh_lib

    return (mesh.shape[mesh_lib.ROW_AXIS], mesh.shape[mesh_lib.COL_AXIS])


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One runner configuration, in engine-constructor vocabulary.

    ``backend`` may be ``"auto"``; :meth:`resolve` canonicalizes it through
    the engine's own choice, so two specs that resolve to the same runner
    share records.
    """

    height: int
    width: int
    rule: str = "B3/S23"
    backend: str = "auto"
    topology: str = "torus"
    mesh: Optional[Tuple[int, int]] = None   # (nx, ny) device mesh, or None
    gens_per_exchange: int = 1

    # -- construction --------------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "EngineSpec":
        d = dict(d)
        if "shape" in d:  # manifest convenience: "shape": [H, W]
            d["height"], d["width"] = d.pop("shape")
        mesh = d.get("mesh")
        if mesh is not None:
            d["mesh"] = tuple(int(x) for x in mesh)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown EngineSpec fields {sorted(unknown)}; "
                f"expected a subset of {sorted(known)} (or 'shape')")
        return cls(**d)

    @classmethod
    def from_config(cls, cfg) -> "EngineSpec":
        """From a SimulationConfig (the CLI's ``warmup --from-config``)."""
        m = cfg.build_mesh()
        return cls(height=cfg.height, width=cfg.width, rule=cfg.rule,
                   backend=cfg.backend, topology=cfg.topology,
                   mesh=None if m is None else _mesh_shape(m),
                   gens_per_exchange=cfg.gens_per_exchange or 1)

    @classmethod
    def from_engine(cls, engine) -> "EngineSpec":
        """From a live Engine: ``backend`` is the RESOLVED one, so the spec
        round-trips to the runner the engine actually built."""
        return cls(height=engine.shape[0], width=engine.shape[1],
                   rule=engine.rule.notation, backend=engine.backend,
                   topology=engine.topology.value,
                   mesh=None if engine.mesh is None else _mesh_shape(engine.mesh),
                   gens_per_exchange=engine.gens_per_exchange)

    # -- engine assembly -----------------------------------------------------

    def _mesh(self, device):
        """The spec's mesh over ``device``'s type: every CUDA device, or
        the one CPU device repeated (a mesh device may repeat)."""
        import torch

        from ..parallel import mesh as mesh_lib

        if not self.mesh:
            return None
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            return mesh_lib.make_mesh(self.mesh)
        return mesh_lib.make_mesh(self.mesh, [dev] * (self.mesh[0] * self.mesh[1]))

    def build_engine(self, grid=None, device=None):
        """Construct the Engine this spec names on ``device`` (all-dead
        universe by default: the kernels a runner needs depend on shapes
        and the rule, never on cell values, so warmup and the registry
        need no seed)."""
        import numpy as np

        from ..engine import Engine
        from ..ops.stencil import Topology

        if grid is None:
            grid = np.zeros((self.height, self.width), dtype=np.uint8)
        return Engine(grid, self.rule, topology=Topology(self.topology),
                      mesh=self._mesh(device), backend=self.backend,
                      gens_per_exchange=self.gens_per_exchange, device=device)

    def resolve(self, device=None) -> "EngineSpec":
        """The spec with ``backend`` resolved as an engine on ``device``
        resolves it: the canonical form the registry hashes. Configures
        an engine without building its state."""
        if self.backend != "auto":
            return self
        from ..engine import Engine
        from ..ops.stencil import Topology

        engine = Engine.__new__(Engine)
        engine._configure(self.rule, Topology(self.topology), self.backend,
                          device, self._mesh(device), (self.height, self.width),
                          self.gens_per_exchange)
        return EngineSpec.from_engine(engine)

    # -- identity ------------------------------------------------------------

    def canonical(self) -> dict:
        """Canonical rule notation + sorted fields, environment excluded."""
        from ..models.generations import parse_any

        d = dataclasses.asdict(self)
        d["rule"] = parse_any(self.rule).notation
        if d["mesh"] is not None:
            d["mesh"] = list(d["mesh"])
        return d

    def cache_key(self, fingerprint: Optional[dict] = None) -> str:
        """Content hash naming this spec's records: canonical spec +
        environment fingerprint, sha256-hex (first 24 chars)."""
        payload = {
            "spec": self.canonical(),
            "env": fingerprint if fingerprint is not None
            else environment_fingerprint(),
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:24]

    def describe(self) -> str:
        mesh = f" mesh={self.mesh[0]}x{self.mesh[1]}" if self.mesh else ""
        g = (f" G={self.gens_per_exchange}"
             if self.gens_per_exchange != 1 else "")
        return (f"{self.rule} {self.height}x{self.width} "
                f"[{self.backend}/{self.topology}{mesh}{g}]")
