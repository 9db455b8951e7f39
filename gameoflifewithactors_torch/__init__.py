"""gameoflifewithactors_torch — the cellular-automata framework on PyTorch
and CUDA.

The port of ``gameoflifewithactors_tpu`` to one NVIDIA H100: the same
rules (life-like, Generations, Larger than Life, elementary 1D), bit
layout, engine, checkpoints and actor-shaped façade, written in PyTorch,
with the temporal-blocked packed stencils as hand-written CUDA kernels (``ops/cuda_stencil.py``,
``csrc/life_packed.cu``, ``csrc/life_slab.cu``,
``csrc/life_generations.cu``, ``csrc/life_ltl.cu``), on one device or on
a mesh (``parallel/``). It imports nothing of JAX or of the JAX package.
Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``.
"""

from .models.rules import (  # noqa: F401
    CONWAY,
    DAY_AND_NIGHT,
    HIGHLIFE,
    RULE_REGISTRY,
    Rule,
    parse_rule,
)
from .models.generations import (  # noqa: F401
    BRIANS_BRAIN,
    GENERATIONS_REGISTRY,
    GenRule,
    STAR_WARS,
    parse_any,
    parse_generations,
)
from .models.ltl import BOSCO, LTL_REGISTRY, LtLRule, parse_ltl  # noqa: F401
from .models.elementary import (  # noqa: F401
    RULE_30,
    RULE_90,
    RULE_110,
    ElementaryRule,
    parse_elementary,
)
from .ops.elementary import (  # noqa: F401
    evolve_spacetime,
    multi_step_elementary,
    step_elementary,
)
from .models import seeds  # noqa: F401
from .ops.stencil import Topology, step, multi_step  # noqa: F401
from .ops.bitpack import pack, unpack, population  # noqa: F401
from .ops.packed import step_packed, multi_step_packed  # noqa: F401
from .ops.generations import multi_step_generations, step_generations  # noqa: F401
from .ops.ltl import multi_step_ltl, step_ltl  # noqa: F401
from .engine import Engine  # noqa: F401
from .coordinator import GridCoordinator, RenderFrame  # noqa: F401
from .scheduler import TickScheduler  # noqa: F401
from .config import SimulationConfig  # noqa: F401

__version__ = "0.1.0"
