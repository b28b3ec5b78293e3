"""The run's own check that neither JAX nor the JAX package was loaded."""
from __future__ import annotations

import sys
from typing import Iterable, List

# compared with each loaded module's top-level name (the part before the
# first dot) as a whole word: ``climsr_tpu_torch`` is the port and passes
FORBIDDEN = ("jax", "jaxlib", "flax", "climsr_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: ``sys.modules``)."""
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))
