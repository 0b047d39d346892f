"""The modules a run must not load: JAX, its libraries, and the JAX package
the port was made from.  Compared by whole top-level name (the part before
the first dot), so ``gespmm_tpu_torch`` is not ``gespmm_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gespmm_tpu"})


def forbidden(names: Iterable[str] = None,
              banned: Iterable[str] = FORBIDDEN) -> List[str]:
    """The loaded modules (default: ``sys.modules``) whose top-level name is
    in ``banned``."""
    banned = frozenset(banned)
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in banned)
