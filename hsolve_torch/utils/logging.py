"""Central logger + verbose progress reporting.

The reference gates per-level progress prints on ``opts.verbose``
(``reference: src/factorization.jl:17,22``); here the same flag routes
per-batch schedule progress through the ``hsolve_torch`` logger (stderr handler at WARNING
by default; ``verbose`` lifts it to INFO for the duration of the call).
"""

from __future__ import annotations

import contextlib
import logging
import sys

logger = logging.getLogger("hsolve_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[hsolve_torch] %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


@contextlib.contextmanager
def verbose_level(enabled: bool):
    """Temporarily lift the hsolve_torch logger to INFO when ``enabled``."""
    if not enabled:
        yield
        return
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        yield
    finally:
        logger.setLevel(old)
