"""``BIGDL_TPU_*`` environment flags (the port's copy of
``bigdl_tpu/utils/engine.py`` ``get_flag``).

The flag names stay the reference's, so one configuration drives both
packages. They only configure; they never switch a kernel off: on the card
the port always takes its kernels.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("bigdl_tpu_torch")

_TRUTHY = {"1", "true", "yes", "on"}


def get_flag(name, default=None, cast=str):
    """Read a ``BIGDL_TPU_*`` env flag with a typed cast.

    ``cast=bool`` accepts 1/true/yes/on (case-insensitive). Malformed
    values fall back to ``default`` with a warning.
    """
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        if cast is bool:
            return raw.strip().lower() in _TRUTHY
        return cast(raw)
    except (TypeError, ValueError):
        logger.warning("ignoring malformed flag %s=%r (want %s)",
                       name, raw, cast.__name__)
        return default
