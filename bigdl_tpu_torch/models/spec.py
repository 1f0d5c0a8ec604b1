"""Speculative decoding's flag rule (the port's copy of
``bigdl_tpu/models/spec.py`` ``spec_config``).

Only the rule that turns speculation on is ported: the engine reads it
so that ``BIGDL_TPU_SPEC_DECODE`` refuses to start a server that would
silently decode without speculation. Drafts and acceptance are ROADMAP
queue A.5.
"""

from __future__ import annotations

from bigdl_tpu_torch.utils.flags import get_flag


def spec_config():
    """The draft length ``gamma`` the speculative-decoding flags ask for:
    an int >= 1, where 1 means speculation is off (the default).
    ``BIGDL_TPU_SPEC_DECODE`` enables, ``BIGDL_TPU_SPEC_TOKENS`` sizes the
    draft (default 4)."""
    if not get_flag("BIGDL_TPU_SPEC_DECODE", False, bool):
        return 1
    return max(int(get_flag("BIGDL_TPU_SPEC_TOKENS", 4, int)), 1)


__all__ = ["spec_config"]
