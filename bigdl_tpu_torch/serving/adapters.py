"""LoRA adapter errors (the port of ``bigdl_tpu/serving/adapters.py``
``AdapterLoadError``; the adapter pool itself is ROADMAP queue A.8)."""


class AdapterLoadError(RuntimeError):
    """No adapter could be produced for a request: here, always, since the
    port has no adapter pool (the reference raises it when its pool is
    off, or the adapter was never registered)."""
