"""Embedding layers (the port of ``bigdl_tpu/nn/embedding.py``, reference
``nn/LookupTable.scala`` and ``nn/LookupTableSparse.scala``).

The weight is ``(n_index, n_output)`` in both packages (``jax_perms``
keeps ``convert`` from transposing it). Indices are 0-based and clipped
into range, as the reference's ``jnp.take`` of clipped indices; a
gradient reaches only the rows gathered.
"""

from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.nn.init_methods import RandomNormal
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


def _renorm(out, max_norm, norm_type=2.0):
    """Rows of ``out`` scaled down to norm ``max_norm`` (only the gathered
    rows, as the reference does)."""
    norm = torch.linalg.vector_norm(out, ord=norm_type, dim=-1, keepdim=True)
    return out * torch.clamp_max(max_norm / (norm + 1e-12), 1.0)


class _Table(Module):
    jax_perms = {"weight": None}

    def __init__(self, n_index, n_output, init_weight, device, dtype):
        super().__init__()
        self.n_index, self.n_output = n_index, n_output
        self.weight_init = init_weight or RandomNormal(0.0, 1.0)
        self.weight = nn.Parameter(torch.empty(
            n_index, n_output, device=resolve_device(device), dtype=dtype))

    def _gather(self, idx):
        return self.weight[torch.clamp(idx.long(), 0, self.n_index - 1)]

    def init_arrays(self, rng):
        return {"weight": self.weight_init.init(
            rng, (self.n_index, self.n_output), fan_in=self.n_index,
            fan_out=self.n_output)}

    def extra_repr(self):
        return f"{self.n_index} -> {self.n_output}"


class LookupTable(_Table):
    """Dense embedding lookup (reference ``nn/LookupTable.scala``): rows of
    ``padding_value`` give zero vectors; ``max_norm`` renormalises each
    gathered row; ``w_regularizer`` joins the training loss."""

    def __init__(self, n_index, n_output, padding_value=None, max_norm=None,
                 norm_type=2.0, should_scale_grad_by_freq=False,
                 w_regularizer=None, init_weight=None, device=None,
                 dtype=torch.float32):
        super().__init__(n_index, n_output, init_weight, device, dtype)
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.w_regularizer = w_regularizer

    def forward(self, x):
        idx = torch.as_tensor(x, device=self.weight.device)
        out = self._gather(idx)
        if self.max_norm is not None:
            out = _renorm(out, self.max_norm, self.norm_type)
        if self.padding_value is not None:
            out = torch.where((idx != self.padding_value)[..., None], out,
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
        return out


class LookupTableSparse(_Table):
    """Bag-of-ids embedding with a combiner (reference
    ``nn/LookupTableSparse.scala``): input ids (B, L) padded with -1, or
    the list ``[ids, weights]``; ``combiner`` "sum", "mean" or "sqrtn"
    over each bag's valid ids."""

    def __init__(self, n_index, n_output, combiner="sum", max_norm=None,
                 init_weight=None, device=None, dtype=torch.float32):
        super().__init__(n_index, n_output, init_weight, device, dtype)
        self.combiner = combiner
        self.max_norm = max_norm

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            ids, weights = x[0], (x[1] if len(x) > 1 else None)
        else:
            ids, weights = x, None
        dev = self.weight.device
        idx = torch.as_tensor(ids, device=dev)
        valid = (idx >= 0).to(self.weight.dtype)
        emb = self._gather(idx)
        if self.max_norm is not None:
            emb = _renorm(emb, self.max_norm)
        w = valid if weights is None else \
            valid * torch.as_tensor(weights, device=dev, dtype=valid.dtype)
        summed = torch.einsum("bld,bl->bd", emb, w)
        if self.combiner == "sum":
            return summed
        if self.combiner == "mean":
            return summed / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)
        if self.combiner == "sqrtn":
            return summed / torch.sqrt(torch.clamp_min(
                torch.square(w).sum(-1, keepdim=True), 1e-12))
        raise ValueError(f"unknown combiner {self.combiner}")


__all__ = ["LookupTable", "LookupTableSparse"]
