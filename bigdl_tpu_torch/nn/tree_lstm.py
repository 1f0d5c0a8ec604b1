"""Tree-structured LSTMs (the port of ``bigdl_tpu/nn/tree_lstm.py``,
reference ``nn/TreeLSTM.scala`` and ``nn/BinaryTreeLSTM.scala``).

The reference's padded post-order scan over a node buffer, as a Python
loop over autograd: every tree is a buffer of ``N`` nodes in topological
order (children before parents); step ``t`` gathers the two children's
``(h, c)`` from slots ``1..N`` of the states computed so far (slot 0 is
the zero state, used by leaves and padding; slots not yet computed are
zeros, as in the reference's buffer), computes the leaf and the composer
candidates, keeps the leaf's where the node has no children, and appends
slot ``t + 1``. The buffer is built out of place, a list of per-slot
tensors stacked for each gather, so autograd reaches every step.

Encoding: ``x = [emb (B, N, D), tree (B, N, 2)]``: leaf embeddings at leaf
slots, zeros elsewhere; each node's 1-based (left, right) child slots, 0
for none.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.init_methods import Xavier
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


class BinaryTreeLSTM(Module):
    """(reference ``nn/BinaryTreeLSTM.scala``) ``leaf_w`` (D, 3H) and
    ``leaf_b`` give the leaf's ``i, o, u``; ``comp_w`` (2H, 5H) and
    ``comp_b`` the composer's ``i, f_l, f_r, o, u`` from the children's
    hidden states. ``w_regularizer`` penalises both weights."""

    def __init__(self, input_size, hidden_size, w_regularizer=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.w_regularizer = w_regularizer
        dev = resolve_device(device)
        d, h = input_size, hidden_size
        self.leaf_w = nn.Parameter(torch.empty(d, 3 * h, device=dev,
                                               dtype=dtype))
        self.leaf_b = nn.Parameter(torch.empty(3 * h, device=dev,
                                               dtype=dtype))
        self.comp_w = nn.Parameter(torch.empty(2 * h, 5 * h, device=dev,
                                               dtype=dtype))
        self.comp_b = nn.Parameter(torch.empty(5 * h, device=dev,
                                               dtype=dtype))

    def init_arrays(self, rng):
        d, h = self.input_size, self.hidden_size
        init = Xavier()
        return {"leaf_w": init.init(rng, (d, 3 * h), fan_in=d,
                                    fan_out=3 * h),
                "leaf_b": np.zeros(3 * h),
                "comp_w": init.init(rng, (2 * h, 5 * h), fan_in=2 * h,
                                    fan_out=5 * h),
                "comp_b": np.zeros(5 * h)}

    def regularized_leaves(self):
        return [("leaf_w", self.w_regularizer),
                ("comp_w", self.w_regularizer)]

    def forward(self, x):
        emb, tree = x[0], x[1]
        b, n, _ = emb.shape
        tree = torch.as_tensor(tree, device=emb.device).long()
        zero = emb.new_zeros((b, self.hidden_size))
        hs, cs = [zero], [zero]
        rows = torch.arange(b, device=emb.device)
        for t in range(n):
            pad = [zero] * (n - t)
            h_buf = torch.stack(hs + pad, dim=1)
            c_buf = torch.stack(cs + pad, dim=1)
            left, right = tree[:, t, 0], tree[:, t, 1]
            h_l, c_l = h_buf[rows, left], c_buf[rows, left]
            h_r, c_r = h_buf[rows, right], c_buf[rows, right]

            z = emb[:, t] @ self.leaf_w + self.leaf_b
            li, lo, lu = z.chunk(3, dim=-1)
            lc = torch.sigmoid(li) * torch.tanh(lu)
            lh = torch.sigmoid(lo) * torch.tanh(lc)

            g = torch.cat([h_l, h_r], dim=-1) @ self.comp_w + self.comp_b
            ci, cfl, cfr, co, cu = g.chunk(5, dim=-1)
            cc = (torch.sigmoid(ci) * torch.tanh(cu)
                  + torch.sigmoid(cfl) * c_l + torch.sigmoid(cfr) * c_r)
            ch = torch.sigmoid(co) * torch.tanh(cc)

            is_leaf = ((left == 0) & (right == 0))[:, None]
            hs.append(torch.where(is_leaf, lh, ch))
            cs.append(torch.where(is_leaf, lc, cc))
        return torch.stack(hs[1:], dim=1)

    def __repr__(self):
        return f"BinaryTreeLSTM({self.input_size} -> {self.hidden_size})"


# the reference's TreeLSTM.scala is the abstract base; the binary composer
# is the one model families use
TreeLSTM = BinaryTreeLSTM


class TreeGather(Module):
    """Per-tree node hidden states (e.g. the roots): ``[hiddens (B, N, H),
    indices (B,)]`` -> (B, H), indices 1-based as the tree encoding."""

    def forward(self, x):
        hs, idx = x[0], x[1]
        idx = torch.as_tensor(idx, device=hs.device).long()
        return hs[torch.arange(hs.shape[0], device=hs.device), idx - 1]


__all__ = ["BinaryTreeLSTM", "TreeGather", "TreeLSTM"]
