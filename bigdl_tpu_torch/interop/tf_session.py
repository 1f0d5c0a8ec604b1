"""Trainable session over an imported TF graph (the port of
``bigdl_tpu/interop/tf_session.py``: reference ``utils/tf/Session.scala:105``,
``BigDLSessionImpl``, which replaces a graph's queue inputs with an RDD
feed and trains the BigDL graph it builds).

The imported graph is a port ``Graph`` whose constants and variables are
trainable layer weights (``interop/tf_loader.py``), so a session is the
graph, a criterion and a data feed through the port's ``Optimizer``:
``mesh=`` a list of devices gives its ``DistriOptimizer``, as
``Optimizer(mesh=)`` does. Without ``sample_input`` the imported weights
are applied when training or prediction starts, so fine-tuning never
starts from the seeded ones.
"""

from __future__ import annotations

import numpy as np
import torch


class TFTrainingSession:
    """(reference ``BigDLSessionImpl.train``, ``Session.scala:105``)"""

    def __init__(self, graph_path, inputs, outputs, bin_dir=None,
                 sample_input=None, device=None):
        from bigdl_tpu_torch.interop.tf_loader import load_tf
        self.graph = load_tf(graph_path, inputs, outputs, bin_dir=bin_dir,
                             sample_input=sample_input, device=device)
        if sample_input is not None:
            self.graph.train()

    def _ensure_weights(self):
        from bigdl_tpu_torch.interop.tf_loader import apply_tf_weights
        if not getattr(self.graph, "_tf_weights_applied", False):
            apply_tf_weights(self.graph)
            self.graph.train()

    def train(self, dataset, criterion, optim_method=None, end_trigger=None,
              mesh=None):
        """Train the imported graph; returns the trained graph Module."""
        from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
        self._ensure_weights()
        kwargs = {"mesh": mesh} if mesh is not None else {}
        opt = Optimizer(model=self.graph, dataset=dataset,
                        criterion=criterion, **kwargs)
        opt.set_optim_method(optim_method or SGD())
        opt.set_end_when(end_trigger or Trigger.max_epoch(1))
        opt.optimize()
        return self.graph

    def predict(self, x, batch_size=32):
        """The graph's outputs on the rows of ``x`` in evaluation mode, in
        batches of ``batch_size``, as one numpy array."""
        from bigdl_tpu_torch.ops.tf_ops import as_tensor
        self._ensure_weights()
        self.graph.evaluate()
        device = next(self.graph.parameters()).device
        outs = []
        with torch.no_grad():
            for i in range(0, len(x), batch_size):
                batch = as_tensor(np.asarray(x[i:i + batch_size]), device)
                outs.append(self.graph(batch).float().cpu().numpy())
        return np.concatenate(outs, axis=0)
