"""DistriOptimizer: synchronous data-parallel training over a list of
devices (the port of ``bigdl_tpu/parallel/distri_optimizer.py``,
reference ``optim/DistriOptimizer.scala``).

The step is ``parallel.allreduce.make_distributed_train_step``: ZeRO-1
over the replicas of ``mesh``, driven by one thread. This class is the
driver the reference's is: epochs, shuffling, the batch checks, triggers,
in-mesh validation, checkpoints, metrics and the retry loop. It shares
the epoch loop of ``optim.optimizer.LocalOptimizer`` (``DeviceFeed`` to
the first replica's device, ``steps_per_loop``, ``_DispatchAhead``,
triggers, the schedules' epoch counters, async checkpoints); each step
copies every replica's rows to its device.

- ``drop_percentage`` (the reference's straggler dropping) is accepted and
  ignored, as in the reference: the replicas run in lockstep;
- failure recovery (reference ``DistriOptimizer.scala:907-976``): an
  exception inside an epoch reloads the latest checkpoint (``model.N``,
  ``optimMethod.N`` and ``driverState.N``), rebuilds the step and goes
  on, logging each retry with its exception; without a checkpoint path,
  or after ``failure_retry_times`` failures (``BIGDL_TPU_FAILURE_RETRY_
  TIMES``, 5) less than ``BIGDL_TPU_FAILURE_RETRY_INTERVAL`` seconds
  (120) apart, it raises. A CUDA error is sticky, so a faulting kernel
  fails again after the reload and raises once the budget is spent;
- a checkpoint writes the float32 masters (``_materialize`` puts them into
  ``model``, never the wire copy) and the optimizer state in the
  reference's gathered layout (``ZeroState.gathered_opt_state``).

Sharded checkpoints (``BIGDL_TPU_SHARDED_CHECKPOINT``), the reference's
``allreduce_bandwidth``/``ici_peak_gbps``, more than one process and a run
across distinct cards wait for ROADMAP queue A.10(b); the flag raises.
"""

from __future__ import annotations

import logging
import pickle
import time

import torch

from bigdl_tpu_torch.dataset.transformer import host_tensor
from bigdl_tpu_torch.optim.optimizer import Optimizer, _DispatchAhead
from bigdl_tpu_torch.optim.methods import OptimMethod
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.parallel.allreduce import (make_distributed_eval_step,
                                                make_distributed_train_step,
                                                record_allreduce,
                                                ring_allreduce_bytes)
from bigdl_tpu_torch.utils.fileio import (atomic_write, file_exists,
                                          file_listdir, file_makedirs,
                                          file_open, path_join)
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.parallel")


def visible_cards():
    """Every visible CUDA device (the reference's ``Engine.mesh()``)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("mesh=None takes every visible CUDA device, and "
                           "there is none: pass a mesh (e.g. ['cpu'] * N)")
    return [f"cuda:{i}" for i in range(n)]


class DistriOptimizer(Optimizer):
    """``DistriOptimizer(model, dataset, criterion, mesh=None, axis="data",
    wire_dtype=None, compute_dtype=None, drop_percentage=0.0,
    failure_retry_times=None, accumulate_steps=1, **kwargs)``: ``mesh``
    a list of devices (None: every visible card; a device may repeat),
    ``wire_dtype`` the type of the gathered weights and the reduced
    gradients (default bfloat16), ``compute_dtype`` the forward's.

    ``metrics``: the local loop's, plus ``allreduce_bytes`` (the ring
    allreduce's wire bytes a step, ``ring_allreduce_bytes``, summed);
    ``retries`` counts the failures recovered from."""

    def __init__(self, model=None, dataset=None, criterion=None, mesh=None,
                 axis="data", wire_dtype=None, compute_dtype=None,
                 drop_percentage=0.0, failure_retry_times=None,
                 accumulate_steps=1, **kwargs):
        super().__init__(model, dataset, criterion,
                         accumulate_steps=accumulate_steps, **kwargs)
        self.mesh = list(mesh) if mesh is not None else visible_cards()
        self.axis = axis
        self.wire_dtype = wire_dtype or torch.bfloat16
        self.compute_dtype = compute_dtype
        if failure_retry_times is None:
            failure_retry_times = get_flag("BIGDL_TPU_FAILURE_RETRY_TIMES", 5,
                                           int)
        self.failure_retry_times = failure_retry_times
        self.failure_retry_interval = get_flag(
            "BIGDL_TPU_FAILURE_RETRY_INTERVAL", 120.0, float)
        self.metrics = self._fresh_metrics()
        self.retries = 0
        self._step = None
        self._eval_fn = None
        self._draws = None

    @staticmethod
    def _fresh_metrics():
        return {"allreduce_bytes": 0, "steps": 0, "data_time": 0.0,
                "step_time": 0.0, "records": 0, "dispatches": 0}

    # the clipping specs of allreduce.make_distributed_train_step
    def set_gradient_clipping_by_l2_norm(self, max_norm):
        self.clipping = ("l2norm", max_norm)
        return self

    def set_constant_gradient_clipping(self, min_value, max_value):
        self.clipping = ("constant", min_value, max_value)
        return self

    # ----- batches -----------------------------------------------------
    def _check_rows(self, rows):
        n = len(self.mesh)
        if rows % n:
            raise ValueError(
                f"batch size {rows} must be divisible by the mesh's "
                f"'{self.axis}' axis size {n} (reference requirement: "
                "batchSize % nodeNumber == 0, Optimizer.scala)")
        k = self.accumulate_steps
        if k > 1 and (rows // n) % k:
            raise ValueError(
                f"accumulate_steps={k} must divide the per-device batch "
                f"rows ({rows // n}); keep SampleToMiniBatch's default "
                "pad_last=True, or set drop_last=True")

    def _shard_batch(self, batch, tensors=None):
        """``(x, y)`` of a batch after the reference's checks: ``tensors``
        (the fed tensors) or the batch's arrays on the host. The step
        copies replica p's rows to its device."""
        x, y = tensors if tensors is not None else (
            host_tensor(batch.get_input()), host_tensor(batch.get_target()))
        self._check_rows(x.shape[0])
        return x, y

    def _place(self, item, x, y):
        return self._shard_batch(item, (x, y))

    def _place_super(self, sb, xs, ys):
        self._check_rows(xs.shape[1])
        return xs, ys

    # ----- the step ----------------------------------------------------
    def _build_step(self):
        step = make_distributed_train_step(
            self.model, self.criterion, self.optim_method, self.mesh,
            clipping=self.clipping,
            wire_dtype=self.wire_dtype, compute_dtype=self.compute_dtype,
            accumulate_steps=self.accumulate_steps)
        self._step = step
        fn = step.train_loop if self.steps_per_loop > 1 else step
        self._fn = lambda x, y: fn(x, y, self._draws)
        self._eval_fn = None
        self._wire_bytes = ring_allreduce_bytes(
            step.state.arp.padded_size, len(self.mesh), self.wire_dtype)

    def _opt_states(self):
        return self._step.state.opt_states

    def _count_dispatch(self, k):
        record_allreduce(self.metrics, self._wire_bytes * k)

    def optimize(self):
        if get_flag("BIGDL_TPU_SHARDED_CHECKPOINT", False, bool):
            raise NotImplementedError(
                "BIGDL_TPU_SHARDED_CHECKPOINT (per-shard checkpoint files) "
                "waits for ROADMAP queue A.10(b)")
        ds = self.dataset
        self._ensure_ready()
        self.metrics = self._fresh_metrics()
        self.retries = 0
        # the optimizer's own stream, on the host: each step draws one seed from
        # it for the replicas' streams (allreduce.replica_generators)
        self._draws = self._generator("cpu")
        self._build_step()
        device = self._step.state.devices[0]
        driver_state = {"epoch": 1, "neval": 1, "loss": None, "score": None,
                        "epoch_finished": False}
        ndev = len(self.mesh)

        def log_iter(ent, loss_f, rate):
            logger.info(
                "[%d dev] Epoch %d iter %d loss %.4f "
                "throughput %.1f records/s",
                ndev, ent["epoch"], ent["neval"], loss_f, rate)

        ahead = _DispatchAhead(driver_state, self.train_summary, log_iter)
        failures, last_failure = 0, None
        while not self.end_when(driver_state):
            try:
                self._train_epoch(ds, device, ahead, driver_state)
            except Exception:
                # reload the latest checkpoint and rebuild (reference
                # DistriOptimizer.scala:907-976); the queued readouts
                # belong to the failed run
                ahead.clear()
                now = time.time()
                if (last_failure is not None
                        and now - last_failure > self.failure_retry_interval):
                    failures = 0
                last_failure = now
                failures += 1
                if failures > self.failure_retry_times \
                        or not self.checkpoint_path:
                    raise
                logger.exception("training failed; retry %d from checkpoint",
                                 failures)
                self.retries += 1
                driver_state = self._reload_latest()
                ahead.driver_state = driver_state
        self._materialize()
        self._join_checkpoint()
        return self.model

    # ----- util --------------------------------------------------------
    def metrics_summary(self):
        """The local loop's summary, plus the wire traffic (reference
        ``Metrics.summary``)."""
        out = super().metrics_summary()
        m = self.metrics
        out["allreduce_bytes_total"] = m["allreduce_bytes"]
        out["allreduce_wire_gbps_est"] = (
            m["allreduce_bytes"] / m["step_time"] / 1e9
            if m["step_time"] > 0 else 0.0)
        return out

    @torch.no_grad()
    def _materialize(self):
        """The float32 masters into ``model``'s parameters, replica 0's
        buffers into its buffers, and the gathered optimizer state into
        ``_opt_state``."""
        state = self._step.state
        params = dict(self.model.named_parameters())
        dev = next(iter(params.values())).device if params \
            else torch.device("cpu")
        state.arp.load_into(state.full_master(dev), params)
        for (_, b), (_, rb) in zip(self.model.named_buffers(),
                                   state.replicas[0].named_buffers()):
            b.copy_(rb)
        self._opt_state = state.gathered_opt_state()

    def _validate_inmesh(self):
        """``{method name: ValidationResult}`` over the validation set,
        each batch split over the replicas and the counters summed
        (``allreduce.make_distributed_eval_step``; a padded tail masked
        row by row); None when a method has no counters (the caller
        validates the materialized model on the host instead)."""
        if self.validation_dataset is None or not self.validation_methods:
            return {}
        methods = self.validation_methods
        if any(type(m).counters is ValidationMethod.counters
               for m in methods):
            return None
        if self._eval_fn is None:
            self._eval_fn = make_distributed_eval_step(
                self._step.state, methods, self.compute_dtype)
        agg = {m.name: None for m in methods}
        for batch in self.validation_dataset.data(train=False):
            size = batch.size()
            real = getattr(batch, "real_size", size)
            if real < size and not self._eval_fn.supports_valid:
                logger.warning(
                    "in-mesh validation skipping padded tail batch "
                    "(%d real of %d): custom ValidationMethod without "
                    "mask support", real, size)
                continue
            x, y = self._shard_batch(batch)
            valid = torch.arange(size) < real
            for m, (v, c) in zip(methods, self._eval_fn(x, y, valid)):
                r = m.make_result(float(v), float(c))
                agg[m.name] = r if agg[m.name] is None else agg[m.name] + r
        return {k: v for k, v in agg.items() if v is not None}

    def _validate_now(self):
        results = self._validate_inmesh()
        if results is None:
            self._materialize()
            return self._validate()
        values = {}
        for name, r in results.items():
            values[name] = r.result()[0]
            logger.info("validation %s = %.4f", name, values[name])
        return values

    def _checkpoint_now(self, driver_state):
        self._materialize()
        self._checkpoint(driver_state["neval"], self._opt_state)
        self._save_driver_state(driver_state)

    def _flat_params(self):
        self._materialize()
        return super()._flat_params()

    def _save_driver_state(self, driver_state):
        """``driverState.latest`` and ``driverState.<neval>`` beside the
        checkpoint, so a retry resumes the counters of the files it
        reloads."""
        file_makedirs(self.checkpoint_path)
        payload = pickle.dumps(dict(driver_state))
        for name in ("driverState.latest",
                     f"driverState.{driver_state['neval']}"):
            atomic_write(path_join(self.checkpoint_path, name), payload)

    def _reload_latest(self):
        """Reload the newest complete checkpoint into ``model``, the
        method and a rebuilt step; returns its driver state."""
        try:
            self._join_checkpoint()
        except RuntimeError:
            logger.exception("pending checkpoint write failed; retrying "
                             "from the previous complete snapshot")
        files = set(file_listdir(self.checkpoint_path))
        candidates = sorted(
            (int(f.split(".")[1]) for f in files
             if f.startswith("model.") and f.count(".") == 1
             and f.split(".")[1].isdigit()
             and f"optimMethod.{f.split('.')[1]}" in files),
            reverse=True)
        last_err = None
        for neval in candidates:
            try:
                device = next(self.model.parameters()).device
                sd = torch.load(path_join(self.checkpoint_path,
                                          f"model.{neval}"),
                                map_location=device)
                self.model.load_state_dict(sd)
                method, saved = OptimMethod.load(
                    path_join(self.checkpoint_path, f"optimMethod.{neval}"))
                self.optim_method = method
                self._build_step()
                if saved is not None:
                    self._step.state.load_opt_state(saved)
                break
            except Exception as e:
                last_err = e
                logger.warning("checkpoint %d failed to restore (%r); "
                               "falling back to an older snapshot", neval, e)
        else:
            raise RuntimeError("no checkpoint to retry from") from last_err
        ds_path = path_join(self.checkpoint_path, f"driverState.{neval}")
        if not file_exists(ds_path):
            ds_path = path_join(self.checkpoint_path, "driverState.latest")
        if file_exists(ds_path):
            with file_open(ds_path, "rb") as f:
                return pickle.load(f)
        return {"epoch": 1, "neval": neval, "loss": None, "score": None,
                "epoch_finished": False}


__all__ = ["DistriOptimizer", "visible_cards"]
