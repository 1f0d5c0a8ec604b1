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
  fails again after the reload and raises once the budget is spent.
  ``TrainingPreempted`` is never retried: the preemption checkpoint (with
  its ``driverState``) is already written;
- the local loop's fault sites, spans, ``bigdl_train_*`` families
  (``loop="distri"``) and preemption guard; each dispatch also passes the
  ``allreduce.sync`` site and adds its ring bytes to
  ``bigdl_allreduce_bytes_total`` (``allreduce.record_allreduce``);
- a checkpoint writes the float32 masters (``_materialize`` puts them into
  ``model``, never the wire copy) and the optimizer state in the
  reference's gathered layout (``ZeroState.gathered_opt_state``).

With ``BIGDL_TPU_SHARDED_CHECKPOINT`` on, a checkpoint (on its trigger,
and the preemption's) is the reference's sharded set instead
(``bigdl_tpu/parallel/distri_optimizer.py:512-650``): this process writes
``shard.<neval>.p0`` atomically on the writer thread, a pickle of numpy
arrays the reference reads (``neval``, ``pid``, ``nprocs``, ``flat``: the
float32 masters as ``(global start, array)`` blocks, one a replica;
``opt``: each optimizer-state leaf under the reference's ``keystr`` path,
blocks of the slots and ``(None, array)`` for a scalar; ``state``: the
model's buffers in the reference's layout, ``convert.model_state_to_jax``),
then ``model.<neval>``, the model in the native format
(``utils/serializer.py``) whose root carries the reference's marker
attribute ``_sharded_weights_marker`` ``{neval, nprocs}`` (its weights are
replica 0's, its buffers the ones a resume restores), and
``optimMethod.<neval>`` without its state. The retry's reload picks among
both formats as the reference does: a set counts when its pids are
exactly ``range(nprocs)``, candidates newest first with a sharded set
winning a tie, one that fails to restore demoting to the next older; shard
files without a complete set raise rather than restore a marker file's
stale weights, and a marker ``model.N`` without its shards is refused with
the reference's message. More than one process and a run across distinct
cards wait for ROADMAP queue A.10(b).
"""

from __future__ import annotations

import copy
import logging
import pickle
import time

import torch

from bigdl_tpu_torch import convert
from bigdl_tpu_torch.dataset.transformer import host_tensor
from bigdl_tpu_torch.optim.optimizer import Optimizer, _DispatchAhead
from bigdl_tpu_torch.optim.methods import OptimMethod
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.optim.methods import cpu_copy
from bigdl_tpu_torch.parallel.allreduce import (make_distributed_eval_step,
                                                make_distributed_train_step,
                                                record_allreduce,
                                                ring_allreduce_bytes)
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.resilience.preempt import TrainingPreempted
from bigdl_tpu_torch.utils.fileio import (atomic_file_swap, atomic_write,
                                          file_exists, file_listdir,
                                          file_makedirs, file_open, path_join)
from bigdl_tpu_torch.utils.flags import get_flag
from bigdl_tpu_torch.utils.serializer import (copy_weights, load_module,
                                              save_module)

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
        self.metrics["allreduce_bytes"] += self._wire_bytes * k
        record_allreduce(self._wire_bytes * k)

    def optimize(self):
        ds = self.dataset
        self._ensure_ready()
        self._install_preempt_guard()
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

        ahead = _DispatchAhead(driver_state, self.train_summary, log_iter,
                               loop="distri")
        failures, last_failure = 0, None
        while not self.end_when(driver_state):
            try:
                self._train_epoch(ds, device, ahead, driver_state)
            except TrainingPreempted:
                # a deliberate exit, its final checkpoint written: a retry
                # would defeat the preemption
                raise
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
        if get_flag("BIGDL_TPU_SHARDED_CHECKPOINT", False, bool):
            # gather-free: the replicas' slices as they are
            self._checkpoint_sharded(driver_state["neval"])
        else:
            self._materialize()
            self._checkpoint(driver_state["neval"], self._opt_state)
        self._save_driver_state(driver_state)

    # ----- sharded checkpoints (module docstring) -----------------------
    @staticmethod
    def _local_blocks(parts, slice_size=None):
        """``[(global start, ndarray)]``, one block a replica, of a leaf
        held as ``parts`` (replica p's slice of ``slice_size`` elements on
        its device); ``[(None, ndarray)]`` for a scalar, or a tensor
        given alone (replicated)."""
        if isinstance(parts, torch.Tensor):
            return [(None, parts.detach().cpu().numpy().copy())]
        return [(p * slice_size, t.detach().cpu().numpy().copy())
                for p, t in enumerate(parts)]

    @staticmethod
    def _from_blocks(blocks, like):
        """The tensors of saved ``blocks`` laid out as ``like``: a list of
        replica slices (new tensors on their devices, block p at start
        ``p * len(like[0])``), or one tensor (a scalar)."""
        if isinstance(like, torch.Tensor):
            if blocks[0][0] is not None:
                raise RuntimeError("sharded checkpoint holds slices where "
                                   "a replicated leaf is expected")
            return torch.as_tensor(blocks[0][1]).to(like.device, like.dtype)
        data = dict(blocks)
        out = []
        for p, t in enumerate(like):
            start = p * t.shape[0]
            if start not in data:
                raise RuntimeError(
                    "sharded checkpoint does not cover offset "
                    f"{start}: it was written with a different process/"
                    "device layout — restore with the same topology or "
                    "use the gathered checkpoint format")
            out.append(torch.as_tensor(data[start]).to(t.device, t.dtype))
        return out

    @staticmethod
    def _opt_leaves(opt_states):
        """``{reference keystr: (scalar, parts)}`` of the replicas'
        optimizer states: each leaf's tensors, one a replica, under the
        reference's path (a per-element slot, ``init_state({"flat":
        slice})``'s ``["m"]["flat"]``, under ``['m']``), ``scalar`` true
        for a counter every replica holds whole."""
        out = {}

        def walk(path, node, states):
            for k, v in node.items():
                key = path if k == "flat" else path + (k,)
                parts = [st[k] for st in states]
                if isinstance(v, dict):
                    walk(key, v, parts)
                else:
                    out["".join(f"[{c!r}]" for c in key)] = (v.dim() == 0,
                                                              parts)

        walk((), opt_states[0], opt_states)
        return out

    def _checkpoint_sharded(self, neval):
        """Write this process's sharded set at ``neval`` (module
        docstring): the host copies here, the files behind the writer
        thread."""
        if not self.checkpoint_path:
            return
        self._join_checkpoint()
        state = self._step.state
        ss = state.arp.slice_size
        payload = {
            "neval": neval, "pid": 0, "nprocs": 1,
            "flat": self._local_blocks(state.masters, ss),
            "opt": {k: self._local_blocks(parts[0] if scalar else parts, ss)
                    for k, (scalar, parts) in
                    self._opt_leaves(state.opt_states).items()},
            "state": convert.model_state_to_jax(state.replicas[0]),
        }
        # the reference's marker model: a shallow copy carrying the
        # attribute, written from a host snapshot of replica 0
        marker = copy.copy(state.replicas[0])
        marker._sharded_weights_marker = {"neval": int(neval), "nprocs": 1}
        weights = cpu_copy(dict(state.replicas[0].state_dict()))
        method = self.optim_method
        path = self.checkpoint_path

        def write():
            fault_point("ckpt.write", neval=neval)
            file_makedirs(path)
            shard_path = path_join(path, f"shard.{neval}.p0")
            atomic_write(shard_path, pickle.dumps(payload))
            model_path = path_join(path, f"model.{neval}")
            method_path = path_join(path, f"optimMethod.{neval}")
            atomic_file_swap(model_path, lambda p: save_module(
                marker, p, overwrite=True, state_dict=weights))
            atomic_file_swap(method_path,
                             lambda p: method.save(p, None, overwrite=True))
            for f in (shard_path, model_path, method_path):
                faults.corrupt_file("ckpt.write", f)

        self._spawn_ckpt_writer(f"ckpt-shard-{neval}", write)

    @staticmethod
    def _shard_groups(files):
        """``{neval: {pids}}`` parsed from ``shard.*`` file names."""
        by_neval = {}
        for f in files:
            if f.startswith("shard.") and not f.endswith(".tmp"):
                try:
                    _, n, p = f.split(".")
                    by_neval.setdefault(int(n), set()).add(int(p[1:]))
                except ValueError:
                    continue
        return by_neval

    @classmethod
    def _candidates(cls, files):
        """``([(neval, "sharded" or "gathered")], shard groups)`` of a
        checkpoint directory's files, newest first, a sharded set before a
        gathered pair of the same ``neval``. A model.N of a sharded set
        holds no weights, so it is a gathered candidate only when no shard
        claims N; a set counts when its pids are exactly this run's (one
        process); an N without its ``optimMethod.N`` (a crash between the
        two renames) is no candidate."""
        files = set(files)
        groups = cls._shard_groups(files)
        complete = [n for n, pids in groups.items()
                    if pids == {0} and f"model.{n}" in files
                    and f"optimMethod.{n}" in files]
        gathered = [int(f.split(".")[1]) for f in files
                    if f.startswith("model.") and f.count(".") == 1
                    and f.split(".")[1].isdigit()
                    and int(f.split(".")[1]) not in groups
                    and f"optimMethod.{f.split('.')[1]}" in files]
        candidates = sorted(
            [(n, "sharded") for n in complete]
            + [(n, "gathered") for n in gathered],
            key=lambda t: (t[0], t[1] == "sharded"), reverse=True)
        return candidates, groups

    def _reload_sharded(self, neval):
        """Restore the masters, the slots and the buffers from the sharded
        set at ``neval`` onto a rebuilt step."""
        method, _ = OptimMethod.load(
            path_join(self.checkpoint_path, f"optimMethod.{neval}"))
        device = next(self.model.parameters()).device
        saved = load_module(path_join(self.checkpoint_path,
                                      f"model.{neval}"), device=device)
        with file_open(path_join(self.checkpoint_path,
                                 f"shard.{neval}.p0"), "rb") as f:
            mine = pickle.load(f)
        self.optim_method = method
        copy_weights(self.model, saved, buffers_only=True)
        self._build_step()
        state = self._step.state
        with torch.no_grad():
            for m, t in zip(state.masters,
                            self._from_blocks(mine["flat"], state.masters)):
                m.copy_(t)
            for key, (scalar, parts) in self._opt_leaves(
                    state.opt_states).items():
                blocks = mine["opt"][key]
                got = ([self._from_blocks(blocks, t) for t in parts]
                       if scalar else self._from_blocks(blocks, parts))
                for dst, src in zip(parts, got):
                    dst.copy_(src)

    def _reload_gathered(self, neval):
        device = next(self.model.parameters()).device
        copy_weights(self.model, load_module(
            path_join(self.checkpoint_path, f"model.{neval}"),
            device=device))
        method, saved = OptimMethod.load(
            path_join(self.checkpoint_path, f"optimMethod.{neval}"))
        self.optim_method = method
        self._build_step()
        if saved is not None:
            self._step.state.load_opt_state(saved)

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
        candidates, groups = self._candidates(
            file_listdir(self.checkpoint_path))
        if not candidates:
            if groups:
                raise RuntimeError(
                    f"sharded checkpoint sets {sorted(groups)} exist but "
                    "none is complete for 1 process(es) — restore with the "
                    "layout that wrote them")
            raise RuntimeError("no checkpoint to retry from")
        last_err = None
        for neval, kind in candidates:
            try:
                if kind == "sharded":
                    self._reload_sharded(neval)
                else:
                    self._reload_gathered(neval)
                break
            except Exception as e:
                last_err = e
                logger.warning("checkpoint %d (%s) failed to restore (%r); "
                               "falling back to an older snapshot", neval,
                               kind, e)
        else:
            raise RuntimeError(
                "no checkpoint to retry from (all "
                f"{len(candidates)} candidate(s) failed to restore)"
            ) from last_err
        ds_path = path_join(self.checkpoint_path, f"driverState.{neval}")
        if not file_exists(ds_path):
            ds_path = path_join(self.checkpoint_path, "driverState.latest")
        if file_exists(ds_path):
            with file_open(ds_path, "rb") as f:
                return pickle.load(f)
        return {"epoch": 1, "neval": neval, "loss": None, "score": None,
                "epoch_finished": False}


__all__ = ["DistriOptimizer", "visible_cards"]
