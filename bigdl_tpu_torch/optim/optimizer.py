"""Training: gradient clipping, the single-device train step and K-step
loop, and the ``Optimizer``/``LocalOptimizer`` facade (the port of
``bigdl_tpu/optim/optimizer.py``, reference ``optim/Optimizer.scala:42``
and ``optim/LocalOptimizer.scala:42``).

Gradients are dicts of tensors keyed by parameter name, as in
``optim/methods.py``. PyTorch runs eagerly, so a step is a Python function
and not a compiled program: forward, backward, clipping and the in-place
update are queued on the card one after another, and the host reads
nothing back. A model with buffers (BN running statistics) updates them in
place in its forward, as the reference returns them from its step.

The facade keeps the reference's API: ``Optimizer(model=, dataset=,
criterion=)``, its ``set_*`` builders, then ``optimize()``. Each epoch it
shuffles the dataset, feeds its batches through ``dataset.DeviceFeed``
(pinned memory, a side stream, one batch ahead), runs the step, and reads
each step's loss back one step late (``_DispatchAhead``), so the host
never waits for the card inside an epoch; validation, checkpoints and
summaries run on their triggers. ``LocalOptimizer`` and the data-parallel
``parallel.distri_optimizer.DistriOptimizer`` (``mesh=`` or a
``DistributedDataSet``) share that loop.

Both loops carry the reference's resilience and telemetry: the
``train.step`` fault site before each dispatch, ``train.drain`` inside the
timed loss readback and ``ckpt.write`` in the checkpoint writer; the
``bigdl_train_*`` families and a ``StepTimeAnomalyDetector`` on
``_DispatchAhead``; the spans ``train/feed``, ``train/dispatch``,
``train/drain``, ``train/validate``, ``train/checkpoint`` and
``train/preempt_checkpoint``. The step is eager, so ``train/dispatch``
times the host queueing the step, not the card running it; no span
synchronises the card. With ``BIGDL_TPU_PREEMPT_GUARD`` on (default)
``optimize()`` arms the SIGTERM guard (``resilience.preempt``): at the
next step boundary the loop drains the readout, writes a final checkpoint
and raises ``TrainingPreempted``.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

import torch
from torch.func import functional_call

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.dataset.transformer import (DeviceFeed, Prefetch,
                                                 ToSuperBatch)
from bigdl_tpu_torch.nn.module import (grad_scales, regularizers,
                                       takes_generator)
from bigdl_tpu_torch.optim.evaluator import Evaluator, model_device
from bigdl_tpu_torch.optim.methods import SGD, cpu_copy
from bigdl_tpu_torch.optim.schedules import Plateau
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.resilience import faults, preempt
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.resilience.preempt import TrainingPreempted
from bigdl_tpu_torch.utils.fileio import (atomic_file_swap, file_makedirs,
                                          path_join)
from bigdl_tpu_torch.utils.flags import get_flag
from bigdl_tpu_torch.utils.remat import checkpoint
from bigdl_tpu_torch.utils.serializer import save_module

logger = logging.getLogger("bigdl_tpu_torch.optim")


def clip_by_global_norm(grads, max_norm):
    """``grads`` scaled by ``min(1, max_norm / (norm + 1e-12))``, ``norm``
    the L2 norm of all of them together."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return {k: g * scale for k, g in grads.items()}


def clip_by_value(grads, min_value, max_value):
    return {k: torch.clamp(g, min_value, max_value) for k, g in grads.items()}


def cast_forward(module, x, compute_dtype=None, kw=None):
    """``module(x, **kw)``; with ``compute_dtype``, on a cast view of the
    parameters through ``torch.func.functional_call`` and a cast copy of a
    floating-point input (token ids stay as they are), the output cast
    back to float32 (buffers stay float32)."""
    kw = kw or {}
    if compute_dtype is None:
        return module(x, **kw)
    cast = {k: p.to(compute_dtype) for k, p in module.named_parameters()}
    if x.is_floating_point():
        x = x.to(compute_dtype)
    return functional_call(module, cast, (x,), kw).float()


def make_loss_and_grads(module, criterion, compute_dtype=None, remat=False,
                        accumulate_steps=1):
    """``fn(x, y, generator=None) -> (loss, grads)``: the loss of
    ``criterion(module(x), y)`` plus the layers' regularizer penalties
    (``nn.module.regularizers``) in training mode, and the gradient of
    every parameter of ``module`` (float32 master weights; the port of the
    reference's ``_loss_and_grads`` with ``scan_microbatches``).

    - ``compute_dtype`` (e.g. ``torch.bfloat16``): the forward runs on a
      cast view of the parameters through ``torch.func.functional_call``,
      and on a cast copy of a floating-point input (token ids stay as
      they are); the cast is differentiated, so the gradients come back
      float32, and the outputs are cast to float32 before the criterion.
      Buffers (BN running statistics) stay float32; the penalties read
      the cast weights, as the reference's do;
    - ``remat=True``: the whole forward is recomputed in the backward pass;
    - ``accumulate_steps=K``: the batch rows split into K micro-batches
      (K must divide them); gradients and losses are averaged over them.
      At K = 1 the labels may be a table (a list: a multi-output model's
      targets, e.g. ``ParallelCriterion``'s);
    - frozen layers and ``set_scale_w``/``set_scale_b`` multiply the
      averaged gradients (``nn.module.grad_scales``).

    The regularizers and scales are read when the function is built, as
    the reference's jitted step fixes them. ``generator`` reaches the
    module's forward only when given.
    """
    params = dict(module.named_parameters())
    regs = regularizers(module)
    scales = {n: s for n, s in grad_scales(module).items()
              if s != 1.0 and n in params}

    def forward(x, generator):
        kw = None if generator is None else {"generator": generator}
        return cast_forward(module, x, compute_dtype, kw)

    def penalty(loss):
        for name, reg in regs:
            w = params[name]
            loss = loss + reg(w if compute_dtype is None
                              else w.to(compute_dtype))
        return loss

    def loss_and_grads(x, y, generator=None):
        module.train()
        for p in params.values():
            p.grad = None
        k = accumulate_steps
        if x.shape[0] % k:
            raise ValueError(f"accumulate_steps={k} does not divide the "
                             f"batch of {x.shape[0]} rows")
        if k == 1 and not isinstance(y, torch.Tensor):
            xs, ys = [x], [y]       # a table of targets (a list): as it is
        else:
            xs = x.reshape(k, x.shape[0] // k, *x.shape[1:])
            ys = y.reshape(k, y.shape[0] // k, *y.shape[1:])
        total = 0.0
        for i in range(k):
            out = (checkpoint(forward, generator, xs[i]) if remat
                   else forward(xs[i], generator))
            loss = penalty(criterion(out, ys[i]))
            loss.backward()
            total = total + loss.detach()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if k > 1:
            grads = {n: g / k for n, g in grads.items()}
            total = total / k
        if scales:
            grads = {n: g * scales[n] if n in scales else g
                     for n, g in grads.items()}
        return total, grads

    return loss_and_grads


def make_train_step(module, criterion, optim_method, clipping=None,
                    compute_dtype=None, remat=False, accumulate_steps=1):
    """The single-device train step ``step(opt_state, x, y,
    generator=None) -> loss``: loss and gradients as
    :func:`make_loss_and_grads` computes them, then ``clipping(grads)``
    if given, then ``optim_method.update``, which changes ``module``'s
    parameters and ``opt_state`` in place. ``opt_state`` comes from
    ``optim_method.init_state(dict(module.named_parameters()))``; the
    labels ``y`` are as the criterion takes them (flattened (B*T,) for a
    GPT)."""
    loss_and_grads = make_loss_and_grads(module, criterion, compute_dtype,
                                         remat, accumulate_steps)
    params = dict(module.named_parameters())

    def step(opt_state, x, y, generator=None):
        loss, grads = loss_and_grads(x, y, generator)
        if clipping is not None:
            grads = clipping(grads)
        optim_method.update(grads, opt_state, params)
        return loss

    return step


def make_train_loop(module, criterion, optim_method, clipping=None,
                    compute_dtype=None, remat=False, accumulate_steps=1):
    """The K-step train loop of the ``steps_per_loop`` mode: ``loop(
    opt_state, xs, ys, generator=None) -> losses``, the step of
    :func:`make_train_step` run on each of the K batches of a ``[K,
    batch, ...]`` superbatch in turn, and the ``[K]`` vector of their
    losses. The reference scans the K steps inside one compiled program;
    here they are the same eager steps, so the loop computes what K calls
    of the step compute, and saves the host K - 1 loss readbacks and
    feeds."""
    step = make_train_step(module, criterion, optim_method, clipping,
                           compute_dtype, remat, accumulate_steps)

    def loop(opt_state, xs, ys, generator=None):
        return torch.stack([step(opt_state, xs[i], ys[i], generator)
                            for i in range(xs.shape[0])])

    return loop


class _DispatchAhead:
    """Pipelined per-step loss readout (the reference's ``_DispatchAhead``).

    Reading a step's loss on the host waits until the card has finished
    that step, so a read inside the loop would leave the card idle while
    the host queues the next step. Instead the host queues step N, then
    reads step N - ``depth``'s loss (``BIGDL_TPU_DISPATCH_AHEAD``, 1; 0
    reads each step's own): the card always has the next step queued.
    Summaries and log lines get the drained step's loss under its own
    iteration number; loss-based triggers may fire up to ``depth`` steps
    late. A K-step dispatch pushes its ``[K]`` losses once, and a drain
    replays each step under its own iteration number.

    Both loops route every step through here, so this class owns the
    training loop's instruments, labelled ``loop`` (``"local"`` or
    ``"distri"``): ``bigdl_train_steps_total``, ``_records_total``,
    ``_dispatches_total``, ``_records_per_sec``,
    ``_dispatch_queue_depth``, ``bigdl_sync_timeouts_total`` (a readback
    longer than ``BIGDL_TPU_SYNC_TIMEOUT_S``, 0: off) and a
    ``StepTimeAnomalyDetector`` fed each steady drain's step time.
    """

    def __init__(self, driver_state, summary, log_fn, loop="local"):
        self.depth = max(0, get_flag("BIGDL_TPU_DISPATCH_AHEAD", 1, int))
        self.pending = collections.deque()
        self.driver_state = driver_state
        self.summary = summary
        self.log_fn = log_fn
        self.last_drain = None
        self.last_rate = None
        reg = obs.default_registry()
        lbl = ("loop",)
        self._obs_steps = reg.counter(
            "bigdl_train_steps_total", "optimizer steps completed",
            lbl).labels(loop)
        self._obs_records = reg.counter(
            "bigdl_train_records_total", "training records consumed",
            lbl).labels(loop)
        self._obs_dispatches = reg.counter(
            "bigdl_train_dispatches_total",
            "jitted train-step/loop launches", lbl).labels(loop)
        self._obs_rate = reg.gauge(
            "bigdl_train_records_per_sec",
            "drained-step training throughput", lbl).labels(loop)
        self._obs_queue = reg.gauge(
            "bigdl_train_dispatch_queue_depth",
            "dispatched-ahead steps awaiting loss readback", lbl).labels(loop)
        self.sync_timeout_s = get_flag("BIGDL_TPU_SYNC_TIMEOUT_S", 0.0, float)
        self._obs_sync_timeouts = reg.counter(
            "bigdl_sync_timeouts_total",
            "blocking loss-readback syncs over BIGDL_TPU_SYNC_TIMEOUT_S",
            lbl).labels(loop)
        self.anomaly = obs.StepTimeAnomalyDetector(loop=loop)

    def clear(self):
        """Drop the queued readouts (steps of a failed run)."""
        self.pending.clear()
        self.last_drain = None
        self.last_rate = None

    def push(self, loss, n, t0, k=1):
        self.pending.append({"loss": loss, "n": n, "t0": t0, "k": k,
                             "neval": self.driver_state["neval"],
                             "epoch": self.driver_state["epoch"]})
        self._obs_dispatches.inc()
        while len(self.pending) > self.depth:
            self._drain_one()
        self._obs_queue.set(len(self.pending))

    def drain_all(self):
        while self.pending:
            self._drain_one()

    def reset_epoch(self):
        self.last_drain = None

    def _drain_one(self):
        ent = self.pending.popleft()
        k = ent["k"]
        with obs.span("train/drain", neval=ent["neval"], k=k):
            t_sync = time.perf_counter()
            # inside the timed window: an injected delay reads as a slow
            # sync and exercises the timeout accounting below
            fault_point("train.drain", neval=ent["neval"])
            # the one wait for the card: this step (or K-step loop) is done
            losses = ent["loss"].detach().float().reshape(-1).tolist()
            sync_s = time.perf_counter() - t_sync
        if self.sync_timeout_s > 0 and sync_s > self.sync_timeout_s:
            self._obs_sync_timeouts.inc()
            logger.warning(
                "loss readback for iteration %d blocked %.3fs (budget "
                "%.3fs): the card (in the distributed loop, the allreduce) "
                "is running long", ent["neval"], sync_s, self.sync_timeout_s)
        loss_f = losses[-1]
        now = time.time()
        prev = self.last_drain if self.last_drain is not None else ent["t0"]
        dt = now - prev
        self.last_drain = now
        if dt < 1e-4 and self.last_rate is not None:
            rate = self.last_rate      # a burst of drains says nothing
        else:
            rate = ent["n"] / max(dt, 1e-9)
            # a steady drain paces the card: dt / k is about one step
            self.anomaly.observe(dt / k)
        self.last_rate = rate
        self._obs_steps.inc(k)
        self._obs_records.inc(ent["n"])
        self._obs_rate.set(rate)
        self.driver_state["loss"] = loss_f
        if self.summary is not None:
            for i in range(k):
                self.summary.add_scalar("Loss", losses[i], ent["neval"] + i)
                self.summary.add_scalar("Throughput", rate, ent["neval"] + i)
        if k > 1:
            ent = {**ent, "neval": ent["neval"] + k - 1}
        self.log_fn(ent, loss_f, rate)


class Optimizer:
    """Facade and factory (reference ``optim/Optimizer.scala:42,466``):
    ``Optimizer(model=, dataset=, criterion=)`` returns a
    :class:`LocalOptimizer`, or a ``DistriOptimizer`` for ``mesh=`` or a
    ``DistributedDataSet`` (``parallel/distri_optimizer.py``).

    Keywords: ``seed`` (default 1, as the reference's: the random
    stream of the layers that draw while training, such as ``Dropout``
    and GPT's dropout; a model whose ``forward`` takes a ``generator``
    gets one at every step, ``nn.module.takes_generator``),
    ``accumulate_steps`` (K micro-batches a step, K must divide the batch
    rows) and ``steps_per_loop`` (K steps a dispatch over ``[K, batch]``
    superbatches; default ``BIGDL_TPU_STEPS_PER_LOOP``, 1). The model
    trains where its parameters are. The draws are torch's, not
    ``jax.random``'s: the same seed gives the same masks run to run, not
    the reference's masks.
    """

    def __new__(cls, model=None, dataset=None, criterion=None, **kwargs):
        if cls is Optimizer:
            from bigdl_tpu_torch.dataset.dataset import DistributedDataSet
            from bigdl_tpu_torch.parallel.distri_optimizer import \
                DistriOptimizer
            if isinstance(dataset, DistributedDataSet) \
                    or kwargs.get("mesh") is not None:
                return super().__new__(DistriOptimizer)
            return super().__new__(LocalOptimizer)
        return super().__new__(cls)

    def __init__(self, model=None, dataset=None, criterion=None, **kwargs):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method = None
        self.end_when = Trigger.max_epoch(1)
        self.validation_trigger = None
        self.validation_dataset = None
        self.validation_methods = None
        self.checkpoint_trigger = None
        self.checkpoint_path = None
        self.train_summary = None
        self.validation_summary = None
        self.clipping = None
        self.metrics = {}
        self.seed = int(kwargs.get("seed", 1))
        self._opt_state = None
        self._ckpt_thread = None
        self._ckpt_exc = []
        accumulate_steps = kwargs.get("accumulate_steps", 1)
        if accumulate_steps != int(accumulate_steps) \
                or int(accumulate_steps) < 1:
            raise ValueError(
                f"accumulate_steps must be a positive integer, got "
                f"{accumulate_steps!r}")
        self.accumulate_steps = int(accumulate_steps)
        steps_per_loop = kwargs.get("steps_per_loop")
        if steps_per_loop is None:
            steps_per_loop = get_flag("BIGDL_TPU_STEPS_PER_LOOP", 1, int)
        if steps_per_loop != int(steps_per_loop) or int(steps_per_loop) < 1:
            raise ValueError(
                f"steps_per_loop must be a positive integer, got "
                f"{steps_per_loop!r}")
        self.steps_per_loop = int(steps_per_loop)

    # ----- builder API (reference setXxx) -----------------------------------
    def set_optim_method(self, method):
        self.optim_method = method
        return self

    def set_end_when(self, trigger):
        self.end_when = trigger
        return self

    def set_validation(self, trigger, dataset, methods):
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = methods
        return self

    def set_checkpoint(self, path, trigger):
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def set_train_summary(self, summary):
        """Any object with ``add_scalar(tag, value, step)`` (and
        ``add_histogram`` for a ``_summary_trigger["Parameters"]``)."""
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary):
        self.validation_summary = summary
        return self

    def set_gradient_clipping_by_l2_norm(self, max_norm):
        self.clipping = lambda g: clip_by_global_norm(g, max_norm)
        return self

    def set_constant_gradient_clipping(self, min_value, max_value):
        self.clipping = lambda g: clip_by_value(g, min_value, max_value)
        return self

    def disable_gradient_clipping(self):
        self.clipping = None
        return self

    # ----- shared helpers ---------------------------------------------------
    def _ensure_ready(self):
        if self.optim_method is None:
            self.optim_method = SGD()

    def _generator(self, device):
        """A generator on ``device`` seeded from ``seed`` when the model's
        forward takes one, else None."""
        if not takes_generator(self.model):
            return None
        return torch.Generator(device=device).manual_seed(self.seed)

    def _summary_trigger(self, name):
        ts = self.train_summary
        return (getattr(ts, "_summary_trigger", {}).get(name)
                if ts is not None else None)

    def _plan_chunk(self, driver_state, kmax):
        """The largest j <= kmax steps that the K-step loop may run before
        a trigger needs the host: no validation, checkpoint, end or
        "Parameters" summary trigger fires strictly inside the chunk
        (probed with neval advanced and loss/score as they stand)."""
        triggers = [self.end_when, self.validation_trigger,
                    self.checkpoint_trigger,
                    self._summary_trigger("Parameters")]
        triggers = [t for t in triggers if t is not None]
        base = dict(driver_state)
        for j in range(1, kmax):
            probe = {**base, "neval": base["neval"] + j}
            if any(t(probe) for t in triggers):
                return j
        return kmax

    def _validate(self):
        if self.validation_dataset is None:
            return {}
        agg = Evaluator(self.model).evaluate(self.validation_dataset,
                                             self.validation_methods)
        results = {}
        for name, r in agg.items():
            value, _ = r.result()
            results[name] = value
            logger.info("validation %s = %.4f", name, value)
        return results

    def _record_plateau(self, score):
        """Feed the validation score to a ``Plateau`` schedule and write
        its factor into each optimizer state's ``plateau_mult``."""
        sched = getattr(self.optim_method, "schedule", None)
        if isinstance(sched, Plateau):
            mult = sched.record(score)
            for opt_state in self._opt_states():
                if "plateau_mult" in opt_state:
                    opt_state["plateau_mult"].fill_(mult)

    def _checkpoint(self, neval, opt_state):
        """Write ``model.<neval>`` (the module in the native format,
        ``utils/serializer.py`` ``save_module``, as the reference's
        ``optimizer.py:597-604``) and ``optimMethod.<neval>``
        (``OptimMethod.save``) under the checkpoint path, each through
        ``atomic_file_swap``. The host copy of the weights is taken here,
        synchronously; the files are written behind a thread
        (``BIGDL_TPU_ASYNC_CHECKPOINT``, on), one write at a time, and a
        writer's exception surfaces at the next checkpoint or at the end
        of ``optimize()``."""
        if not self.checkpoint_path:
            return
        self._join_checkpoint()
        weights = cpu_copy(dict(self.model.state_dict()))
        state = cpu_copy(opt_state)
        method = self.optim_method
        model = self.model
        path = self.checkpoint_path

        def write():
            fault_point("ckpt.write", neval=neval)
            file_makedirs(path)
            model_path = path_join(path, f"model.{neval}")
            method_path = path_join(path, f"optimMethod.{neval}")
            atomic_file_swap(model_path, lambda p: save_module(
                model, p, overwrite=True, state_dict=weights))
            atomic_file_swap(method_path,
                             lambda p: method.save(p, state,
                                                   overwrite=True))
            # storage corruption the atomic rename cannot prevent: a
            # resume must fall back to an older pair
            faults.corrupt_file("ckpt.write", model_path)
            faults.corrupt_file("ckpt.write", method_path)

        self._spawn_ckpt_writer(f"ckpt-{neval}", write)

    def _spawn_ckpt_writer(self, name, write):
        """Run ``write`` behind a thread named ``name``
        (``BIGDL_TPU_ASYNC_CHECKPOINT``, on; else here); its exception
        surfaces at the next :meth:`_join_checkpoint`."""
        if not get_flag("BIGDL_TPU_ASYNC_CHECKPOINT", True, bool):
            write()
            return
        exc = []

        def run():
            try:
                write()
            except BaseException as e:  # surfaced at the next join
                exc.append(e)

        self._ckpt_thread = threading.Thread(target=run, name=name,
                                             daemon=True)
        self._ckpt_exc = exc
        self._ckpt_thread.start()

    def _join_checkpoint(self):
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
            if self._ckpt_exc:
                exc, self._ckpt_exc = self._ckpt_exc, []
                raise RuntimeError("async checkpoint write failed") \
                    from exc[0]

    def _install_preempt_guard(self):
        """Arm the SIGTERM guard at ``optimize()`` entry
        (``BIGDL_TPU_PREEMPT_GUARD``, on; nothing off the main thread,
        where CPython delivers no signal)."""
        if get_flag("BIGDL_TPU_PREEMPT_GUARD", True, bool):
            preempt.install()

    def _check_preempt(self, driver_state, ahead, save):
        """The preemption point, polled once a step: when the guard saw
        SIGTERM (or the fault harness flipped it), drain the readout so
        the loss and ``neval`` are current, write a final checkpoint with
        ``save``, join the writer, and raise ``TrainingPreempted``."""
        if not preempt.requested():
            return
        reason = preempt.reason()
        if ahead is not None:
            ahead.drain_all()
        neval = driver_state["neval"]
        logger.warning("preempted (%s): writing final checkpoint at "
                       "iteration %d before exit", reason, neval)
        with obs.span("train/preempt_checkpoint", neval=neval):
            save()
            self._join_checkpoint()
        raise TrainingPreempted(
            f"training preempted ({reason}); final checkpoint at "
            f"iteration {neval}", neval=neval)

    def optimize(self):
        raise NotImplementedError

    # ----- the loop LocalOptimizer and DistriOptimizer share ---------------
    # A subclass sets ``self._fn`` (``fn(x, y) -> loss``, or with
    # ``steps_per_loop`` > 1 ``fn(xs, ys) -> losses``) and gives
    # ``_opt_states`` (the optimizer states whose counters the loop
    # advances) and ``_place``/``_place_super`` (the checks, and the
    # layout, of a fed batch or superbatch).
    def _train_epoch(self, ds, device, ahead, driver_state):
        """One epoch: shuffle, the batches (or superbatches), the readout
        caught up, the epoch-boundary hooks, and the epoch counters."""
        t_epoch = time.time()
        ds.shuffle()
        driver_state["epoch_finished"] = False
        ahead.reset_epoch()
        if self.steps_per_loop > 1:
            records = self._superbatch_epoch(ds, device, ahead, driver_state)
        else:
            records = self._epoch(ds, device, ahead, driver_state)
        t_tail = time.time()
        ahead.drain_all()   # catch up before the epoch-boundary hooks
        self.metrics["step_time"] += time.time() - t_tail
        driver_state["epoch_finished"] = True
        self._hooks(driver_state)
        logger.info("Epoch %d done (%d records in %.1fs)",
                    driver_state["epoch"], records, time.time() - t_epoch)
        driver_state["epoch"] += 1
        for opt_state in self._opt_states():
            opt_state["epoch"].fill_(driver_state["epoch"])

    def _count_dispatch(self, k):
        """Per-dispatch accounting a subclass adds (k steps)."""

    def _dispatched(self, ahead, driver_state, loss, n, t0, k):
        ahead.push(loss, n, t0, k=k)
        self.metrics["steps"] += k
        self.metrics["dispatches"] += 1
        self.metrics["step_time"] += time.time() - t0
        self.metrics["records"] += n
        self._count_dispatch(k)
        driver_state["neval"] += k
        self._hooks(driver_state, ahead=ahead)

    def _epoch(self, ds, device, ahead, driver_state):
        records = 0
        t_data = time.time()
        for item, (x, y) in DeviceFeed(device)(ds.data(train=True)):
            x, y = self._place(item, x, y)
            t0 = time.time()
            self.metrics["data_time"] += t0 - t_data
            obs.record_span("train/feed", t_data, t0,
                            neval=driver_state["neval"])
            fault_point("train.step", neval=driver_state["neval"])
            with obs.span("train/dispatch", neval=driver_state["neval"]):
                loss = self._fn(x, y)
            records += x.shape[0]
            self._dispatched(ahead, driver_state, loss, x.shape[0], t0, 1)
            if self.end_when(driver_state):
                break
            t_data = time.time()
        return records

    def _superbatch_epoch(self, ds, device, ahead, driver_state):
        """One epoch of ``steps_per_loop`` mode: superbatches stacked on
        the ``Prefetch`` thread (``ToSuperBatch``), moved by
        ``DeviceFeed``, each run by one K-step loop, or by a few shorter
        ones where a trigger falls inside it."""
        feed = DeviceFeed(device)(Prefetch(2)(
            ToSuperBatch(self.steps_per_loop)(ds.data(train=True))))
        records = 0
        t_data = time.time()
        for sb, (xs, ys) in feed:
            xs, ys = self._place_super(sb, xs, ys)
            start = 0
            while start < sb.k:
                j = self._plan_chunk(driver_state, sb.k - start)
                t0 = time.time()
                self.metrics["data_time"] += t0 - t_data
                obs.record_span("train/feed", t_data, t0,
                                neval=driver_state["neval"])
                fault_point("train.step", neval=driver_state["neval"])
                with obs.span("train/dispatch", neval=driver_state["neval"],
                              k=j):
                    losses = self._fn(xs[start:start + j],
                                      ys[start:start + j])
                n = sum(sb.sizes[start:start + j])
                records += n
                self._dispatched(ahead, driver_state, losses, n, t0, j)
                if self.end_when(driver_state):
                    return records
                start += j
                t_data = time.time()
        return records

    def _validate_now(self):
        return self._validate()

    def _checkpoint_now(self, driver_state):
        self._checkpoint(driver_state["neval"], self._opt_state)

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self.model.parameters()])

    def _hooks(self, driver_state, ahead=None):
        self._check_preempt(driver_state, ahead,
                            lambda: self._checkpoint_now(driver_state))
        # decide which hooks fire, then catch the loss readout up: hooks
        # read driver_state, whose loss lags the queue otherwise
        do_val = (self.validation_trigger is not None
                  and self.validation_trigger(driver_state))
        do_ckpt = (self.checkpoint_trigger is not None
                   and self.checkpoint_trigger(driver_state))
        hist = self._summary_trigger("Parameters")
        do_hist = hist is not None and hist(driver_state)
        if ahead is not None and (do_val or do_ckpt or do_hist):
            ahead.drain_all()
        if do_val:
            with obs.span("train/validate", neval=driver_state["neval"]):
                results = self._validate_now()
            if results:
                first = next(iter(results.values()))
                driver_state["score"] = first
                self._record_plateau(first)
                if self.validation_summary is not None:
                    for name, v in results.items():
                        self.validation_summary.add_scalar(
                            name, v, driver_state["neval"])
        if do_ckpt:
            with obs.span("train/checkpoint", neval=driver_state["neval"]):
                self._checkpoint_now(driver_state)
        if do_hist:
            self.train_summary.add_histogram(
                "Parameters", self._flat_params().cpu().numpy(),
                driver_state["neval"])

    def metrics_summary(self):
        """Per-phase averages (reference ``Metrics.summary``,
        ``optim/Metrics.scala:103``)."""
        m = self.metrics
        s = max(m.get("steps", 0), 1)
        wall = m.get("data_time", 0.0) + m.get("step_time", 0.0)
        return {"steps": m.get("steps", 0),
                "data_time_avg_s": m.get("data_time", 0.0) / s,
                "step_time_avg_s": m.get("step_time", 0.0) / s,
                "throughput_rec_s": (m.get("records", 0) / wall
                                     if wall > 0 else 0.0),
                "feed_wait_frac": (m.get("data_time", 0.0) / wall
                                   if wall > 0 else 0.0)}


def _check_accumulate(k, rows):
    if k > 1 and rows % k:
        raise ValueError(
            f"accumulate_steps={k} must divide the batch rows ({rows}); "
            "keep SampleToMiniBatch's default pad_last=True, or set "
            "drop_last=True")


class LocalOptimizer(Optimizer):
    """The single-device loop (reference ``optim/LocalOptimizer.scala:42``).

    ``metrics``: ``steps``, ``data_time`` (waiting for the next batch),
    ``step_time`` (queueing steps and reading losses back), ``records``
    and ``dispatches`` (steps at K = 1; K-step loops, as the reference
    counts its scans, with ``steps_per_loop=K``, a loop cut short where a
    trigger fires inside it, as the reference's ``_plan_chunk`` cuts its
    scan)."""

    def optimize(self):
        ds = self.dataset
        self._ensure_ready()
        self._install_preempt_guard()
        model = self.model
        opt_state = self.optim_method.init_state(
            dict(model.named_parameters()))
        self._opt_state = opt_state
        build = make_train_loop if self.steps_per_loop > 1 \
            else make_train_step
        fn = build(model, self.criterion, self.optim_method, self.clipping,
                   accumulate_steps=self.accumulate_steps)
        # one stream for the whole run: each step (or each step of a
        # K-step loop) draws its masks from where the last left it, as the
        # reference splits its key once a step
        generator = self._generator(model_device(model))
        self._fn = lambda x, y: fn(opt_state, x, y, generator)
        self.metrics = {"steps": 0, "data_time": 0.0, "step_time": 0.0,
                        "records": 0, "dispatches": 0}
        driver_state = {"epoch": 1, "neval": 1, "loss": None, "score": None,
                        "epoch_finished": False}

        def log_iter(ent, loss_f, rate):
            logger.info(
                "Epoch %d iter %d loss %.4f throughput %.1f records/s",
                ent["epoch"], ent["neval"], loss_f, rate)

        ahead = _DispatchAhead(driver_state, self.train_summary, log_iter)
        while not self.end_when(driver_state):
            self._train_epoch(ds, model_device(model), ahead, driver_state)
        self._join_checkpoint()
        return model

    def _opt_states(self):
        return [self._opt_state]

    def _place(self, item, x, y):
        _check_accumulate(self.accumulate_steps, x.shape[0])
        return x, y

    def _place_super(self, sb, xs, ys):
        _check_accumulate(self.accumulate_steps, xs.shape[1])
        return xs, ys
