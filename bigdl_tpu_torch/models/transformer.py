"""Transformer encoder and BERT (the port of
``bigdl_tpu/models/transformer.py``: ``TransformerEncoderLayer``,
``BERT``, ``bert_base``, ``BertForMLM``, ``bert_mlm_flops_per_token`` and
the dp x sp train step ``make_sp_train_step``).

The encoder layer is post-LN, as the original BERT:
``ln1(x + drop(attn(x)))``, then ``ln2(x + drop(fc2(gelu(fc1(x)))))``, the
GELU in its tanh form (``jax.nn.gelu``'s default). Dropout draws from the
step's ``torch.Generator`` in training mode and is the identity without
one; the reference folds its key per layer and site, which a torch
generator cannot reproduce, so the two agree in distribution, not bit for
bit.

``BERT`` embeds token ids (or the table ``[ids, types]``, the reference's
``Table`` as a list) with token, position and token-type embeddings and
one LayerNorm, then runs the layers (``remat=True``: each one under
``utils.remat.checkpoint``). A model built with ``sequence_parallel=
("ring_inner", axis, n)`` is one shard of a sequence-parallel group: its
forward takes the group's list of ``n`` chunks and returns the list, shard
``s`` adding the position embeddings of its global positions ``[s *
T_local, (s + 1) * T_local)``. Every model here computes through its
class's ``group_forward(models, xs, generator)`` over the group's shards,
each a copy of the model on its device; an unsharded model is the group
of one (``parallel.sequence.sequence_forward``).

:func:`make_sp_train_step` is single-controller, as ``DistriOptimizer``
is: a dp x sp mesh is a nested list of devices ``mesh[d][s]`` (a device
may repeat), each shard holds a replica of the model on its device, and
the reference's ``pmean``s are sums in shard order divided by ``dp *
sp``.
"""

from __future__ import annotations

import copy
import functools

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn import Dropout, LayerNormalization, Linear
from bigdl_tpu_torch.parallel.layout import reduce_sum
from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               attention_group,
                                               sequence_forward)
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.remat import checkpoint_list


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (see module docstring)."""

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference's layer record; the model that holds it builds it."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec, built_inside
        return NativeSpec("bigdl_tpu.models.transformer:"
                          "TransformerEncoderLayer", cls,
                          "hidden_size attn ln1 ln2 fc1 fc2 dropout",
                          get={"dropout": lambda m: m.drop.p},
                          build=built_inside("BERT"))

    def __init__(self, hidden_size, n_heads, intermediate_size=None,
                 dropout=0.0, sequence_parallel=None, causal=False,
                 device=None, dtype=torch.float32):
        super().__init__()
        inter = intermediate_size or 4 * hidden_size
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.hidden_size = hidden_size
        self.attn = MultiHeadAttention(hidden_size, n_heads, causal,
                                       sequence_parallel, **kw)
        self.ln1 = LayerNormalization(hidden_size, **kw)
        self.ln2 = LayerNormalization(hidden_size, **kw)
        self.fc1 = Linear(hidden_size, inter, **kw)
        self.fc2 = Linear(inter, hidden_size, **kw)
        self.drop = Dropout(dropout)

    def after_attention(self, x, h, generator=None):
        """The layer after its attention output ``h`` of ``x``."""
        x = self.ln1(x + self.drop(h, generator))
        h = self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return self.ln2(x + self.drop(h, generator))

    def forward(self, x, generator=None):
        """x (B, T, hidden) through the layer; a ``ring_inner`` layer takes
        and returns its group's list of chunks."""
        if self.attn.ring_inner:
            return encoder_group([self] * len(x), list(x), generator)
        return self.after_attention(x, self.attn(x), generator)


def encoder_group(layers, xs, generator=None):
    """One encoder layer over a group's shards: ``layers`` each shard's
    copy of the layer, ``xs`` their inputs."""
    hs = attention_group([l.attn for l in layers], xs)
    return [l.after_attention(x, h, generator)
            for l, x, h in zip(layers, xs, hs)]


def _ids_and_types(x):
    """``(ids, types or None)`` of a tensor of ids or a table ``[ids,
    types]``."""
    if isinstance(x, (list, tuple)):
        return x[0], x[1]
    return x, None


class BERT(nn.Module):
    """BERT encoder (base: 12 layers, hidden 768, 12 heads) returning the
    last layer's states (B, T, hidden); see module docstring."""

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference's record, built back here at the file's widths and
        tensor type; the weights in ``convert``'s BERT layout."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec
        return NativeSpec("bigdl_tpu.models.transformer:BERT", cls,
                          "vocab_size hidden_size max_position "
                          "type_vocab_size layers ln remat",
                          get={"layers": lambda m: list(m.layers)},
                          build=lambda a, make, at: cls(
                              **_native_widths(a, at)),
                          trees=_native_trees, load_trees=_native_load_trees)

    def __init__(self, vocab_size=30522, hidden_size=768, n_layers=12,
                 n_heads=12, max_position=512, type_vocab_size=2,
                 intermediate_size=None, dropout=0.0, sequence_parallel=None,
                 remat=False, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.sequence_parallel = sequence_parallel
        self.remat = remat
        self.tok_emb = nn.Parameter(torch.empty(vocab_size, hidden_size,
                                                **kw))
        self.pos_emb = nn.Parameter(torch.empty(max_position, hidden_size,
                                                **kw))
        self.type_emb = nn.Parameter(torch.empty(type_vocab_size,
                                                 hidden_size, **kw))
        self.ln = LayerNormalization(hidden_size, **kw)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(hidden_size, n_heads,
                                    self.intermediate_size, dropout,
                                    sequence_parallel, **kw)
            for _ in range(n_layers))

    @property
    def device(self):
        return self.tok_emb.device

    def embed(self, x, start=0):
        """LayerNorm of the token, position and (given a table) token-type
        embeddings of ``x``, at positions ``[start, start + T)``."""
        ids, types = _ids_and_types(x)
        ids = torch.as_tensor(ids, device=self.device).long()
        t = ids.shape[1]
        if start + t > self.max_position:
            raise ValueError(f"positions up to {start + t} pass "
                             f"max_position {self.max_position}")
        h = F.embedding(ids, self.tok_emb) + self.pos_emb[start:start + t]
        if types is not None:
            types = torch.as_tensor(types, device=self.device).long()
            h = h + F.embedding(types, self.type_emb)
        return self.ln(h)

    def forward(self, x, generator=None):
        """The states (B, T, hidden) of ids (B, T) or ``[ids, types]``."""
        return sequence_forward(self, x, generator)

    @staticmethod
    def group_forward(berts, xs, generator=None):
        """The states of each shard's input ``xs[s]`` through its copy
        ``berts[s]``, shard ``s`` at global positions from ``s *
        T_local``."""
        hs = [m.embed(x, s * _ids_and_types(x)[0].shape[1])
              for s, (m, x) in enumerate(zip(berts, xs))]
        for i in range(len(berts[0].layers)):
            layers = [m.layers[i] for m in berts]
            if berts[0].remat:
                hs = checkpoint_list(functools.partial(encoder_group, layers),
                                     generator, hs)
            else:
                hs = encoder_group(layers, hs, generator)
        return hs


def bert_base(sequence_parallel=None, **kw):
    return BERT(sequence_parallel=sequence_parallel, **kw)


class BertForMLM(nn.Module):
    """BERT plus an untied dense MLM head: (B*T, vocab) logits, to pair
    with ``CrossEntropyCriterion`` on the flattened token labels (label
    -1, its ``padding_value``, for unpredicted positions)."""

    @classmethod
    def native_spec(cls):
        """The native format's entry, as :meth:`BERT.native_spec`."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec
        return NativeSpec("bigdl_tpu.models.transformer:BertForMLM", cls,
                          "vocab_size bert head",
                          build=lambda a, make, at: cls(
                              **_native_widths(a["bert"].attrs, at)),
                          trees=_native_trees, load_trees=_native_load_trees)

    def __init__(self, vocab_size=30522, hidden_size=768, n_layers=12,
                 n_heads=12, max_position=512, device=None,
                 dtype=torch.float32, **kw):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.bert = BERT(vocab_size=vocab_size, hidden_size=hidden_size,
                         n_layers=n_layers, n_heads=n_heads,
                         max_position=max_position, device=device,
                         dtype=dtype, **kw)
        self.head = Linear(hidden_size, vocab_size, device=device,
                           dtype=dtype)

    @property
    def sequence_parallel(self):
        return self.bert.sequence_parallel

    def forward(self, x, generator=None):
        return sequence_forward(self, x, generator)

    @staticmethod
    def group_forward(models, xs, generator=None):
        hs = BERT.group_forward([m.bert for m in models], xs, generator)
        return [m.head(h).reshape(-1, m.vocab_size)
                for m, h in zip(models, hs)]


def _native_widths(b, at):
    """A ``BERT``'s constructor values from its native record's
    attributes ``b`` (its layers' records give the heads, the inner width
    and the dropout), on ``at.device`` in ``at.dtype``."""
    layer = b["layers"][0].attrs if b["layers"] else None
    return dict(vocab_size=b["vocab_size"], hidden_size=b["hidden_size"],
                n_layers=len(b["layers"]),
                n_heads=layer["attn"].attrs["n_heads"] if layer else 1,
                max_position=b["max_position"],
                type_vocab_size=b["type_vocab_size"],
                intermediate_size=(layer["fc1"].attrs["output_size"]
                                   if layer else None),
                dropout=layer["dropout"] if layer else 0.0,
                remat=b["remat"], device=at.device,
                dtype=at.dtype or torch.float32)


def _native_trees(model, state_dict):
    from bigdl_tpu_torch import convert
    return convert.bert_params_to_jax(state_dict, tensors=True), ()


def _native_load_trees(model, params, state):
    from bigdl_tpu_torch import convert
    return convert.bert_params_from_jax(params)


def bert_mlm_flops_per_token(n_layers=12, h=768, s=512, vocab=30522,
                             inter=None):
    """Forward operations a token of ``BertForMLM`` (the reference's
    formula): QKV and O projections 8h^2, the two MLP products 4*h*inter,
    the attention products 4*s*h a layer, and the MLM vocab projection
    2*h*vocab; embedding lookups not counted."""
    inter = inter or 4 * h
    per_layer = 8 * h * h + 4 * h * inter + 4 * s * h
    return n_layers * per_layer + 2 * h * vocab


def _block(x, rows, cols, device):
    """Rows and columns of a (B, T) tensor, or of each of a table's, on
    ``device``."""
    if isinstance(x, (list, tuple)):
        return [_block(e, rows, cols, device) for e in x]
    return x[rows, cols].to(device)


class SequenceParallelStep:
    """The dp x sp train step of :func:`make_sp_train_step`:
    ``step(opt_state, x, y) -> loss``, updating ``model``'s parameters
    and ``opt_state`` in place.

    ``replicas[d][s]`` holds shard (d, s)'s copy of the model on
    ``mesh[d][s]`` (``model`` itself at (0, 0) when it lives there). A
    step splits the rows of ``x`` (B, T) (or of each of a table's) and of
    the labels ``y`` (B, T) over the ``dp`` rows of the mesh and their
    positions over the ``sp`` shards of a row; each shard's local loss is
    ``criterion`` of its output and labels. Then, as the reference's
    ``shard_map`` computes it:

    - loss: the mean of the dp * sp local losses (with padded labels, a
      mean of local means, not the global masked mean);
    - gradients: each replica's gradient of its group's summed local
      losses (the backward of the ring carries every shard's cotangent to
      the shards whose keys it read), summed over all replicas in shard
      order and divided by dp * sp;
    - one ``optim_method.update`` of ``model``'s parameters, whose bits
      are then copied into every other replica.

    ``model``'s weights are copied into the replicas when the step is
    built and after every update; a caller who changes them in between
    calls :meth:`sync`. float32, as the reference's step (no compute
    type); no dropout (the reference's step passes no rng)."""

    def __init__(self, model, criterion, optim_method, mesh):
        self.model = model
        self.criterion = criterion
        self.optim_method = optim_method
        self.mesh = [[resolve_device(d) for d in row] for row in mesh]
        self.params = dict(model.named_parameters())
        self.device = next(iter(self.params.values())).device
        self.replicas = [[model if (d, s) == (0, 0) and dev == self.device
                          else copy.deepcopy(model).to(dev)
                          for s, dev in enumerate(row)]
                         for d, row in enumerate(self.mesh)]
        self._replica_params = [dict(r.named_parameters())
                                for row in self.replicas for r in row]
        self.sync()

    @torch.no_grad()
    def sync(self):
        """Copy ``model``'s parameters into every other replica."""
        for params in self._replica_params:
            for name, p in params.items():
                if p is not self.params[name]:
                    p.copy_(self.params[name])

    def _shards(self, x, d, b, t):
        """Mesh row ``d``'s shards of ``x``: its ``b`` rows, ``t``
        positions a shard."""
        rows = slice(d * b, (d + 1) * b)
        return [_block(x, rows, slice(s * t, (s + 1) * t), dev)
                for s, dev in enumerate(self.mesh[d])]

    def _sizes(self, x):
        ids = _ids_and_types(x)[0]
        dp, sp = len(self.mesh), len(self.mesh[0])
        b, t = ids.shape
        if b % dp or t % sp:
            raise ValueError(f"a batch of {b} x {t} does not split over a "
                             f"{dp} x {sp} mesh")
        return b // dp, t // sp

    def forward(self, x):
        """The shards' outputs of ``x``, ``outs[d][s]`` on each shard's
        device, as the step computes them (training mode)."""
        b, t = self._sizes(x)
        cls = type(self.model)
        outs = []
        for d, row in enumerate(self.replicas):
            for r in row:
                r.train()
            outs.append(cls.group_forward(row, self._shards(x, d, b, t)))
        return outs

    def loss_and_grads(self, x, y):
        """``(loss, grads)`` of the step (see class docstring), the
        gradients keyed by parameter name on ``model``'s device."""
        b, t = self._sizes(x)
        for params in self._replica_params:
            for p in params.values():
                p.grad = None
        y = torch.as_tensor(y)
        losses = []
        for d, outs in enumerate(self.forward(x)):
            ys = self._shards(y, d, b, t)
            local = [self.criterion(o, yy) for o, yy in zip(outs, ys)]
            reduce_sum(local).backward()
            losses += [l.detach() for l in local]
        dev = self.device
        count = torch.tensor(float(len(losses)), device=dev)
        loss = reduce_sum(losses).to(dev) / count
        grads = {}
        for name, p in self.params.items():
            parts = [ps[name].grad if ps[name].grad is not None
                     else torch.zeros_like(ps[name])
                     for ps in self._replica_params]
            grads[name] = reduce_sum(parts).to(dev) / count
        return loss, grads

    def __call__(self, opt_state, x, y):
        loss, grads = self.loss_and_grads(x, y)
        self.optim_method.update(grads, opt_state, self.params)
        self.sync()
        return loss


def make_sp_train_step(model, criterion, optim_method, mesh,
                       data_axis="data", seq_axis="seq"):
    """The dp x sp train step (a :class:`SequenceParallelStep`) over
    ``mesh``, a nested list of devices ``mesh[d][s]``: rows over
    ``data_axis``, positions over ``seq_axis`` (the reference's axis
    names). ``model`` must be built with ``sequence_parallel=("ring_inner",
    seq_axis, len(mesh[0]))``. ``opt_state`` comes from
    ``optim_method.init_state(dict(model.named_parameters()))``."""
    # the option of the model's first attention layer
    sp = next((m.sequence_parallel for m in model.modules()
               if isinstance(m, MultiHeadAttention)), None)
    n = len(mesh[0])
    if sp is None or tuple(sp) != ("ring_inner", seq_axis, n) \
            or any(len(row) != n for row in mesh):
        raise ValueError(f"make_sp_train_step over a {len(mesh)} x {n} "
                         f"mesh needs a model built with sequence_parallel="
                         f"('ring_inner', {seq_axis!r}, {n}); it has {sp}")
    return SequenceParallelStep(model, criterion, optim_method, mesh)


__all__ = ["BERT", "BertForMLM", "SequenceParallelStep",
           "TransformerEncoderLayer", "bert_base", "bert_mlm_flops_per_token",
           "encoder_group", "make_sp_train_step"]
