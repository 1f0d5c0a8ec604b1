"""Parameters between the JAX reference and the port.

- :func:`params_from_jax` turns the reference's GPT params pytree, given
  as numpy arrays (``{"gpt": {"tok_emb", "pos_emb", "ln_f", "layers":
  [{"attn": {wq, wk, wv, wo}, "ln1", "ln2", "fc1", "fc2"}]}}``), into
  the port's ``state_dict``, transposing Linear weights from the
  reference's ``(in, out)`` to torch's ``(out, in)``; an untied model's
  ``"head": {"weight"}`` is its ``head`` Linear's. Any tree of that
  layout maps the same way: the reference's gradients, or Adam's ``m`` and
  ``v`` slots, land on the port's parameter names;
- :func:`params_to_jax` is its inverse, a state_dict (or a dict of
  gradients or slots keyed by parameter name) back in the reference's
  layout, so tests can compare updated weights there;
- both take int8 weights: a leaf of the reference's ``quantize_params``,
  ``{"q": int8 (in, out), "scale": float32 (out,)}``, is an
  ``Int8Linear``'s ``weight`` (int8, transposed like the float weights)
  and ``scale`` buffers (load it into a model that went through
  ``nn.quantize_model``);
- :func:`init_params` makes seeded random weights in the reference's
  layout and with its initializers' distributions (token/position
  embeddings N(0, 0.02); attention Glorot-uniform; MLP weights and biases
  uniform in +-1/sqrt(fan_in); LayerNorm ones/zeros; an untied head
  uniform in +-1/sqrt(hidden)), for runs that cannot import JAX. The
  numbers come from numpy's generator, not JAX's.

ResNet (``models/resnet.py``): the reference's ``Graph`` keys its params
by node id; these functions take and give them keyed by layer name (the
reference's ``set_name`` names, which are the port's state_dict
prefixes):

- :func:`resnet_params_from_jax` turns ``params_by_name`` (``{name:
  {"weight", "bias"}}``: convolution weights HWIO, Linear weights (in,
  out), BN weight/bias) and ``state_by_name`` (``{bn name:
  {"running_mean", "running_var"}}``) into the port's state_dict:
  convolution weights OIHW, Linear weights (out, in);
- :func:`resnet_params_to_jax` is its inverse;
- :func:`init_resnet_params` / :func:`init_resnet_tree` draw seeded weights
  from the reference's initializers' distributions, as every layer's
  ``init_arrays`` does (``nn.module.init_state_dict``): convolutions
  Glorot-uniform (``Xavier``, fan in / out = kh * kw * channels), Linear
  weight and bias uniform in +-1/sqrt(in) (its ``RandomUniform``
  default), BN weight 1 and bias 0, running mean 0 and variance 1.

Containers and graphs (``nn/containers.py``, ``nn/graph.py``, LeNet):

- :func:`module_params_from_jax` turns a reference container's params
  and BN state (a list per container, one entry per child; the child of
  a ``MapTable``/``Bottle`` holds the container's params itself) into the
  port's state_dict, keyed ``"<i>.<leaf>"``. A reference ``Graph`` keys
  its params by node id; give them as the list ``[params[str(n.id)] for
  n in graph.exec_order]``, in the order the port's ``Graph`` numbers its
  nodes;
- :func:`module_params_to_jax` is its inverse, ``(params, state)`` in
  that layout (a graph's as such lists);
- both walk the recurrent wrappers as the reference nests their params:
  a ``Recurrent``'s (and ``RecurrentDecoder``'s) are its cell's, a
  ``MultiRNNCell``'s the list of its cells', a ``BiRecurrent``'s
  ``{"fwd", "bwd"}``, a ``TimeDistributed``'s its inner module's, and
  any module's that names its children in ``param_children`` (``(attribute,
  key)`` pairs: a ``Cond``'s ``{"then", "else"}``, a ``WhileLoop``'s its
  body's, a TF while frame's ``{"cond", "body"}``); each
  leaf is laid out by ``nn.module.jax_layout`` (convolution and
  convolutional-cell weights HWIO / DHWIO -> OIHW / OIDHW, Linear
  weights (in, out) -> (out, in), a transposed convolution's
  ``(kh, kw, I / G, O)`` -> ``(I, O / G, kh, kw)`` group by group;
  embeddings, ``Scale``, ``CAdd``, ``CMul`` and ``PReLU`` parameters, the
  TF loader's gather tables, cell products
  and tree weights as they are) and keeps an int8 type (the quantised layers'
  ``{"weight": int8, "scale", "bias", "in_scale"}``), other leaves
  float32;
- :func:`model_state_to_jax` / :func:`model_state_from_jax` carry a
  model's buffers alone, in the reference's layout (a container's lists,
  a ResNet's name-keyed dict), as a sharded checkpoint stores them.

BERT (``models/transformer.py``): :func:`bert_params_from_jax` and
:func:`bert_params_to_jax` map a ``BertForMLM`` tree (``{"bert": {"tok_emb",
"pos_emb", "type_emb", "ln", "layers": [...]}, "head": {"weight",
"bias"}}``) or a ``BERT`` tree (the inner dict) the same way, its layers as
GPT's; :func:`init_bert_tree` draws seeded params in that layout.
:func:`params_from_jax` stays GPT's.

LoRA adapters (``models/lora.py``): :func:`adapter_from_jax` takes a
reference adapter tree, its arrays pulled to numpy, as the port's tree:
the same arrays in the same orientation, checked by the digest.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from bigdl_tpu_torch.nn import (BiRecurrent, Bottle, Container, Graph,
                                MapTable, MultiRNNCell, Recurrent,
                                TimeDistributed)
from bigdl_tpu_torch.nn.module import (from_jax_layout, init_state_dict,
                                       jax_layout, jax_perm, to_jax_layout)


def _put(sd, key, arr, transpose=False, dtype=np.float32):
    if isinstance(arr, torch.Tensor):           # keeps its type
        sd[key] = (arr.T if transpose else arr).contiguous()
        return
    a = np.asarray(arr, dtype=dtype)
    # a C-ordered copy: torch shares the buffer, and the reference's arrays
    # may be read-only views
    sd[key] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def _put_weight(sd, pre, w):
    if isinstance(w, dict):                      # int8 {"q", "scale"}
        _put(sd, f"{pre}.weight", w["q"], transpose=True, dtype=np.int8)
        _put(sd, f"{pre}.scale", w["scale"])
    else:
        _put(sd, f"{pre}.weight", w, transpose=True)


def _put_ln(sd, pre, ln):
    _put(sd, f"{pre}.weight", ln["weight"])
    _put(sd, f"{pre}.bias", ln["bias"])


def _put_block(sd, pre, lp):
    """A transformer block's params (GPT's decoder block and BERT's encoder
    layer share the layout: ``attn``, ``ln1``, ``ln2``, ``fc1``, ``fc2``)
    under the key prefix ``pre``."""
    for w in ("wq", "wk", "wv", "wo"):
        _put_weight(sd, f"{pre}attn.{w}", lp["attn"][w])
    for ln in ("ln1", "ln2"):
        _put_ln(sd, f"{pre}{ln}", lp[ln])
    for fc in ("fc1", "fc2"):
        _put_weight(sd, f"{pre}{fc}", lp[fc]["weight"])
        _put(sd, f"{pre}{fc}.bias", lp[fc]["bias"])


def params_from_jax(tree):
    """The port's ``GPTForCausalLM`` state_dict from a reference params
    tree of numpy arrays (float32 CPU tensors; load it with
    ``model.load_state_dict``). An untied model's tree has ``"head":
    {"weight": (hidden, vocab)}``, which becomes ``head.weight``."""
    g = tree["gpt"]
    sd = collections.OrderedDict()
    _put(sd, "gpt.tok_emb", g["tok_emb"])
    _put(sd, "gpt.pos_emb", g["pos_emb"])
    for i, lp in enumerate(g["layers"]):
        _put_block(sd, f"gpt.layers.{i}.", lp)
    _put_ln(sd, "gpt.ln_f", g["ln_f"])
    if "head" in tree:
        _put_weight(sd, "head", tree["head"]["weight"])
    return sd


def _get(sd, key, transpose=False, tensors=False):
    t = sd[key].detach().cpu()
    if tensors:                                 # a tensor of its own type
        return (t.T if transpose else t).contiguous()
    a = (t if t.dtype == torch.int8 else t.float()).numpy()
    return np.array(a.T if transpose else a, order="C")


def _get_weight(sd, pre, tensors=False):
    if f"{pre}.scale" in sd:
        return {"q": _get(sd, f"{pre}.weight", True, tensors),
                "scale": _get(sd, f"{pre}.scale", tensors=tensors)}
    return _get(sd, f"{pre}.weight", True, tensors)


def _get_ln(sd, pre, tensors=False):
    return {"weight": _get(sd, f"{pre}.weight", tensors=tensors),
            "bias": _get(sd, f"{pre}.bias", tensors=tensors)}


def _get_blocks(sd, pre, tensors=False):
    """Every block ``{pre}{i}.`` of a state_dict in the reference's layout
    (the inverse of :func:`_put_block`)."""
    n = len({k[len(pre):].split(".")[0] for k in sd if k.startswith(pre)})
    return [{"attn": {w: _get_weight(sd, f"{pre}{i}.attn.{w}", tensors)
                      for w in ("wq", "wk", "wv", "wo")},
             "ln1": _get_ln(sd, f"{pre}{i}.ln1", tensors),
             "ln2": _get_ln(sd, f"{pre}{i}.ln2", tensors),
             **{fc: {"weight": _get_weight(sd, f"{pre}{i}.{fc}", tensors),
                     "bias": _get(sd, f"{pre}{i}.{fc}.bias",
                                  tensors=tensors)}
                for fc in ("fc1", "fc2")}}
            for i in range(n)]


def params_to_jax(state_dict, tensors=False):
    """The reference's params tree (numpy float32, int8 weights as
    ``{"q", "scale"}``) of a port ``GPTForCausalLM`` state_dict;
    ``params_to_jax(params_from_jax(t))`` equals ``t``. With ``tensors``
    each leaf is a CPU tensor of its own type instead."""
    sd, tn = state_dict, tensors
    tree = {"gpt": {"tok_emb": _get(sd, "gpt.tok_emb", tensors=tn),
                    "pos_emb": _get(sd, "gpt.pos_emb", tensors=tn),
                    "ln_f": _get_ln(sd, "gpt.ln_f", tn),
                    "layers": _get_blocks(sd, "gpt.layers.", tn)}}
    if "head.weight" in sd:
        tree["head"] = {"weight": _get_weight(sd, "head", tn)}
    return tree


def _init_blocks(rng, n, hs, inter):
    """``n`` blocks' seeded params in the reference's layout: attention
    Glorot-uniform, MLP weights and biases uniform in +-1/sqrt(fan_in),
    LayerNorm ones and zeros."""
    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def ln():
        return {"weight": np.ones(hs, np.float32),
                "bias": np.zeros(hs, np.float32)}

    xavier = np.sqrt(6.0 / (hs + hs))
    return [{"attn": {w: uniform((hs, hs), xavier)
                      for w in ("wq", "wk", "wv", "wo")},
             "ln1": ln(), "ln2": ln(),
             "fc1": {"weight": uniform((hs, inter), hs ** -0.5),
                     "bias": uniform((inter,), hs ** -0.5)},
             "fc2": {"weight": uniform((inter, hs), inter ** -0.5),
                     "bias": uniform((hs,), inter ** -0.5)}}
            for _ in range(n)]


def _normal(rng, shape, std=0.02):
    return std * rng.standard_normal(shape, dtype=np.float32)


def init_tree(model, seed=0):
    """Seeded random params in the reference's pytree layout (numpy
    float32) for ``model``'s configuration."""
    gpt = model.gpt
    rng = np.random.default_rng(seed)
    hs = gpt.hidden_size
    layers = _init_blocks(rng, len(gpt.layers), hs, gpt.intermediate_size)
    tree = {"gpt": {"tok_emb": _normal(rng, (gpt.vocab_size, hs)),
                    "pos_emb": _normal(rng, (gpt.max_position, hs)),
                    "ln_f": {"weight": np.ones(hs, np.float32),
                             "bias": np.zeros(hs, np.float32)},
                    "layers": layers}}
    if getattr(model, "head", None) is not None:
        # the reference's Linear default: uniform in +-1/sqrt(hidden)
        tree["head"] = {"weight": rng.uniform(
            -hs ** -0.5, hs ** -0.5, (hs, gpt.vocab_size)).astype(np.float32)}
    return tree


def init_params(model, seed=0):
    """Seeded random weights for ``model`` as a state_dict (see module
    docstring)."""
    return params_from_jax(init_tree(model, seed))


def bert_params_from_jax(tree):
    """The port's state_dict of a ``BertForMLM`` (a reference tree with
    ``"bert"`` and ``"head"``) or a ``BERT`` (the encoder's tree alone),
    from numpy arrays, Linear weights transposed to ``(out, in)``."""
    mlm = "bert" in tree
    b, pre = (tree["bert"], "bert.") if mlm else (tree, "")
    sd = collections.OrderedDict()
    for emb in ("tok_emb", "pos_emb", "type_emb"):
        _put(sd, pre + emb, b[emb])
    _put_ln(sd, pre + "ln", b["ln"])
    for i, lp in enumerate(b["layers"]):
        _put_block(sd, f"{pre}layers.{i}.", lp)
    if mlm:
        _put_weight(sd, "head", tree["head"]["weight"])
        _put(sd, "head.bias", tree["head"]["bias"])
    return sd


def bert_params_to_jax(state_dict, tensors=False):
    """The reference's tree of a ``BertForMLM`` or ``BERT`` state_dict (or
    of a dict of its gradients keyed by parameter name); the inverse of
    :func:`bert_params_from_jax`. ``tensors`` as :func:`params_to_jax`'s."""
    sd, tn = state_dict, tensors
    mlm = "head.weight" in sd
    pre = "bert." if mlm else ""
    b = {emb: _get(sd, pre + emb, tensors=tn)
         for emb in ("tok_emb", "pos_emb", "type_emb")}
    b["ln"] = _get_ln(sd, pre + "ln", tn)
    b["layers"] = _get_blocks(sd, pre + "layers.", tn)
    if not mlm:
        return b
    return {"bert": b, "head": {"weight": _get_weight(sd, "head", tn),
                                "bias": _get(sd, "head.bias", tensors=tn)}}


def init_bert_tree(model, seed=0):
    """Seeded random params of a ``BertForMLM`` or ``BERT`` in the
    reference's layout (numpy float32): the layers as :func:`init_tree`
    draws them, then token, position and token-type embeddings N(0,
    0.02), LayerNorm ones and zeros, and an MLM head's weight and bias
    uniform in +-1/sqrt(hidden)."""
    bert = getattr(model, "bert", model)
    rng = np.random.default_rng(seed)
    hs = bert.hidden_size
    b = {"layers": _init_blocks(rng, len(bert.layers), hs,
                                bert.intermediate_size),
         "tok_emb": _normal(rng, (bert.vocab_size, hs)),
         "pos_emb": _normal(rng, (bert.max_position, hs)),
         "type_emb": _normal(rng, (bert.type_vocab_size, hs)),
         "ln": {"weight": np.ones(hs, np.float32),
                "bias": np.zeros(hs, np.float32)}}
    if bert is model:
        return b
    bound = hs ** -0.5
    head = {"weight": rng.uniform(-bound, bound, (hs, model.vocab_size))
            .astype(np.float32),
            "bias": rng.uniform(-bound, bound, model.vocab_size)
            .astype(np.float32)}
    return {"bert": b, "head": head}


def resnet_params_from_jax(params_by_name, state_by_name=None):
    """The port's ``ResNet`` state_dict from name-keyed reference params
    and BN state (numpy arrays; see module docstring)."""
    sd = collections.OrderedDict()
    for tree in (params_by_name, state_by_name or {}):
        for name, leaves in tree.items():
            for leaf, a in leaves.items():
                sd[f"{name}.{leaf}"] = _leaf_from_jax(None, leaf, a)
    return sd


def resnet_params_to_jax(state_dict):
    """``(params_by_name, state_by_name)`` in the reference's layout
    (numpy float32) from a port ``ResNet`` state_dict."""
    params, state = {}, {}
    for key, t in state_dict.items():
        name, leaf = key.rsplit(".", 1)
        tree = state if leaf in ("running_mean", "running_var") else params
        tree.setdefault(name, {})[leaf] = _leaf_to_jax(None, leaf, t)
    return params, state


def init_resnet_params(model, seed=0):
    """Seeded random weights and BN state for a ``ResNet`` as a
    state_dict: each layer's ``init_arrays`` in turn
    (``nn.module.init_state_dict``; see module docstring)."""
    return collections.OrderedDict(init_state_dict(model, seed))


def init_resnet_tree(model, seed=0):
    """Seeded ``(params_by_name, state_by_name)`` for ``model`` in the
    reference's layout (numpy float32): :func:`init_resnet_params`'s."""
    return resnet_params_to_jax(init_resnet_params(model, seed))


def _port_shape(module, leaf, a):
    """The port's shape of the reference's array ``a``: that of
    ``module``'s own tensor ``leaf``, else the default layout rule's."""
    t = getattr(module, leaf, None) if module is not None else None
    if isinstance(t, torch.Tensor):
        return tuple(t.shape)
    perm = jax_perm(module, leaf, a.ndim)
    if perm is None:
        return a.shape
    return tuple(a.shape[i] for i in np.argsort(perm))


def _leaf_from_jax(module, leaf, a):
    """A reference leaf of ``module`` as a port tensor (module
    docstring); a torch tensor keeps its type and device."""
    if isinstance(a, torch.Tensor):
        shape = _port_shape(module, leaf, a)
        return from_jax_layout(jax_layout(module, leaf, shape), shape,
                               a).contiguous()
    a = np.asarray(a)
    shape = _port_shape(module, leaf, a)
    a = from_jax_layout(jax_layout(module, leaf, shape), shape, a)
    dtype = np.int8 if a.dtype == np.int8 else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, order="C"))


def _leaf_to_jax(module, leaf, t, tensors=False):
    """The inverse of :func:`_leaf_from_jax` on a port tensor; with
    ``tensors`` a CPU tensor of ``t``'s type."""
    t = t.detach().cpu()
    if tensors:
        return to_jax_layout(jax_layout(module, leaf, tuple(t.shape)),
                             t).contiguous()
    a = (t if t.dtype == torch.int8 else t.float()).numpy()
    a = to_jax_layout(jax_layout(module, leaf, a.shape), a)
    return np.array(a, order="C")


def _wrapped(module):
    """``[(key prefix, child, key of the child's params)]`` of a
    wrapper (module docstring): key None where the child's
    params are the wrapper's own, else an index or a dict key; None for
    any other module."""
    if isinstance(module, Recurrent):
        return [("cell.", module.cell, None)]
    if isinstance(module, TimeDistributed):
        return [("module.", module.module, None)]
    if isinstance(module, BiRecurrent):
        return [("fwd.", module.fwd, "fwd"), ("bwd.", module.bwd, "bwd")]
    if isinstance(module, MultiRNNCell):
        return [(f"{i}.", c, i) for i, c in enumerate(module.children())]
    keyed = getattr(module, "param_children", None)
    if keyed is not None:
        return [(f"{attr}.", getattr(module, attr), key)
                for attr, key in keyed]
    return None


def _sub(tree, key):
    if key is None or tree is None:
        return tree
    if isinstance(tree, (list, tuple, dict)) and len(tree):
        return tree[key]
    return None


def _leaves(module, params, state, prefix=""):
    """``(key prefix, leaf module, params, state)`` of every leaf under a
    container ``module``, walked beside the reference's trees."""
    wrapped = _wrapped(module)
    if wrapped is not None:
        for pre, child, key in wrapped:
            yield from _leaves(child, _sub(params, key), _sub(state, key),
                               prefix + pre)
    elif isinstance(module, (MapTable, Bottle)):
        yield from _leaves(module[0], params, state, prefix + "0.")
    elif isinstance(module, (Container, Graph)):
        if isinstance(params, dict):
            raise TypeError("give a reference Graph's params as the list "
                            "[params[str(n.id)] for n in graph.exec_order]")
        children = list(module.children())
        state = state if state is not None else [None] * len(children)
        for i, child in enumerate(children):
            yield from _leaves(child, params[i], state[i], f"{prefix}{i}.")
    else:
        yield prefix, module, params, state


def module_params_from_jax(model, params, state=None):
    """The port's state_dict of container ``model`` from the reference's
    params (and BN state) of the same architecture, numpy arrays (see
    module docstring)."""
    sd = collections.OrderedDict()
    for prefix, m, p, st in _leaves(model, params, state):
        for tree in (p, st):
            for leaf, a in (tree or {}).items():
                sd[prefix + leaf] = _leaf_from_jax(m, leaf, a)
    return sd


def module_params_to_jax(model, state_dict=None, tensors=False):
    """``(params, state)`` in the reference's layout (numpy float32) of
    container ``model``'s ``state_dict`` (default: its own; a dict of
    gradients keyed by parameter name maps the same way, its missing
    buffers left out); with ``tensors`` each leaf is a CPU tensor of its
    own type instead."""
    sd = model.state_dict() if state_dict is None else state_dict

    def walk(module, prefix):
        wrapped = _wrapped(module)
        if wrapped is not None:
            pairs = [(key, walk(c, prefix + pre)) for pre, c, key in wrapped]
            if pairs[0][0] is None:
                return pairs[0][1]
            # the reference's wrappers keep no state of their own
            state = [s for _, (_, s) in pairs]
            if isinstance(module, BiRecurrent):
                return ({k: p for k, (p, _) in pairs},
                        {k: s for k, (_, s) in pairs}
                        if any(state) else ())
            if isinstance(pairs[0][0], str):    # ``param_children``
                return ({k: p for k, (p, _) in pairs},
                        {k: s for k, (_, s) in pairs})
            return [p for _, (p, _) in pairs], state if any(state) else ()
        if isinstance(module, (MapTable, Bottle)):
            return walk(module[0], prefix + "0.")
        if isinstance(module, (Container, Graph)):
            pairs = [walk(c, f"{prefix}{i}.")
                     for i, c in enumerate(module.children())]
            return [p for p, _ in pairs], [s for _, s in pairs]
        # a quantised layer's int8 weight, scale and in_scale buffers are
        # the reference's params
        own = set(getattr(module, "param_buffers", ()))
        params = {name: _leaf_to_jax(module, name, sd[prefix + name],
                                     tensors)
                  for name, _ in (list(module.named_parameters(recurse=False))
                                  + list(module.named_buffers(recurse=False)))
                  if prefix + name in sd
                  and (name in own or not _is_buffer(module, name))}
        state = {name: _leaf_to_jax(module, name, sd[prefix + name],
                                    tensors)
                 for name, _ in module.named_buffers(recurse=False)
                 if prefix + name in sd and name not in own}
        return params or (), state or ()

    return walk(model, "")


def _is_buffer(module, name):
    return name in dict(module.named_buffers(recurse=False))


def model_state_to_jax(model):
    """``model``'s buffers in the reference's state layout (numpy
    float32): a ResNet's ``{layer name: {"running_mean",
    "running_var"}}``, any other model's :func:`module_params_to_jax`
    state."""
    from bigdl_tpu_torch.models.resnet import ResNet
    if isinstance(model, ResNet):
        return resnet_params_to_jax(dict(model.named_buffers()))[1]
    return module_params_to_jax(model)[1]


def model_state_from_jax(model, state):
    """The partial ``state_dict`` (buffers) of a reference state tree
    laid out as :func:`model_state_to_jax` gives it."""
    from bigdl_tpu_torch.models.resnet import ResNet
    if isinstance(model, ResNet):
        return resnet_params_from_jax({}, state)
    sd = collections.OrderedDict()
    for prefix, m, st, _ in _leaves(model, state, None):
        for leaf, a in (st or {}).items():
            sd[prefix + leaf] = _leaf_from_jax(m, leaf, a)
    return sd


def adapter_from_jax(tree):
    """The port's adapter of a reference ``models/lora.init_adapter`` tree
    (``{"rank", "alpha", "layers": [{target: {"a", "b"}}]}``, its arrays
    numpy or anything ``np.asarray`` takes): an identity on the arrays,
    each copied into a numpy array of its own, in the same (in, r) / (r,
    out) orientation and dtype, so ``models.lora.adapter_digest`` of the
    result is the reference's digest of the tree."""
    return {"rank": int(tree["rank"]), "alpha": float(tree["alpha"]),
            "layers": [{tgt: {part: np.array(ab[part], copy=True)
                              for part in ("a", "b")}
                        for tgt, ab in layer.items()}
                       for layer in tree["layers"]]}
