"""Parameters between the JAX reference and the port.

- :func:`params_from_jax` turns the reference's GPT params pytree, given
  as numpy arrays (``{"gpt": {"tok_emb", "pos_emb", "ln_f", "layers":
  [{"attn": {wq, wk, wv, wo}, "ln1", "ln2", "fc1", "fc2"}]}}``), into
  the port's ``state_dict``, transposing Linear weights from the
  reference's ``(in, out)`` to torch's ``(out, in)``. Any tree of that
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
  uniform in +-1/sqrt(fan_in); LayerNorm ones/zeros), for runs that cannot
  import JAX. The numbers come from numpy's generator, not JAX's.

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
- :func:`init_resnet_tree` / :func:`init_resnet_params` draw seeded weights
  from the reference's initializers' distributions: convolutions
  Glorot-uniform (``Xavier``, fan in / out = kh * kw * channels), Linear
  weight and bias uniform in +-1/sqrt(in) (its ``RandomUniform``
  default), BN weight 1 and bias 0, running mean 0 and variance 1.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from bigdl_tpu_torch.nn import BatchNormalization, Linear, SpatialConvolution


def params_from_jax(tree):
    """The port's ``GPTForCausalLM`` state_dict from a reference params
    tree of numpy arrays (float32 CPU tensors; load it with
    ``model.load_state_dict``)."""
    if "head" in tree:
        raise NotImplementedError("untied LM heads are not ported; GPT-2 "
                                  "ties the head to the token embedding")
    g = tree["gpt"]
    sd = collections.OrderedDict()

    def put(key, arr, transpose=False, dtype=np.float32):
        a = np.asarray(arr, dtype=dtype)
        # a C-ordered copy: torch shares the buffer, and the reference's
        # arrays may be read-only views
        sd[key] = torch.from_numpy(np.array(a.T if transpose else a,
                                            order="C"))

    def put_weight(pre, w):
        if isinstance(w, dict):                  # int8 {"q", "scale"}
            put(f"{pre}.weight", w["q"], transpose=True, dtype=np.int8)
            put(f"{pre}.scale", w["scale"])
        else:
            put(f"{pre}.weight", w, transpose=True)

    put("gpt.tok_emb", g["tok_emb"])
    put("gpt.pos_emb", g["pos_emb"])
    for i, lp in enumerate(g["layers"]):
        pre = f"gpt.layers.{i}."
        for w in ("wq", "wk", "wv", "wo"):
            put_weight(f"{pre}attn.{w}", lp["attn"][w])
        for ln in ("ln1", "ln2"):
            put(f"{pre}{ln}.weight", lp[ln]["weight"])
            put(f"{pre}{ln}.bias", lp[ln]["bias"])
        for fc in ("fc1", "fc2"):
            put_weight(f"{pre}{fc}", lp[fc]["weight"])
            put(f"{pre}{fc}.bias", lp[fc]["bias"])
    put("gpt.ln_f.weight", g["ln_f"]["weight"])
    put("gpt.ln_f.bias", g["ln_f"]["bias"])
    return sd


def params_to_jax(state_dict):
    """The reference's params tree (numpy float32, int8 weights as
    ``{"q", "scale"}``) of a port ``GPTForCausalLM`` state_dict;
    ``params_to_jax(params_from_jax(t))`` equals ``t``."""
    def get(key, transpose=False):
        t = state_dict[key].detach().cpu()
        a = (t if t.dtype == torch.int8 else t.float()).numpy()
        return np.array(a.T if transpose else a, order="C")

    def weight(pre):
        if f"{pre}.scale" in state_dict:
            return {"q": get(f"{pre}.weight", transpose=True),
                    "scale": get(f"{pre}.scale")}
        return get(f"{pre}.weight", transpose=True)

    def ln(pre):
        return {"weight": get(f"{pre}.weight"), "bias": get(f"{pre}.bias")}

    n_layers = len({k.split(".")[2] for k in state_dict
                    if k.startswith("gpt.layers.")})
    layers = []
    for i in range(n_layers):
        pre = f"gpt.layers.{i}."
        layers.append({
            "attn": {w: weight(f"{pre}attn.{w}")
                     for w in ("wq", "wk", "wv", "wo")},
            "ln1": ln(f"{pre}ln1"), "ln2": ln(f"{pre}ln2"),
            **{fc: {"weight": weight(f"{pre}{fc}"),
                    "bias": get(f"{pre}{fc}.bias")} for fc in ("fc1", "fc2")},
        })
    return {"gpt": {"tok_emb": get("gpt.tok_emb"),
                    "pos_emb": get("gpt.pos_emb"), "ln_f": ln("gpt.ln_f"),
                    "layers": layers}}


def init_tree(model, seed=0):
    """Seeded random params in the reference's pytree layout (numpy
    float32) for ``model``'s configuration."""
    gpt = model.gpt
    rng = np.random.default_rng(seed)
    hs, inter = gpt.hidden_size, gpt.intermediate_size

    def normal(shape, std):
        return std * rng.standard_normal(shape, dtype=np.float32)

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def ln():
        return {"weight": np.ones(hs, np.float32),
                "bias": np.zeros(hs, np.float32)}

    xavier = np.sqrt(6.0 / (hs + hs))
    layers = []
    for _ in gpt.layers:
        layers.append({
            "attn": {w: uniform((hs, hs), xavier)
                     for w in ("wq", "wk", "wv", "wo")},
            "ln1": ln(), "ln2": ln(),
            "fc1": {"weight": uniform((hs, inter), hs ** -0.5),
                    "bias": uniform((inter,), hs ** -0.5)},
            "fc2": {"weight": uniform((inter, hs), inter ** -0.5),
                    "bias": uniform((hs,), inter ** -0.5)},
        })
    return {"gpt": {"tok_emb": normal((gpt.vocab_size, hs), 0.02),
                    "pos_emb": normal((gpt.max_position, hs), 0.02),
                    "ln_f": ln(), "layers": layers}}


def init_params(model, seed=0):
    """Seeded random weights for ``model`` as a state_dict (see module
    docstring)."""
    return params_from_jax(init_tree(model, seed))


def resnet_params_from_jax(params_by_name, state_by_name=None):
    """The port's ``ResNet`` state_dict from name-keyed reference params
    and BN state (numpy arrays; see module docstring)."""
    sd = collections.OrderedDict()

    def put(key, a):
        sd[key] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    for name, leaves in params_by_name.items():
        for leaf, a in leaves.items():
            a = np.asarray(a)
            if leaf == "weight" and a.ndim == 4:          # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            elif leaf == "weight" and a.ndim == 2:        # (in, out)
                a = a.T
            put(f"{name}.{leaf}", a)
    for name, leaves in (state_by_name or {}).items():
        for leaf, a in leaves.items():
            put(f"{name}.{leaf}", a)
    return sd


def resnet_params_to_jax(state_dict):
    """``(params_by_name, state_by_name)`` in the reference's layout
    (numpy float32) from a port ``ResNet`` state_dict."""
    params, state = {}, {}
    for key, t in state_dict.items():
        name, leaf = key.rsplit(".", 1)
        a = t.detach().cpu().float().numpy()
        if leaf in ("running_mean", "running_var"):
            state.setdefault(name, {})[leaf] = np.array(a, order="C")
            continue
        if leaf == "weight" and a.ndim == 4:              # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 2:
            a = a.T
        params.setdefault(name, {})[leaf] = np.array(a, order="C")
    return params, state


def init_resnet_tree(model, seed=0):
    """Seeded ``(params_by_name, state_by_name)`` for ``model`` in the
    reference's layout (numpy float32; see module docstring)."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    for name, m in model.named_children():
        if isinstance(m, SpatialConvolution):
            kk = m.kernel_h * m.kernel_w
            bound = np.sqrt(6.0 / (kk * m.n_input_plane
                                   + kk * m.n_output_plane))
            p = {"weight": uniform((m.kernel_h, m.kernel_w, m.n_input_plane,
                                    m.n_output_plane), bound)}
            if m.bias is not None:
                p["bias"] = np.zeros(m.n_output_plane, np.float32)
            params[name] = p
        elif isinstance(m, Linear):
            bound = 1.0 / np.sqrt(m.input_size)
            params[name] = {
                "weight": uniform((m.input_size, m.output_size), bound),
                "bias": uniform((m.output_size,), bound)}
        elif isinstance(m, BatchNormalization):
            if m.affine:
                params[name] = {"weight": np.ones(m.n_output, np.float32),
                                "bias": np.zeros(m.n_output, np.float32)}
            state[name] = {"running_mean": np.zeros(m.n_output, np.float32),
                           "running_var": np.ones(m.n_output, np.float32)}
    return params, state


def init_resnet_params(model, seed=0):
    """Seeded random weights and BN state for a ``ResNet`` as a
    state_dict (see module docstring)."""
    return resnet_params_from_jax(*init_resnet_tree(model, seed))
