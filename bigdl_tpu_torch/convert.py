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
- :func:`init_params` makes seeded random weights in the reference's
  layout and with its initializers' distributions (token/position
  embeddings N(0, 0.02); attention Glorot-uniform; MLP weights and biases
  uniform in +-1/sqrt(fan_in); LayerNorm ones/zeros), for runs that cannot
  import JAX. The numbers come from numpy's generator, not JAX's.
"""

from __future__ import annotations

import collections

import numpy as np
import torch


def params_from_jax(tree):
    """The port's ``GPTForCausalLM`` state_dict from a reference params
    tree of numpy arrays (float32 CPU tensors; load it with
    ``model.load_state_dict``)."""
    if "head" in tree:
        raise NotImplementedError("untied LM heads are not ported; GPT-2 "
                                  "ties the head to the token embedding")
    g = tree["gpt"]
    sd = collections.OrderedDict()

    def put(key, arr, transpose=False):
        a = np.asarray(arr, dtype=np.float32)
        # a C-ordered copy: torch shares the buffer, and the reference's
        # arrays may be read-only views
        sd[key] = torch.from_numpy(np.array(a.T if transpose else a,
                                            order="C"))

    put("gpt.tok_emb", g["tok_emb"])
    put("gpt.pos_emb", g["pos_emb"])
    for i, lp in enumerate(g["layers"]):
        pre = f"gpt.layers.{i}."
        for w in ("wq", "wk", "wv", "wo"):
            put(f"{pre}attn.{w}.weight", lp["attn"][w], transpose=True)
        for ln in ("ln1", "ln2"):
            put(f"{pre}{ln}.weight", lp[ln]["weight"])
            put(f"{pre}{ln}.bias", lp[ln]["bias"])
        for fc in ("fc1", "fc2"):
            put(f"{pre}{fc}.weight", lp[fc]["weight"], transpose=True)
            put(f"{pre}{fc}.bias", lp[fc]["bias"])
    put("gpt.ln_f.weight", g["ln_f"]["weight"])
    put("gpt.ln_f.bias", g["ln_f"]["bias"])
    return sd


def params_to_jax(state_dict):
    """The reference's params tree (numpy float32) of a port
    ``GPTForCausalLM`` state_dict; ``params_to_jax(params_from_jax(t))``
    equals ``t``."""
    def get(key, transpose=False):
        a = state_dict[key].detach().to("cpu", torch.float32).numpy()
        return np.array(a.T if transpose else a, order="C")

    def ln(pre):
        return {"weight": get(f"{pre}.weight"), "bias": get(f"{pre}.bias")}

    n_layers = len({k.split(".")[2] for k in state_dict
                    if k.startswith("gpt.layers.")})
    layers = []
    for i in range(n_layers):
        pre = f"gpt.layers.{i}."
        layers.append({
            "attn": {w: get(f"{pre}attn.{w}.weight", transpose=True)
                     for w in ("wq", "wk", "wv", "wo")},
            "ln1": ln(f"{pre}ln1"), "ln2": ln(f"{pre}ln2"),
            **{fc: {"weight": get(f"{pre}{fc}.weight", transpose=True),
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
