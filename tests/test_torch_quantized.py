"""The port's int8 weights (``bigdl_tpu_torch/nn/quantized.py``) against
the JAX reference's ``bigdl_tpu/nn/quantized.py``, on the CPU.

Quantisation is bit-equal (same max, same float32 divide, both round half
to even). The int8 product accumulates exactly in int32 on both sides, so
``qmatmul`` on the same int8 inputs is bit-equal too; on float inputs the
two may differ by at most one unit of the int32 accumulator per output
(``sx * scale``: one activation rounding a hair either side of .5), and
in practice are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.nn import Linear as JaxLinear
from bigdl_tpu.nn.quantized import qmatmul as jax_qmatmul
from bigdl_tpu.nn.quantized import quantize_array as jax_quantize_array
from bigdl_tpu.nn.quantized import quantize_params
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import Int8Linear, Linear, quantize_model
from bigdl_tpu_torch.nn.quantized import qmatmul, quantize_array

CFG = dict(vocab_size=97, hidden_size=64, n_layers=2, n_heads=4,
           max_position=64)


def _leaf(w):
    """The reference's ``quantize_params`` leaf of an (in, out) weight."""
    q, scale = jax_quantize_array(jnp.asarray(w), reduce_axes=(0,))
    return {"q": q, "scale": scale[0]}


@pytest.mark.parametrize("shape", [(64, 256), (3072, 768), (7, 5)])
def test_quantize_array_bit_equal_to_reference(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape, dtype=np.float32)
         * rng.uniform(0.01, 3.0, (1, shape[1])).astype(np.float32))
    w[:, 0] = 0.0                         # an all-zero channel: scale 1e-8/127
    want_q, want_s = jax_quantize_array(jnp.asarray(w), reduce_axes=(0,))
    # the port keeps torch's (out, in) layout: reduce over dim 1
    got_q, got_s = quantize_array(torch.from_numpy(w.T.copy()),
                                  reduce_axes=(1,))
    np.testing.assert_array_equal(got_q.numpy().T, np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().T, np.asarray(want_s))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32


def test_converted_quantize_params_tree_equals_port_quantisation():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    tree = jax.tree_util.tree_map(np.asarray, params)
    qtree = jax.tree_util.tree_map(np.asarray, quantize_params(params))
    # the port quantises its own float weights ...
    own = GPTForCausalLM(**CFG, device="cpu")
    own.load_state_dict(convert.params_from_jax(tree))
    own_sd = quantize_model(own).state_dict()
    # ... and loads the reference's int8 tree into a quantised model
    loaded = quantize_model(GPTForCausalLM(**CFG, device="cpu"))
    qsd = convert.params_from_jax(qtree)
    loaded.load_state_dict(qsd)
    assert set(qsd) == set(own_sd)
    for k, v in own_sd.items():
        assert v.dtype == qsd[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), qsd[k].numpy(), err_msg=k)
    # and params_to_jax gives the reference's tree back
    back = convert.params_to_jax(own_sd)
    flat_want, struct_want = jax.tree_util.tree_flatten(qtree)
    flat_got, struct_got = jax.tree_util.tree_flatten(back)
    assert struct_got == struct_want
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_quantize_model_follows_the_reference_policy():
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(convert.init_params(m, seed=0))
    quantize_model(m)
    blk = m.gpt.layers[0]
    for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                blk.fc1, blk.fc2):
        assert isinstance(lin, Int8Linear) and lin.weight.dtype == torch.int8
        assert lin.scale.dtype == torch.float32
    assert blk.attn.wq.bias is None and blk.fc1.bias.dtype == torch.float32
    # embeddings (and so the tied head) and LayerNorm stay float
    assert m.gpt.tok_emb.dtype == m.gpt.pos_emb.dtype == torch.float32
    assert blk.ln1.weight.dtype == torch.float32
    assert not any(isinstance(x, Linear) for x in m.modules())
    before = {k: v.clone() for k, v in m.state_dict().items()}
    quantize_model(m)                      # idempotent
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("rows", [(8,), (4, 64), (2, 1)],
                         ids=["decode8", "chunk4x64", "tiny2"])
def test_qmatmul_on_int8_inputs_is_exact(rows):
    rng = np.random.default_rng(1)
    k_in, n_out = 768, 256
    # integer-valued activations with amax 127 quantise to themselves
    x = rng.integers(-127, 128, (*rows, k_in)).astype(np.float32)
    x.reshape(-1)[0] = 127.0
    leaf = _leaf(rng.standard_normal((k_in, n_out), dtype=np.float32))
    want = np.asarray(jax_qmatmul(jnp.asarray(x), leaf))
    got = qmatmul(torch.from_numpy(x),
                  torch.from_numpy(np.asarray(leaf["q"]).T.copy()),
                  torch.tensor(np.asarray(leaf["scale"])))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the exact integer product, dequantised once
    acc = x.reshape(-1, k_in).astype(np.int64) @ np.asarray(
        leaf["q"]).astype(np.int64)
    np.testing.assert_array_equal(
        got.numpy().reshape(-1, n_out),
        acc.astype(np.float32) * (np.float32(1.0)
                                  * np.asarray(leaf["scale"])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul_on_float_inputs_within_one_step(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 1, 256), dtype=np.float32) * 3.0
    leaf = _leaf(rng.standard_normal((256, 192), dtype=np.float32) * 0.05)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_qmatmul(jx, leaf).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = qmatmul(tx, torch.from_numpy(np.asarray(leaf["q"]).T.copy()),
                  torch.tensor(np.asarray(leaf["scale"])))
    assert got.dtype == tx.dtype
    sx = float(np.abs(np.asarray(jx.astype(jnp.float32))).max()) / 127.0
    step = sx * np.asarray(leaf["scale"])              # one int32 unit
    if dtype == "bfloat16":
        step = step + np.abs(want) * 2.0 ** -8          # and the bf16 cast
    assert (np.abs(got.float().numpy() - want) <= step).all()


def test_int8_fc1_with_bias_matches_reference():
    rng = np.random.default_rng(3)
    hs, inter = 64, 256
    jl = JaxLinear(hs, inter)
    p, _ = jl.setup(jax.random.PRNGKey(3), None)
    p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape,
                                                  dtype=np.float32) * 0.1),
        p)
    qp = quantize_params(p)
    x = rng.standard_normal((4, 8, hs), dtype=np.float32)
    want = np.asarray(jl.call(qp, jnp.asarray(x)))
    lin = Linear(hs, inter, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(p["weight"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    q = Int8Linear.from_linear(lin)
    got = q(torch.from_numpy(x))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    before = qmatmul.calls
    q(torch.from_numpy(x))
    assert qmatmul.calls == before + 1
