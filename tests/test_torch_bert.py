"""The port's BERT family (``bigdl_tpu_torch/models/transformer.py``:
``TransformerEncoderLayer``, ``BERT``, ``BertForMLM``,
``bert_mlm_flops_per_token``; ``convert.bert_params_from_jax`` /
``bert_params_to_jax`` / ``init_bert_tree``) against the JAX reference on
the same numpy-seeded weights.

BERT-tiny (vocab 50, hidden 16, 2 layers, 2 heads, max_position 32) on a
batch of 2 x 16. The reference's attention at these lengths is its XLA
``full_attention`` (its flash gate, ``flash_profitable``, wants 8192
positions); the port's is its flash kernels' plain versions on the CPU.
Bars: forward atol 1e-5, loss rtol 1e-5, each gradient within 1e-4 x its
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import transformer as jt
from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JaxCE
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import transformer as tt
from bigdl_tpu_torch.nn import CrossEntropyCriterion

CFG = dict(vocab_size=50, hidden_size=16, n_layers=2, n_heads=2,
           max_position=32)
B, T = 2, 16


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    types = rng.integers(0, 2, (B, T)).astype(np.int32)
    return ids, types, rng


def _jtree(a):
    return jax.tree_util.tree_map(jnp.asarray, a)


def _port(cls, tree, **kw):
    m = cls(**CFG, device="cpu", **kw)
    m.load_state_dict(convert.bert_params_from_jax(tree))
    return m


def _grads_close(model, want_tree):
    want = convert.bert_params_from_jax(
        jax.tree_util.tree_map(np.asarray, want_tree))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def _layer_state(lp):
    """One encoder layer's state_dict from its reference params."""
    sd = convert.bert_params_from_jax({
        "tok_emb": np.zeros((1, 16)), "pos_emb": np.zeros((1, 16)),
        "type_emb": np.zeros((1, 16)), "ln": lp["ln1"], "layers": [lp]})
    return {k[len("layers.0."):]: v for k, v in sd.items()
            if k.startswith("layers.0.")}


def test_encoder_layer_matches_reference():
    jl = jt.TransformerEncoderLayer(16, 2)
    lp, _ = jl.setup(jax.random.PRNGKey(1), None)
    lp = jax.tree_util.tree_map(np.asarray, lp)
    rng = np.random.default_rng(2)
    x, w = [rng.standard_normal((B, T, 16), dtype=np.float32)
            for _ in range(2)]

    def loss(p, x):
        out, _ = jl.apply(p, (), x)
        return jnp.sum(out * w), out

    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(_jtree(lp), x)
    tl = tt.TransformerEncoderLayer(16, 2, device="cpu")
    tl.load_state_dict(_layer_state(lp))
    tx = torch.from_numpy(x).requires_grad_()
    out = tl(tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(gx)).max())


@pytest.mark.parametrize("with_types", [False, True])
def test_bert_matches_reference(with_types):
    """The encoder's states and the gradients of sum(states * w), with
    the ``(ids, types)`` table input and without."""
    ids, types, rng = _batch()
    jm = jt.BERT(**CFG)
    tree = convert.init_bert_tree(tt.BERT(**CFG, device="cpu"), seed=3)
    w = rng.standard_normal((B, T, 16), dtype=np.float32)
    x_ref = {1: jnp.asarray(ids), 2: jnp.asarray(types)} if with_types \
        else jnp.asarray(ids)

    def loss(p):
        out, _ = jm.apply(p, (), x_ref, training=True)
        return jnp.sum(out * w), out

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(_jtree(tree))
    tm = _port(tt.BERT, tree)
    ti, tty = torch.from_numpy(ids), torch.from_numpy(types)
    out = tm([ti, tty] if with_types else ti)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    if not with_types:
        assert tm.type_emb.grad is None
        tm.type_emb.grad = torch.zeros_like(tm.type_emb)
    _grads_close(tm, grads)


def jt_tree_of(jm):
    """The reference model's own params tree (numpy), for its layout."""
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    return jax.tree_util.tree_map(np.asarray, params)


def test_bert_for_mlm_matches_reference():
    """(B*T, vocab) logits, the masked-LM loss over padded labels (-1 off
    the 15 % masked positions, the example's rule) and its gradients."""
    ids, _, rng = _batch(4)
    labels = np.where(rng.random((B, T)) < 0.15, ids, -1).reshape(-1)
    labels[:3] = ids.reshape(-1)[:3]        # at least three predicted
    jm = jt.BertForMLM(**CFG)
    tree = jt_tree_of(jm)
    crit = JaxCE()
    crit.nll.padding_value = -1

    def loss(p):
        logits, _ = jm.apply(p, (), jnp.asarray(ids), training=True)
        return crit.apply(logits, jnp.asarray(labels)), logits

    (ref_loss, ref), grads = jax.value_and_grad(loss, has_aux=True)(
        _jtree(tree))
    tm = _port(tt.BertForMLM, tree)
    logits = tm(torch.from_numpy(ids))
    assert logits.shape == (B * T, CFG["vocab_size"])
    got = CrossEntropyCriterion()(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.item(), float(ref_loss), rtol=1e-5)
    got.backward()
    tm.bert.type_emb.grad = torch.zeros_like(tm.bert.type_emb)
    _grads_close(tm, grads)


def test_remat_equals_plain():
    ids, types, _ = _batch(5)
    tree = convert.init_bert_tree(tt.BertForMLM(**CFG, device="cpu"), 6)
    x = [torch.from_numpy(ids), torch.from_numpy(types)]
    outs = []
    for remat in (False, True):
        tm = _port(tt.BertForMLM, tree, remat=remat)
        out = tm(x)
        (out ** 2).sum().backward()
        outs.append((out.detach(), {n: p.grad.clone()
                                    for n, p in tm.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for name, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][name], g, rtol=1e-6,
                                   atol=1e-7, msg=name)


@pytest.mark.parametrize("kw", [{}, dict(n_layers=2, h=16, s=32, vocab=50),
                                dict(s=128, inter=1024)])
def test_flops_per_token_equal_reference(kw):
    assert tt.bert_mlm_flops_per_token(**kw) == \
        jt.bert_mlm_flops_per_token(**kw)


def test_convert_round_trip_and_layout():
    for cls, jcls in ((tt.BertForMLM, jt.BertForMLM), (tt.BERT, jt.BERT)):
        tree = convert.init_bert_tree(cls(**CFG, device="cpu"), seed=7)
        # the seeded tree has the reference's own structure and shapes
        ref = jt_tree_of(jcls(**CFG))
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(ref)):
            assert a.shape == b.shape and a.dtype == np.float32
        back = convert.bert_params_to_jax(convert.bert_params_from_jax(tree))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
    # the draws' distributions: N(0, 0.02) embeddings, Xavier attention
    big = convert.init_bert_tree(tt.BertForMLM(device="cpu"), seed=0)
    emb = big["bert"]["tok_emb"]
    assert abs(emb.std() - 0.02) < 2e-4 and abs(emb.mean()) < 1e-4
    wq = big["bert"]["layers"][0]["attn"]["wq"]
    assert np.abs(wq).max() <= np.sqrt(6.0 / (768 + 768))


def test_dropout_identity_without_generator_and_binomial_with_one():
    layer = tt.TransformerEncoderLayer(16, 2, dropout=0.5, device="cpu")
    tree = convert.init_bert_tree(tt.BERT(**CFG, device="cpu"), 8)
    layer.load_state_dict(_layer_state(tree["layers"][0]))
    x = torch.randn(B, T, 16, generator=torch.Generator().manual_seed(0))
    layer.train()
    plain = layer(x)
    layer.eval()
    torch.testing.assert_close(layer(x), plain, rtol=0, atol=0)
    layer.train()
    h = torch.ones(400, 500)
    n, p = h.numel(), 0.5
    dropped = layer.drop(h, torch.Generator().manual_seed(1))
    kept = (dropped != 0).sum().item()
    # 6 standard deviations of Binomial(n, 1 - p)
    assert abs(kept - n * (1 - p)) < 6 * np.sqrt(n * p * (1 - p))
    torch.testing.assert_close(dropped[dropped != 0],
                               torch.full((kept,), 1 / (1 - p)))
    assert not torch.equal(layer(x, torch.Generator().manual_seed(2)),
                           plain)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_bert_sequence_parallel_forms_equal_plain(kind):
    """BERT with its attention over a 2-shard mesh equals the plain
    model (same weights) within the reference's sequence-parallel bar."""
    ids, types, _ = _batch(9)
    tree = convert.init_bert_tree(tt.BERT(**CFG, device="cpu"), 10)
    x = [torch.from_numpy(ids), torch.from_numpy(types)]
    want = _port(tt.BERT, tree)(x)
    got = _port(tt.BERT, tree, sequence_parallel=(kind, ["cpu"] * 2,
                                                  "seq"))(x)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
