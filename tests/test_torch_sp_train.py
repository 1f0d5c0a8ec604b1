"""The port's dp x sp train step (``bigdl_tpu_torch/models/transformer.py``
``make_sp_train_step``) against the reference's ``shard_map`` step, and
the sequence-parallel GPT (``models/gpt.py``: ``generate``'s sliding
loop, ``ServingEngine``'s refusal).

The reference runs on a 2 x 4 ``("data", "seq")`` mesh of the 8 virtual
CPU devices of ``tests/conftest.py``; the port on ``[["cpu"] * 4] * 2``.
BERT-tiny as the reference's own sp test builds it (vocab 50, hidden 16,
2 layers, 2 heads, max_position 32), a batch of 4 x 32, ``SGD(0.1)``; a
GPT-tiny (vocab 61) the same way, causal. The reference's ``ring_inner``
layers run its plain ring body; the port's run its flash body (the
kernels' plain versions here). Bars: forward rtol 2e-4 / atol 2e-5 (the
reference's sp bar), loss rtol 1e-5, each parameter's update within 1e-4
x its largest magnitude plus one float32 rounding of the weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from bigdl_tpu.models import gpt as jgpt
from bigdl_tpu.models import transformer as jt
from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JaxCE
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.utils.jax_compat import shard_map
from bigdl_tpu_torch import convert, optim
from bigdl_tpu_torch.models import gpt as tgpt
from bigdl_tpu_torch.models import transformer as tt
from bigdl_tpu_torch.nn import CrossEntropyCriterion
from bigdl_tpu_torch.serving.engine import ServingEngine

DP, SP = 2, 4
B, T = 4, 32
BERT_CFG = dict(vocab_size=50, hidden_size=16, n_layers=2, n_heads=2,
                max_position=32)
GPT_CFG = dict(vocab_size=61, hidden_size=16, n_layers=2, n_heads=4,
               max_position=32)
RING_INNER = ("ring_inner", "seq", SP)
MESH = [["cpu"] * SP for _ in range(DP)]


@pytest.fixture(scope="module")
def jmesh():
    devs = np.asarray(jax.devices())
    if devs.size < DP * SP:
        pytest.skip(f"needs {DP * SP} virtual CPU devices")
    return Mesh(devs[:DP * SP].reshape(DP, SP), ("data", "seq"))


def _put(jmesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(jmesh,
                                                        P("data", "seq")))


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _join(outs, b, t):
    """The shards' outputs ``outs[d][s]`` ((b, t, ...) or (b * t, ...))
    as one (B, T, ...) array."""
    return torch.cat([torch.cat([o.reshape(b, t, *o.shape[1:])
                                 if o.shape[0] == b * t else o
                                 for o in row], 1) for row in outs], 0)


def _ref_step(jmesh, jm, tree, x, y, crit):
    step = jt.make_sp_train_step(jm, crit, JaxSGD(learningrate=0.1), jmesh)
    params = _jtree(tree)
    opt_state = JaxSGD(learningrate=0.1).init_state(params)
    new, _, loss = step(params, opt_state, _put(jmesh, x), _put(jmesh, y))
    return jax.tree_util.tree_map(np.asarray, new), float(loss)


def _port_step(model, x, y, crit):
    method = optim.SGD(learningrate=0.1)
    step = tt.make_sp_train_step(model, crit, method, MESH)
    opt_state = method.init_state(dict(model.named_parameters()))
    loss = step(opt_state, torch.from_numpy(x), torch.from_numpy(y))
    return step, float(loss)


def _updates_close(before, after, want):
    """Each parameter's update ``after - before`` against the reference's
    ``want - before``, within 1e-4 x its largest magnitude plus one
    float32 rounding of the new weights (2^-23 x max|w|: both updates are
    read off rounded weights)."""
    for name, b in before.items():
        got = (after[name].detach() - b).numpy()
        ref = (want[name].detach() - b).numpy()
        atol = 1e-4 * np.abs(ref).max() + 2.0 ** -23 * b.abs().max().item()
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                   err_msg=name)


def _replicas_identical(step):
    want = dict(step.model.named_parameters())
    n = 0
    for row in step.replicas:
        for r in row:
            for name, p in r.named_parameters():
                assert torch.equal(p, want[name]), name
            n += 1
    assert n == DP * SP
    assert sum(r is step.model for row in step.replicas for r in row) == 1


def test_sp_forward_equals_reference(jmesh):
    """The dp x sp BERT forward equals the reference's ``shard_map``
    forward and the port's plain forward on the same weights; each shard
    adds its global positions' embeddings."""
    jm = jt.BERT(sequence_parallel=RING_INNER, **BERT_CFG)
    tree = convert.init_bert_tree(tt.BERT(**BERT_CFG, device="cpu"), 11)
    ids = np.random.default_rng(0).integers(0, 50, (B, T)).astype(np.int32)
    fwd = shard_map(lambda p, x: jm.apply(p, (), x)[0], mesh=jmesh,
                    in_specs=(P(), P("data", "seq")),
                    out_specs=P("data", "seq"), check_vma=False)
    ref = np.asarray(fwd(_jtree(tree), _put(jmesh, ids)))
    model = tt.BERT(sequence_parallel=RING_INNER, **BERT_CFG, device="cpu")
    model.load_state_dict(convert.bert_params_from_jax(tree))
    step = tt.make_sp_train_step(model, CrossEntropyCriterion(),
                                 optim.SGD(learningrate=0.1), MESH)
    with torch.no_grad():
        got = _join(step.forward(torch.from_numpy(ids)), B // DP, T // SP)
        plain = tt.BERT(**BERT_CFG, device="cpu")
        plain.load_state_dict(convert.bert_params_from_jax(tree))
        want = plain(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def _mlm_labels(ids, padded, seed):
    if not padded:
        return ids.copy()
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(ids.shape) < 0.15, ids, -1).astype(np.int32)
    step = T // SP
    y[:, ::step] = ids[:, ::step]       # every shard predicts a token
    return y


@pytest.mark.parametrize("padded", [False, True])
def test_sp_step_matches_reference(jmesh, padded):
    """One SGD(0.1) step of BertForMLM: the loss and every parameter's
    update equal the reference's, and the replicas stay bit-identical.
    With padded labels the shards hold unequal numbers of predicted
    tokens, and the loss is the mean of the shards' local means, which
    differs from the global masked mean."""
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 50, (B, T)).astype(np.int32)
    y = _mlm_labels(ids, padded, 13)
    crit = JaxCE()
    crit.nll.padding_value = -1
    jm = jt.BertForMLM(sequence_parallel=RING_INNER, **BERT_CFG)
    tree = convert.init_bert_tree(tt.BertForMLM(**BERT_CFG, device="cpu"),
                                  14)
    want_tree, want_loss = _ref_step(jmesh, jm, tree, ids, y, crit)

    model = tt.BertForMLM(sequence_parallel=RING_INNER, **BERT_CFG,
                          device="cpu")
    model.load_state_dict(convert.bert_params_from_jax(tree))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step, loss = _port_step(model, ids, y, CrossEntropyCriterion())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    want = convert.bert_params_from_jax(want_tree)
    _updates_close(before, dict(model.named_parameters()), want)
    _replicas_identical(step)
    if padded:
        counts = [(y[d * 2:(d + 1) * 2, s * 8:(s + 1) * 8] >= 0).sum()
                  for d in range(DP) for s in range(SP)]
        assert len(set(counts)) > 1 and min(counts) > 0
        plain = tt.BertForMLM(**BERT_CFG, device="cpu")
        plain.load_state_dict(convert.bert_params_from_jax(tree))
        with torch.no_grad():
            global_mean = float(CrossEntropyCriterion()(
                plain(torch.from_numpy(ids)),
                torch.from_numpy(y).reshape(-1)))
        assert abs(global_mean - loss) > 1e-3 * abs(loss)


def test_sp_step_equals_plain_step_on_unpadded_labels():
    """With every label real the shards' local means average to the
    global mean: one sp step equals one ``make_train_step`` step."""
    rng = np.random.default_rng(15)
    ids = rng.integers(0, 50, (B, T)).astype(np.int32)
    tree = convert.init_bert_tree(tt.BertForMLM(**BERT_CFG, device="cpu"),
                                  16)
    plain = tt.BertForMLM(**BERT_CFG, device="cpu")
    plain.load_state_dict(convert.bert_params_from_jax(tree))
    method = optim.SGD(learningrate=0.1)
    step = optim.make_train_step(plain, CrossEntropyCriterion(), method)
    want_loss = float(step(method.init_state(dict(plain.named_parameters())),
                           torch.from_numpy(ids),
                           torch.from_numpy(ids).reshape(-1)))
    model = tt.BertForMLM(sequence_parallel=RING_INNER, **BERT_CFG,
                          device="cpu")
    model.load_state_dict(convert.bert_params_from_jax(tree))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, loss = _port_step(model, ids, ids, CrossEntropyCriterion())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _updates_close(before, dict(model.named_parameters()),
                   dict(plain.named_parameters()))


def test_gpt_ring_inner_step_matches_reference(jmesh):
    """The same step on a causal GPT-tiny: global positions per shard and
    the causal ring (n (n + 1) / 2 pairs a layer and row in the port)."""
    rng = np.random.default_rng(17)
    ids = rng.integers(0, 61, (B, T + 1)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    jm = jgpt.GPTForCausalLM(sequence_parallel=RING_INNER, **GPT_CFG)
    tree = convert.init_tree(tgpt.GPTForCausalLM(**GPT_CFG, device="cpu"),
                             18)
    want_tree, want_loss = _ref_step(jmesh, jm, tree, x, y, JaxCE())
    model = tgpt.GPTForCausalLM(sequence_parallel=RING_INNER, **GPT_CFG,
                                device="cpu")
    model.load_state_dict(convert.params_from_jax(tree))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step, loss = _port_step(model, x, y, CrossEntropyCriterion())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _updates_close(before, dict(model.named_parameters()),
                   convert.params_from_jax(want_tree))
    _replicas_identical(step)


def test_make_sp_train_step_needs_a_matching_ring_inner_model():
    method = optim.SGD(learningrate=0.1)
    for sp in (None, ("ring_inner", "seq", 2), ("ring_inner", "sp", SP),
               ("ring", ["cpu"] * SP, "seq")):
        model = tt.BERT(sequence_parallel=sp, **BERT_CFG, device="cpu")
        with pytest.raises(ValueError, match="ring_inner"):
            tt.make_sp_train_step(model, CrossEntropyCriterion(), method,
                                  MESH)


def test_ring_inner_model_takes_its_groups_chunks():
    model = tt.BERT(sequence_parallel=RING_INNER, **BERT_CFG, device="cpu")
    with pytest.raises(ValueError, match="list of 4 chunks"):
        model(torch.zeros(1, 8, dtype=torch.long))


def test_serving_refuses_a_sequence_parallel_model():
    model = tgpt.GPTForCausalLM(sequence_parallel=RING_INNER, **GPT_CFG,
                                device="cpu")
    model.load_state_dict(convert.init_params(model, 0))
    with pytest.raises(ValueError, match="sequence_parallel"):
        ServingEngine(model, device="cpu")


def _gpt_pair(kind, jmesh=None):
    """(port sp model, port plain model, reference sp model, tree)."""
    tree = convert.init_tree(tgpt.GPTForCausalLM(**GPT_CFG, device="cpu"),
                             19)
    sd = convert.params_from_jax(tree)
    tsp = RING_INNER if kind == "ring_inner" else (kind, ["cpu"] * SP,
                                                   "seq")
    sp = tgpt.GPTForCausalLM(sequence_parallel=tsp, **GPT_CFG, device="cpu")
    sp.load_state_dict(sd)
    plain = tgpt.GPTForCausalLM(**GPT_CFG, device="cpu")
    plain.load_state_dict(sd)
    jsp = RING_INNER if kind == "ring_inner" else (
        kind, Mesh(np.asarray(jax.devices()[:SP]), ("seq",)), "seq")
    return sp, plain, jgpt.GPTForCausalLM(sequence_parallel=jsp, **GPT_CFG), \
        tree


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_generate_on_sp_model_takes_the_sliding_loop(multi_device_cpu, kind):
    """As the reference: the sliding loop, one full forward a token, which
    runs while the length splits over the mesh (one token from 8) and
    fails at the next (9 positions over 4 shards)."""
    sp, plain, jm, tree = _gpt_pair(kind)
    prompt = np.arange(8, dtype=np.int32)[None] % 61
    ref = np.asarray(jm.generate(_jtree(tree), jnp.asarray(prompt), 1,
                                 temperature=0.0))
    got = sp.generate(torch.from_numpy(prompt), 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), plain.generate(
        torch.from_numpy(prompt), 1).numpy())
    assert sp.decode_stats["dispatches"] == 0       # not the cache path
    with pytest.raises(ValueError):
        jm.generate(_jtree(tree), jnp.asarray(prompt), 2, temperature=0.0)
    with pytest.raises(ValueError, match="does not split"):
        sp.generate(torch.from_numpy(prompt), 2)


def test_generate_on_ring_inner_model_fails_as_the_reference():
    sp, _, jm, tree = _gpt_pair("ring_inner")
    prompt = np.arange(8, dtype=np.int32)[None]
    with pytest.raises(NameError, match="unbound axis"):
        jm.generate(_jtree(tree), jnp.asarray(prompt), 1, temperature=0.0)
    with pytest.raises(ValueError, match="list of 4 chunks"):
        sp.generate(torch.from_numpy(prompt), 1)
