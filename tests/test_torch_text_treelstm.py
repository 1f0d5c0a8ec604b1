"""The port's text pipeline and tree-LSTM (``bigdl_tpu_torch/dataset/
text.py``, ``nn/tree_lstm.py``, ``optim/validation.py``
``TreeNNAccuracy``) against the JAX reference's on the CPU.

The text chain's tokens, dictionary, samples and ``ptb_batches`` windows
must equal the reference's exactly. The tree models get the reference's
params (``convert.module_params_from_jax``) on the reference test's
right-branching trees; outputs within 1e-5 absolute, gradients within
1e-4 of each leaf's largest reference magnitude; ``TreeNNAccuracy``
counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.dataset.text as jtext
import bigdl_tpu.nn as jnn
from bigdl_tpu.optim import TreeNNAccuracy as JTreeNNAccuracy
from bigdl_tpu.utils.table import T
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import text as ttext
from bigdl_tpu_torch.optim import TreeNNAccuracy

from test_text_treelstm import CORPUS, build_tree_batch

OUT_TOL = 1e-5
GRAD_REL = 1e-4


def _chain(t):
    return t.SentenceSplitter() >> t.SentenceTokenizer() \
        >> t.SentenceBiPadding()


def test_text_chain_tokens_dictionary_and_samples_equal_reference(tmp_path):
    sents, jsents = list(_chain(ttext)([CORPUS])), list(_chain(jtext)(
        [CORPUS]))
    assert sents == jsents and len(sents) >= 5
    for vocab in (None, 20):
        d, jd = ttext.Dictionary(sents, vocab), jtext.Dictionary(sents,
                                                                  vocab)
        assert d.word2index() == jd.word2index()
        assert d.vocab_size() == jd.vocab_size()
    d.save(tmp_path / "dict.txt")
    assert jtext.Dictionary.load(tmp_path / "dict.txt").word2index() == \
        d.word2index()
    samples = list(ttext.LabeledSentenceToSample(12)(
        ttext.TextToLabeledSentence(d)(sents)))
    jsamples = list(jtext.LabeledSentenceToSample(12)(
        jtext.TextToLabeledSentence(jd)(sents)))
    assert len(samples) == len(jsamples)
    for s, js in zip(samples, jsamples):
        np.testing.assert_array_equal(s.features, js.features)
        np.testing.assert_array_equal(s.labels, js.labels)
    p = tmp_path / "corpus.txt"
    p.write_text("First line. Second one!\nAnother line.\n")
    assert ttext.read_localfile(str(p)) == jtext.read_localfile(str(p))


@pytest.mark.parametrize("batch,steps", [(4, 5), (20, 20), (3, 7)])
def test_ptb_batches_windows_equal_reference(batch, steps):
    ids = np.random.default_rng(batch).integers(0, 10000, 1001)
    got = list(ttext.ptb_batches(ids, batch, steps))
    want = list(jtext.ptb_batches(ids, batch, steps))
    assert len(got) == len(want) > 0
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError, match="too small"):
        next(ttext.ptb_batches(ids[:10], batch, steps))


@pytest.fixture(scope="module")
def trees():
    """64 seeded trees as the reference's sentiment test builds them."""
    rng = np.random.default_rng(0)
    seqs, labels = [], []
    for _ in range(64):
        n = int(rng.integers(2, 6))
        toks = rng.integers(1, 11, n)
        seqs.append(toks.tolist())
        labels.append(int((np.where(toks <= 5, 1, -1)).sum() > 0))
    word, tree, roots = build_tree_batch(seqs, 8, rng)
    return word, tree, roots, np.asarray(labels, np.int32)


def _hold(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_REL * max(np.abs(w).max(), 1e-12))


def test_binary_tree_lstm_matches_reference(trees):
    word, tree, _, _ = trees
    jm = jnn.BinaryTreeLSTM(8, 6).build(0, None)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(np.shape(a))).astype(
            np.float32), jm.params)
    tm = tnn.BinaryTreeLSTM(8, 6, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(tm, params))
    emb = rng.standard_normal(word.shape + (8,)).astype(np.float32) \
        * (word > 0)[..., None]
    want = np.asarray(jm.call(params, T(jnp.asarray(emb),
                                        jnp.asarray(tree))))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    g_ref = jax.grad(lambda p, e: jnp.sum(jm.call(p, T(e, jnp.asarray(
        tree))) * ct), argnums=(0, 1))(params, jnp.asarray(emb))
    et = torch.from_numpy(emb).requires_grad_(True)
    got = tm([et, torch.from_numpy(tree)])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=OUT_TOL)
    (got * torch.from_numpy(ct)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    _hold(convert.module_params_to_jax(tm, grads)[0], g_ref[0])
    _hold([et.grad.numpy()], [g_ref[1]])
    assert repr(tm) == repr(jm) == "BinaryTreeLSTM(8 -> 6)"
    assert tnn.TreeLSTM is tnn.BinaryTreeLSTM


def test_sentiment_model_loss_gradients_and_accuracy_match_reference(trees):
    """LookupTable + BinaryTreeLSTM + TreeGather + Linear on the 64 trees,
    as the reference's sentiment test wires them."""
    word, tree, roots, labels = trees
    jemb, jtl, jhead = (jnn.LookupTable(12, 8), jnn.BinaryTreeLSTM(8, 16),
                        jnn.Linear(16, 2))
    jemb.build(0, jnp.asarray(word))
    jtl.build(1, None)
    jhead.build(2, (64, 16))
    params = {"emb": jemb.params, "tl": jtl.params, "head": jhead.params}
    crit = jnn.CrossEntropyCriterion()

    def ref(p):
        e = jemb.call(p["emb"], jnp.asarray(word))
        hs = jtl.call(p["tl"], T(e, jnp.asarray(tree)))
        logits = jhead.call(p["head"], jnn.TreeGather().call(
            (), T(hs, jnp.asarray(roots))))
        return crit.apply(logits, jnp.asarray(labels)), logits

    (want, jlogits), g_ref = jax.value_and_grad(ref, has_aux=True)(params)
    emb = tnn.LookupTable(12, 8, device="cpu")
    tl = tnn.BinaryTreeLSTM(8, 16, device="cpu")
    head = tnn.Linear(16, 2, device="cpu")
    model = tnn.Sequential().add(emb).add(tl).add(head)   # weights only
    model.load_state_dict(convert.module_params_from_jax(
        model, [jax.tree_util.tree_map(np.asarray, params[k])
                for k in ("emb", "tl", "head")]))
    hs = tl([emb(torch.from_numpy(word)), torch.from_numpy(tree)])
    logits = head(tnn.TreeGather()([hs, torch.from_numpy(roots)]))
    got = tnn.CrossEntropyCriterion()(logits, torch.from_numpy(labels))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=OUT_TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    _hold(convert.module_params_to_jax(model, grads)[0],
          [g_ref[k] for k in ("emb", "tl", "head")])
    # the root prediction as a (B, N, C) tree output, first node first
    out = torch.stack([logits.detach()] * 3, 1)
    valid = np.arange(64) < 50
    for v in (None, valid):
        c = TreeNNAccuracy().counters(out, torch.from_numpy(labels),
                                      None if v is None
                                      else torch.from_numpy(v))
        jc = JTreeNNAccuracy().counters(jnp.asarray(out.numpy()),
                                        jnp.asarray(labels),
                                        None if v is None
                                        else jnp.asarray(v))
        assert (int(c[0]), int(c[1])) == (int(jc[0]), int(jc[1]))


def test_tree_gather_is_one_based():
    hs = torch.arange(24.0).reshape(2, 3, 4)
    got = tnn.TreeGather()([hs, torch.tensor([1, 3])])
    torch.testing.assert_close(got, torch.stack([hs[0, 0], hs[1, 2]]))
