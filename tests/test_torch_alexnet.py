"""The port's AlexNet models (``bigdl_tpu_torch/models/alexnet.py``)
against the JAX reference's (``bigdl_tpu/models/alexnet.py``) on the CPU:
the Caffe variant (grouped conv2, conv4 and conv5, cross-map LRN) at 227 x
227 and the one-weird-trick variant at 224 x 224, batch 2, in training
mode without dropout.

The reference's seeded params are carried into the port by
``convert.module_params_from_jax`` (a grouped weight is HWIO ``(kh, kw,
I / 2, O)`` there, OIHW ``(O, I / 2, kh, kw)`` here). Bars (float32 on
both sides): log-probabilities within 1e-4; the loss within 1e-5
relative; each gradient within 1e-4 of its largest magnitude, or within
NOISE_FACTOR (10) times the reference's own float32 noise floor where
that is larger: how far its gradient moves when the images move by 2^-23
relative (the larger of two draws; ``tests/test_torch_inception.py``
says why max pools and ReLUs make that floor reach past 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import alexnet as jalex
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import AlexNet, AlexNet_OWT

LOGP_ATOL = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4
NOISE_FACTOR = 10
CLASSES = 20
CASES = {"AlexNet": (AlexNet, 227), "AlexNet_OWT": (AlexNet_OWT, 224)}


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            tree))


@pytest.mark.parametrize("name", list(CASES))
def test_alexnet_forward_and_gradients_match_reference(name):
    make, hw = CASES[name]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, hw, hw)).astype(np.float32)
    y = rng.integers(0, CLASSES, 2).astype(np.int32)
    jm = getattr(jalex, name)(CLASSES, has_dropout=False)
    tm = make(CLASSES, has_dropout=False, device="cpu")
    params, state = jm.setup(jax.random.PRNGKey(0),
                             jax.ShapeDtypeStruct(x.shape, jnp.float32))
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, params)))
    if name == "AlexNet":
        assert [tuple(tm[i].weight.shape) for i in (4, 10, 12)] == \
            [(256, 48, 5, 5), (384, 192, 3, 3), (256, 192, 3, 3)]

    def at(images):
        def f(p):
            out, _ = jm.apply(p, state, jnp.asarray(images), training=True)
            return JaxNLL().apply(out, jnp.asarray(y)), out
        (loss, out), g = jax.value_and_grad(f, has_aux=True)(params)
        return loss, out, _leaves(g)

    jloss, jout, jgrads = at(x)
    moved = [at(x * (1 + (np.random.default_rng(s).random(x.shape)
                          .astype(np.float32) - 0.5) * 2.0 ** -22))[2]
             for s in (0, 1)]
    out = tm.train()(torch.from_numpy(x).contiguous(
        memory_format=torch.channels_last))
    loss = tnn.ClassNLLCriterion()(out, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=LOGP_ATOL)
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    got = _leaves(convert.module_params_to_jax(
        tm, {k: p.grad for k, p in tm.named_parameters()})[0])
    assert len(got) == len(jgrads) == 16
    for i, (g, w) in enumerate(zip(got, jgrads)):
        assert g.shape == w.shape
        noise = max(np.abs(m[i] - w).max() for m in moved)
        bar = max(GRAD_REL * np.abs(w).max(), NOISE_FACTOR * noise)
        assert np.abs(g - w).max() <= bar, (i, np.abs(g - w).max(), bar)
