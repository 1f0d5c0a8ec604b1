"""The port's 39 criterions (``bigdl_tpu_torch/nn/criterion.py``) against
the reference's (``bigdl_tpu/nn/criterion.py``) on the CPU.

The cases are ``chip_smoke.CRITERION_CASES`` (the ``detect`` phase runs
the same ones on the card against the CPU). Each case builds the
criterion in both packages and feeds both the same seeded numpy inputs
(tables as the port's lists and the reference's ``T``): the loss within
1e-5 relative of the reference's, and the port's ``backward`` within 1e-5
of the largest magnitude of the reference's ``jax.grad`` (float32 sums of
at most a few hundred terms, in another order). One case per criterion
and option set: ``SoftmaxWithCriterion`` with ``ignore_label=-1`` (labels
of -1 wrap to the last class and are masked, as in the reference),
without one, and in "FULL" mode; the composites over tables in key order;
the padded and weighted forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import chip_smoke as cs
from bigdl_tpu.utils.table import T
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils.table import Table

REL = 1e-5
CASES = cs.CRITERION_CASES


def _ref_tree(x):
    """Numpy inputs as the reference takes them: lists become ``T``s."""
    if isinstance(x, list):
        return T(*[_ref_tree(v) for v in x])
    return None if x is None else jnp.asarray(x)


def _port_tree(x):
    if isinstance(x, list):
        return [_port_tree(v) for v in x]
    return None if x is None else torch.from_numpy(np.array(x))


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    if isinstance(x, dict):
        return [a for _, v in sorted(x.items()) for a in _flat(v)]
    return [np.asarray(x)]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=what)


def test_every_reference_criterion_has_a_case():
    import inspect
    from bigdl_tpu.nn import criterion as jc
    ref = {n for n, c in vars(jc).items() if inspect.isclass(c)
           and issubclass(c, jnn.Criterion) and c is not jnn.Criterion}
    assert len(ref) == 39
    assert ref == {k.split("_")[0] for k in CASES}
    for n in ref:
        assert issubclass(getattr(tnn, n), tnn.Criterion), n


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_input_gradient_match_reference(name):
    make, inputs = CASES[name]
    jc, tc = make(jnn), make(tnn)
    x, t = inputs(np, np.random.default_rng(cs.criterion_seed(name)))
    jt = _ref_tree(t)

    def loss(xx):
        return jc.apply(xx, jt)

    jx = _ref_tree(x)
    want = float(loss(jx))
    want_grad = _flat(jax.grad(loss)(jx))
    got = tc(_port_tree(x), _port_tree(t))
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= REL * max(abs(want), 1e-30), \
        (name, float(got), want)
    grad = tc.backward(_port_tree(x), _port_tree(t))
    assert float(tc.output) == float(got)
    assert isinstance(grad, list) == isinstance(x, list)
    got_grad = _flat([g.numpy() for g in grad] if isinstance(grad, list)
                     else grad.numpy())
    assert len(got_grad) == len(want_grad), name
    for i, (g, w) in enumerate(zip(got_grad, want_grad)):
        _close(g, w, f"{name} gradient {i}")


def test_tables_are_read_in_key_order():
    """A ``Table`` or dict input reads as the list of its values in key
    order, whatever order its keys were set in."""
    r = np.random.default_rng(1)
    a, b = (r.standard_normal((6, 4)).astype(np.float32) for _ in "ab")
    y = (r.integers(0, 2, 6) * 2 - 1).astype(np.float32)
    crit = tnn.CosineEmbeddingCriterion(margin=0.1)
    want = crit([torch.from_numpy(a), torch.from_numpy(b)],
                 torch.from_numpy(y))
    table = Table()
    table[2] = torch.from_numpy(b)
    table[1] = torch.from_numpy(a)
    assert float(crit(table, torch.from_numpy(y))) == float(want)
    assert float(crit({2: torch.from_numpy(b), 1: torch.from_numpy(a)},
                      torch.from_numpy(y))) == float(want)


def test_a_float64_target_takes_the_input_type():
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.standard_normal((4, 5)).astype(np.float32))
    t = r.standard_normal((4, 5))
    got = tnn.MSECriterion()(x, t)
    assert got.dtype == torch.float32
    assert float(got) == float(tnn.MSECriterion()(
        x, torch.from_numpy(t.astype(np.float32))))
