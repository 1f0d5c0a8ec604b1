"""The port's pair layers (``nn/linear.py``'s ``Cosine``, ``Euclidean`` and
``Bilinear``), its seven newer table layers (``nn/table_ops.py``) and
``Normalize``/``NormalizeScale`` (``nn/normalization.py``) against the
reference's classes on the CPU.

Each case draws the reference layer's params with ``setup``, carries them
into the port layer through ``convert.module_params_from_jax`` and feeds
both the same seeded inputs (tables as the port's lists and the reference's
``T``). Outputs agree within 1e-5 of their largest magnitude, and so do the
gradients of a seeded weighted sum of the output for every input and every
parameter (mapped back to the reference's layout by
``convert.module_params_to_jax``), each within 1e-5 of its largest
magnitude (float32 sums of a few dozen terms in another order). A table
output is compared entry by entry. Each parametrised layer's ``reset``
draws the reference's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.table import T, sorted_items
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn

REL = 1e-5


def _cpu(cls, *args, **kw):
    return lambda: cls(*args, **kw, device="cpu")


# name -> (reference layer, port layer, input shapes: one tuple, or a list
# of them for a table; a nested list is a nested table)
CASES = {
    "cosine": (lambda: jnn.Cosine(5, 3), _cpu(tnn.Cosine, 5, 3), (4, 5)),
    "euclidean": (lambda: jnn.Euclidean(5, 3),
                  _cpu(tnn.Euclidean, 5, 3), (4, 5)),
    "euclidean_3d": (lambda: jnn.Euclidean(5, 2),
                     _cpu(tnn.Euclidean, 5, 2), (2, 3, 5)),
    "bilinear": (lambda: jnn.Bilinear(4, 3, 5),
                 _cpu(tnn.Bilinear, 4, 3, 5), [(6, 4), (6, 3)]),
    "bilinear_no_bias": (lambda: jnn.Bilinear(4, 3, 2, bias_res=False),
                         _cpu(tnn.Bilinear, 4, 3, 2, bias_res=False),
                         [(6, 4), (6, 3)]),
    "cave_table": (lambda: jnn.CAveTable(), lambda: tnn.CAveTable(),
                   [(3, 4), (3, 4), (3, 4)]),
    "split_table": (lambda: jnn.SplitTable(1), lambda: tnn.SplitTable(1),
                    (2, 3, 4)),
    "flatten_table": (lambda: jnn.FlattenTable(), lambda: tnn.FlattenTable(),
                      [(2, 3), [(2, 4), [(3,), (2, 2)]], (1, 5)]),
    "mixture_table": (lambda: jnn.MixtureTable(), lambda: tnn.MixtureTable(),
                      [(4, 3), [(4, 5), (4, 5), (4, 5)]]),
    "mixture_table_maps": (lambda: jnn.MixtureTable(),
                           lambda: tnn.MixtureTable(),
                           [(2, 2), [(2, 3, 4), (2, 3, 4)]]),
    "dot_product": (lambda: jnn.DotProduct(), lambda: tnn.DotProduct(),
                    [(4, 6), (4, 6)]),
    "cosine_distance": (lambda: jnn.CosineDistance(),
                        lambda: tnn.CosineDistance(), [(4, 6), (4, 6)]),
    "mv": (lambda: jnn.MV(), lambda: tnn.MV(), [(3, 4, 5), (3, 5)]),
    "mv_trans": (lambda: jnn.MV(trans=True), lambda: tnn.MV(trans=True),
                 [(3, 4, 5), (3, 4)]),
    "normalize": (lambda: jnn.Normalize(), lambda: tnn.Normalize(), (4, 6)),
    "normalize_p1": (lambda: jnn.Normalize(1.0, eps=1e-6),
                     lambda: tnn.Normalize(1.0, eps=1e-6), (2, 3, 6)),
    "normalize_p3": (lambda: jnn.Normalize(3.0), lambda: tnn.Normalize(3.0),
                     (4, 6)),
    "normalize_inf": (lambda: jnn.Normalize(float("inf")),
                      lambda: tnn.Normalize(float("inf")), (4, 6)),
    "normalize_scale_ssd": (
        lambda: jnn.NormalizeScale(scale=20.0, size=(1, 8, 1, 1)),
        _cpu(tnn.NormalizeScale, scale=20.0, size=(1, 8, 1, 1)),
        (2, 8, 5, 5)),
    "normalize_scale_default": (lambda: jnn.NormalizeScale(p=2.0),
                                _cpu(tnn.NormalizeScale, p=2.0),
                                (2, 4, 3, 3)),
}


def _draw(shape, rng):
    if isinstance(shape, list):
        return [_draw(s, rng) for s in shape]
    return rng.standard_normal(shape).astype(np.float32)


def _ref(x):
    return T(*[_ref(v) for v in x]) if isinstance(x, list) \
        else jnp.asarray(x)


def _port(x):
    return [_port(v) for v in x] if isinstance(x, list) \
        else torch.from_numpy(x).requires_grad_()


def _leaves(x):
    """A nested table's tensors in key order."""
    if isinstance(x, dict):
        return [a for _, v in sorted_items(x) for a in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _leaves(v)]
    return [x]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=what)


def _pair(name, seed):
    make_ref, make_port, shape = CASES[name]
    rng = np.random.default_rng(seed)
    x = _draw(shape, rng)
    jm, tm = make_ref(), make_port()
    spec = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), _ref(x))
    params, state = jm.setup(jax.random.PRNGKey(seed), spec)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    sd = convert.module_params_from_jax(tm, params_np, ())
    if sd:
        tm.load_state_dict(sd)
    return jm, params, state, tm, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_reference(name):
    jm, params, state, tm, x = _pair(name, seed=len(name))
    jx = _ref(x)
    jy = jm.apply(params, state, jx)[0]
    rng = np.random.default_rng(7)
    ws = [rng.standard_normal(np.shape(y)).astype(np.float32)
          for y in _leaves(jy)]

    def f(p, xx):
        ys = _leaves(jm.apply(p, state, xx)[0])
        return sum(jnp.sum(y * w) for y, w in zip(ys, ws))

    jg_p, jg_x = jax.grad(f, argnums=(0, 1))(params, jx)
    tx = _port(x)
    ty = tm(tx)
    ys = _leaves(ty)
    assert len(ys) == len(ws), name
    for i, (y, w) in enumerate(zip(ys, _leaves(jy))):
        _close(y.detach().numpy(), w, f"{name} output {i}")
    sum((y * torch.from_numpy(w)).sum() for y, w in zip(ys, ws)).backward()
    for i, (g, w) in enumerate(zip(_leaves(tx), _leaves(jg_x))):
        _close(g.grad.numpy(), w, f"{name} input gradient {i}")
    grads = {k: p.grad for k, p in tm.named_parameters()}
    tg, _ = convert.module_params_to_jax(tm, grads)
    jg = jax.tree_util.tree_map(np.asarray, jg_p)
    assert sorted(tg or {}) == sorted(jg or {}), name
    for leaf in sorted(tg or {}):
        _close(tg[leaf], jg[leaf], f"{name} {leaf} gradient")


@pytest.mark.parametrize("name", sorted(
    n for n in CASES if n.split("_")[0] in ("cosine", "euclidean",
                                            "bilinear", "normalize")))
def test_reset_draws_the_reference_shapes(name):
    _, params, _, tm, _ = _pair(name, seed=1)
    tm.reset(3)
    tp, _ = convert.module_params_to_jax(tm)
    ref = jax.tree_util.tree_map(np.asarray, params)
    assert sorted(tp or {}) == sorted(ref or {})
    for leaf, a in (tp or {}).items():
        assert a.shape == ref[leaf].shape and np.isfinite(a).all()
        assert (np.std(a) > 0) == (np.std(ref[leaf]) > 0), f"{name} {leaf}"


def test_normalize_scale_keeps_eps_on_the_norm():
    """``x / (norm + eps)``: an all-zero position stays 0 and a tiny one
    is scaled by its norm plus eps (``F.normalize`` would clamp)."""
    m = tnn.NormalizeScale(eps=1e-3, scale=2.0, size=(1, 2, 1, 1),
                           device="cpu")
    x = torch.tensor([[[[0.0, 3e-3]], [[0.0, 4e-3]]]])
    y = m(x).detach()
    assert torch.equal(y[..., 0], torch.zeros(1, 2, 1))
    torch.testing.assert_close(y[0, :, 0, 1],
                               torch.tensor([3e-3, 4e-3]) / 6e-3 * 2.0)
