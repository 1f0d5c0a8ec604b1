"""The layers VGG, Inception and AlexNet add to the port
(``bigdl_tpu_torch/nn/normalization.py`` ``SpatialCrossMapLRN``,
``nn/conv.py`` grouped ``SpatialConvolution``, ``nn/basic.py`` ``Dropout``
and ``Flatten``) against the JAX reference on the CPU.

LRN and convolutions: the same seeded input and weights through both
packages, outputs within 1e-5 (float32, sums of at most a few hundred
terms in another order), and the gradients of a seeded weighted sum of
the output, for the input and every parameter, within 1e-4 of each one's
largest magnitude. A grouped 3x3 stride-1 convolution runs the kernels'
plain versions once per group on the CPU; the other grouped geometries
are ``F.conv2d(groups=)``.

Dropout draws from ``torch``, not ``jax.random``, so it is held by what
the reference's defines: the identity in evaluation, at ``p = 0`` and
without a generator; in training, each element kept with probability
``1 - p`` (within 4 binomial standard deviations) and scaled by
``1 / (1 - p)``; the same generator seed gives the same mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.ops import conv3x3 as cv

OUT_TOL = 1e-5
GRAD_REL = 1e-4


def _pair_grads(jm, params, tm, x, fmt_out_seed=3):
    """Output and gradients (input, then each parameter in the reference's
    layout) of both packages for a seeded weighted sum of the output."""
    jx = jnp.asarray(x)
    jy = jm.call(params, jx)
    w = np.random.default_rng(fmt_out_seed).standard_normal(
        jy.shape).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jm.call(p, xx) * w)

    jg_p, jg_x = jax.grad(f, argnums=(0, 1))(params, jx)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    (ty * torch.from_numpy(w)).sum().backward()
    tg = {k: convert._to_jax(k, p.grad) for k, p in tm.named_parameters()}
    return (ty.detach().numpy(), np.asarray(jy),
            [(tx.grad.numpy(), np.asarray(jg_x))]
            + [(tg[k], np.asarray(jg_p[k])) for k in sorted(tg)])


def _hold(out, grads):
    got, want = out
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)
    for g, w in grads:
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max()


# ------------------------------------------------------------------- LRN
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size", [5, 4])
def test_cross_map_lrn_matches_reference(size, fmt):
    shape = (2, 11, 5, 6) if fmt == "NCHW" else (2, 5, 6, 11)
    x = np.random.default_rng(size).standard_normal(shape).astype(
        np.float32) * 3
    jm = jnn.SpatialCrossMapLRN(size, 0.0001 * 50, 0.75, 2.0, format=fmt)
    tm = tnn.SpatialCrossMapLRN(size, 0.0001 * 50, 0.75, 2.0, format=fmt)
    y, want, grads = _pair_grads(jm, {}, tm, x)
    _hold((y, want), grads)


def test_cross_map_lrn_even_size_pads_as_the_reference():
    """At size 4 channel c's window is channels c - 1 .. c + 2, not
    ``F.local_response_norm``'s c - 2 .. c + 1."""
    x = torch.arange(1, 6.).reshape(1, 5, 1, 1)
    y = tnn.SpatialCrossMapLRN(4, 4.0, 1.0, 1.0)(x).flatten()
    sq = [float(v) ** 2 for v in x.flatten()]
    want = [(c + 1) / (1 + sum(sq[j] for j in range(c - 1, c + 3)
                               if 0 <= j < 5)) for c in range(5)]
    torch.testing.assert_close(y, torch.tensor(want), rtol=1e-6, atol=0)
    torch_lrn = torch.nn.functional.local_response_norm(x, 4, 4.0, 1.0, 1.0)
    assert not torch.allclose(torch_lrn.flatten(), y)


# ------------------------------------------------------ grouped convolution
GROUPED = {  # (n_in, n_out, k, stride, pad, groups, H, W)
    "3x3_s1_g2_kernel_route": (8, 12, 3, 1, 1, 2, 7, 9),
    "3x3_s1_g4_kernel_route": (12, 8, 3, 1, 1, 4, 6, 6),
    "3x3_same_g2_kernel_route": (6, 10, 3, 1, -1, 2, 5, 7),
    "5x5_pad2_g2_library": (6, 8, 5, 1, 2, 2, 9, 9),
    "11x11_s4_g2_library": (4, 6, 11, 4, 0, 2, 27, 27),
}


@pytest.mark.parametrize("case", list(GROUPED))
def test_grouped_convolution_matches_reference(case):
    n_in, n_out, k, s, p, g, h, w = GROUPED[case]
    jm = jnn.SpatialConvolution(n_in, n_out, k, k, s, s, p, p, n_group=g)
    params = jm.make_params(jax.random.PRNGKey(4), None)
    params["bias"] = jnp.asarray(np.random.default_rng(5).standard_normal(
        n_out).astype(np.float32))
    tm = tnn.SpatialConvolution(n_in, n_out, k, k, s, s, p, p, n_group=g,
                                device="cpu")
    assert tuple(tm.weight.shape) == (n_out, n_in // g, k, k)
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, params)))
    assert tm.weight.is_contiguous(memory_format=torch.channels_last)
    kernel = k == 3 and s == 1
    assert tm.uses_kernel(h, w) == kernel
    x = np.random.default_rng(6).standard_normal((2, n_in, h, w)).astype(
        np.float32)
    lib = sum(tnn.SpatialConvolution.library_calls.values())
    y, want, grads = _pair_grads(jm, params, tm, x)
    _hold((y, want), grads)
    calls = sum(tnn.SpatialConvolution.library_calls.values()) - lib
    assert calls == (0 if kernel else 1)


def test_grouped_kernel_route_runs_each_group_on_its_channels(monkeypatch):
    """A grouped 3x3 stride-1 convolution calls the kernels once a group
    forward and once a group for the input gradient, each on its group's
    channels, and equals the groups run one by one."""
    calls = []
    real = cv._run

    def spy(x, w, flip):
        calls.append((tuple(x.shape), tuple(w.shape), flip))
        return real(x, w, flip)

    monkeypatch.setattr(cv, "_run", spy)
    tm = tnn.SpatialConvolution(8, 6, 3, 3, 1, 1, 1, 1, n_group=2,
                                format="NHWC", device="cpu").reset(2)
    x = torch.randn(2, 5, 5, 8, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y = tm(x)
    y.sum().backward()
    assert calls == [((2, 5, 5, 4), (3, 3, 3, 4), False)] * 2 \
        + [((2, 5, 5, 3), (3, 3, 3, 4), True)] * 2
    with torch.no_grad():
        halves = [torch.nn.functional.conv2d(
            x[..., 4 * i:4 * i + 4].permute(0, 3, 1, 2),
            tm.weight[3 * i:3 * i + 3], tm.bias[3 * i:3 * i + 3], padding=1)
            for i in range(2)]
        want = torch.cat(halves, 1).permute(0, 2, 3, 1)
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=1e-5)


def test_grouped_init_divides_the_fans_and_dilation_still_raises():
    tm = tnn.SpatialConvolution(96, 256, 5, 5, n_group=2, device="cpu")
    w = tm.init_arrays(np.random.default_rng(0))["weight"]
    assert w.shape == (256, 48, 5, 5)
    bound = np.sqrt(6.0 / (25 * 48 + 25 * 128))
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    with pytest.raises(NotImplementedError, match="A.11"):
        tnn.SpatialConvolution(4, 4, 3, 3, dilation_w=2, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tnn.SpatialConvolution(6, 4, 3, 3, n_group=4, device="cpu")


# ---------------------------------------------------------------- dropout
def test_dropout_is_the_identity_where_the_reference_is():
    x = torch.randn(4, 7)
    g = torch.Generator().manual_seed(0)
    d = tnn.Dropout(0.5)
    assert d(x) is x                                  # no generator
    assert d(x, generator=g) is not x
    assert d.evaluate()(x, generator=g) is x          # evaluation
    assert tnn.Dropout(0.0).train()(x, generator=g) is x
    assert d.train().set_p(0.0)(x, generator=g) is x
    jx = jnp.asarray(x.numpy())
    jd = jnn.Dropout(0.5)
    for kw in ({"training": False, "rng": jax.random.PRNGKey(0)},
               {"training": True, "rng": None}):
        y, _ = jd.apply({}, {}, jx, **kw)
        np.testing.assert_array_equal(np.asarray(y), x.numpy())


@pytest.mark.parametrize("p", [0.1, 0.5, 0.7])
def test_dropout_keeps_one_minus_p_and_scales(p):
    n = 400_000
    x = torch.full((n,), 2.0)
    y = tnn.Dropout(p).train()(x, generator=torch.Generator().manual_seed(3))
    kept = y != 0
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - p)) < 4 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        2.0 / (1 - p)))
    unscaled = tnn.Dropout(p, scale=False).train()(
        x, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(unscaled[kept], x[kept])
    # the reference's keep rate over the same count, for comparison
    jy, _ = jnn.Dropout(p).apply({}, {}, jnp.full((n,), 2.0), training=True,
                                 rng=jax.random.PRNGKey(3))
    jkept = np.asarray(jy) != 0
    assert abs(jkept.mean() - (1 - p)) < 4 * sigma
    np.testing.assert_allclose(np.asarray(jy)[jkept], 2.0 / (1 - p),
                               rtol=1e-6)


def test_dropout_mask_follows_the_generator_and_the_layout():
    x = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    d = tnn.Dropout(0.4).train()

    def run(seed):
        return d(x, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1) == 0, run(2) == 0)
    assert run(1).is_contiguous(memory_format=torch.channels_last)


def test_flatten_matches_reference():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    got = tnn.Flatten()(torch.from_numpy(x))
    want = jnn.Flatten().call({}, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_containers_hand_the_generator_to_their_children():
    g = torch.Generator().manual_seed(0)
    inner = tnn.Sequential().add(tnn.Dropout(0.5))
    seq = tnn.Sequential().add(tnn.Identity()).add(
        tnn.Concat(1).add(inner).add(tnn.Dropout(0.5))).train()
    x = torch.ones(3, 4)
    y = seq(x, generator=g)
    assert tuple(y.shape) == (3, 8)
    assert bool((y == 0).any()) and bool((y == 2).any())
    torch.testing.assert_close(seq(x), torch.ones(3, 8), rtol=0, atol=0)
    assert tnn.takes_generator(seq) and tnn.takes_generator(inner)
    assert not tnn.takes_generator(tnn.Linear(2, 2, device="cpu"))
