"""The port's flash attention (``bigdl_tpu_torch/ops/flash_attention.py``)
against the JAX reference's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the reference's
kernels run in Pallas interpret mode, as its own tests run them, with
``block_q = block_k = 32`` so a (1, 2, 128, 16) problem walks several
tiles. Tolerances are the reference's own (``tests/
test_flash_attention.py``): O and lse at rtol 2e-4, atol 2e-5; gradients
at rtol 1e-3, atol 1e-4. The CUDA kernels themselves are held against
the plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash_with_lse
from bigdl_tpu.parallel.sequence import MultiHeadAttention as JaxMHA
from bigdl_tpu.parallel.sequence import full_attention as jax_full_attention
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               full_attention)

SHAPE = (1, 2, 128, 16)
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _qkv(shape=SHAPE, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


def _port_grads(q, k, v, causal, with_lse):
    """(o, lse, (dq, dk, dv)) of the port's function for sum(sin(o)) (+
    sum(cos(lse)) when ``with_lse``)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*ts, causal=causal)
    loss = torch.sin(o).sum()
    if with_lse:
        loss = loss + torch.cos(lse).sum()
    loss.backward()
    return (o.detach().numpy(), lse.detach().numpy(),
            [t.grad.numpy() for t in ts])


@pytest.fixture(scope="module", params=[False, True],
                ids=["full", "causal"])
def reference(request):
    """The reference kernels' outputs and gradients on the seeded inputs,
    computed once per ``causal``."""
    causal = request.param
    q, k, v = _qkv()
    kw = dict(causal=causal, block_q=32, block_k=32)
    o, lse = jax_flash_with_lse(*map(jnp.asarray, (q, k, v)), **kw)

    def plain(q, k, v):
        return jnp.sum(jnp.sin(jax_flash(q, k, v, **kw)))

    def with_lse(q, k, v):
        o, lse = jax_flash_with_lse(q, k, v, **kw)
        return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(lse))

    grads = {name: [np.asarray(g) for g in
                    jax.grad(f, argnums=(0, 1, 2))(q, k, v)]
             for name, f in (("plain", plain), ("lse", with_lse))}
    return causal, (q, k, v), np.asarray(o), np.asarray(lse), grads


def test_forward_matches_pallas_kernel(reference):
    causal, (q, k, v), o, lse, _ = reference
    got_o, got_lse, _ = _port_grads(q, k, v, causal, with_lse=False)
    np.testing.assert_allclose(got_o, o, **FWD_TOL)
    np.testing.assert_allclose(got_lse, lse, **FWD_TOL)


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o+lse"])
def test_gradients_match_pallas_kernels(reference, with_lse):
    causal, (q, k, v), _, _, grads = reference
    _, _, got = _port_grads(q, k, v, causal, with_lse)
    for g, want in zip(got, grads["lse" if with_lse else "plain"]):
        np.testing.assert_allclose(g, want, **GRAD_TOL)


def _autograd_oracle(q, k, v, do, dlse, causal):
    """o, lse and (dq, dk, dv) by autograd of the plain formula in
    float64: o = softmax(s) v, lse = logsumexp(s)."""
    ts = [torch.from_numpy(a).double().requires_grad_(True)
          for a in (q, k, v)]
    s = torch.einsum("bhqd,bhkd->bhqk", ts[0], ts[1]) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[2]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                          float("-inf"))
    o = torch.softmax(s, dim=-1) @ ts[2]
    lse = torch.logsumexp(s, dim=-1)
    grads = torch.autograd.grad(
        (o * torch.from_numpy(do).double()).sum()
        + (lse * torch.from_numpy(dlse).double()).sum(), ts)
    return o.detach(), lse.detach(), grads


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_each_plain_version_matches_autograd(causal):
    q, k, v = _qkv(seed=3)
    rs = np.random.RandomState(4)
    do = rs.randn(*SHAPE).astype(np.float32)
    dlse = rs.randn(*SHAPE[:3]).astype(np.float32)
    o_want, lse_want, (dq_w, dk_w, dv_w) = _autograd_oracle(q, k, v, do,
                                                           dlse, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_fwd_ref(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), o_want.numpy(), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_want.numpy(), **FWD_TOL)
    delta = (tdo * o).sum(-1)
    args = (tq, tk, tv, tdo, lse, delta, torch.from_numpy(dlse), causal)
    dq = fa.flash_bwd_dq_ref(*args)
    dk, dv = fa.flash_bwd_dkv_ref(*args)
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ragged_sequence_matches_full_attention(causal):
    """S = 100 fits no 32- or 64-row tile; the reference needs S % block
    == 0, the port needs nothing of S."""
    q, k, v = _qkv((2, 2, 100, 16), seed=5)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jax_full_attention(q, k, v, causal=causal)))

    want_o = np.asarray(jax_full_attention(q, k, v, causal=causal))
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    got_o, _, got_g = _port_grads(q, k, v, causal, with_lse=False)
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for g, want in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(want), **GRAD_TOL)
    torch.testing.assert_close(
        full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal),
        torch.from_numpy(want_o), **FWD_TOL)


def test_bfloat16_stays_within_the_card_tolerance():
    """bfloat16 inputs (p and ds rounded as the kernels round them) stay
    within the card's bfloat16 tolerance, atol = rtol = 2e-2, of the
    float32 result on the same rounded inputs."""
    q, k, v = [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(seed=6)]
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        ts = [t.to(dtype).detach().requires_grad_(True) for t in (q, k, v)]
        o = fa.flash_attention(*ts, causal=True)
        torch.sin(o.float()).sum().backward()
        outs[dtype] = [o] + [t.grad for t in ts]
    for got, want in zip(outs[torch.bfloat16], outs[torch.float32]):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


def test_cpu_wrappers_run_plain_versions_without_launching():
    q, k, v = map(torch.from_numpy, _qkv(seed=7))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    torch.testing.assert_close(o, fa.flash_fwd_ref(q, k, v, True)[0],
                               rtol=0, atol=0)
    delta = (o * o).sum(-1)
    fa.flash_bwd_dq(q, k, v, o, lse, delta, causal=True)
    fa.flash_bwd_dkv(q, k, v, o, lse, delta, causal=True)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before


def test_cuda_argument_checks_refuse_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa._check_cuda_args("flash_fwd", q, {"k": q, "v": q}, {})
    # every head dim from 1 runs (above 256 in chunks); 0 is refused
    with pytest.raises(ValueError, match=r"\(B, H, S, D\) with D >= 1"):
        fa._check_cuda_args("flash_fwd", torch.zeros(1, 2, 8, 0), {}, {})
    with pytest.raises(TypeError, match="float16"):
        fa._check_cuda_args("flash_fwd", q.half(), {}, {})


def test_bytes_and_flops_count_the_visible_triangle():
    """The training path's shape: 96 (batch, head) rows of 1024 tokens,
    head_dim 64; causal attention sees 50.4 M (query, key) pairs."""
    q = torch.empty(8, 12, 1024, 64)
    pairs = fa.visible_pairs(8, 12, 1024, causal=True)
    assert pairs == 96 * 1024 * 1025 // 2 == 50380800
    plane, row = 96 * 1024 * 64 * 4, 96 * 1024 * 4
    assert fa.bytes_and_flops("fwd", q, True) == (4 * plane + row,
                                                  256 * pairs)
    assert fa.bytes_and_flops("dq", q, True) == (5 * plane + 2 * row,
                                                 256 * pairs)
    assert fa.bytes_and_flops("dkv", q, True, dlse=True) == (
        6 * plane + 3 * row, 256 * pairs)
    assert fa.bytes_and_flops("fwd", q, False)[1] == 256 * 96 * 1024 ** 2


def test_attention_module_forward_matches_reference():
    """``MultiHeadAttention.forward`` (causal, flash) against the
    reference's ``call`` with its flash kernel switched on (weights
    transposed from the reference's (in, out) to torch's (out, in))."""
    jm = JaxMHA(32, 2, causal=True, use_flash=True)
    params, _ = jm.setup(jax.random.PRNGKey(1), None)
    x = np.random.RandomState(8).randn(2, 128, 32).astype(np.float32)
    want = np.asarray(jm.call(params, jnp.asarray(x)))
    tm = MultiHeadAttention(32, 2, causal=True, device="cpu")
    tm.load_state_dict({f"{w}.weight": torch.from_numpy(
        np.array(np.asarray(params[w]).T, order="C"))
        for w in ("wq", "wk", "wv", "wo")})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    # the ring form over two CPU shards gives the same forward
    ring = MultiHeadAttention(32, 2, causal=True, sequence_parallel=(
        "ring", ["cpu", "cpu"], "sp"), device="cpu")
    ring.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = ring(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
