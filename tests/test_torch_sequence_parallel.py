"""The port's sequence parallelism (``bigdl_tpu_torch/parallel/
sequence.py``: ``ring_attention`` with its two ring bodies,
``ulysses_attention``, ``sequence_attention`` and ``MultiHeadAttention``'s
three ``sequence_parallel`` forms) against the JAX reference.

The reference runs on the 8 virtual CPU devices of ``tests/conftest.py``
(a 1-axis ``("seq",)`` mesh of 4 or 8 of them); the port on a list of as
many ``"cpu"`` devices. The reference's ring with ``use_flash=True`` runs
its Pallas flash kernels in interpret mode; the port's ring always runs
its flash body, whose wrappers take their plain versions on the CPU. Bars:
forward atol 1e-5 (the reference's own sequence-parallel bar is rtol 2e-4
/ atol 2e-5 against ``full_attention``), gradients within 1e-4 x each
tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bigdl_tpu.parallel import sequence as js
from bigdl_tpu.utils.jax_compat import shard_map
from bigdl_tpu_torch.parallel import sequence as ts

B, T, D = 2, 32, 8


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def _qkv(h=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, T, D), dtype=np.float32)
            for _ in range(4)]                  # q, k, v and a cotangent


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _ref_out_and_grads(fn, args, w):
    """The reference's output of ``fn(*args)`` and the gradients of
    sum(output * w) with respect to ``args``, in one jitted program."""
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return np.asarray(out), grads


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [4, 8])
def test_ring_matches_reference(multi_device_cpu, n, causal, use_flash):
    """The output, and dQ, dK, dV of sum(out * w): the port's backward
    feeds the merge's lse cotangent to its flash backward."""
    q, k, v, w = _qkv()
    mesh = _mesh(n)
    ref, want = _ref_out_and_grads(
        lambda q, k, v: js.ring_attention(q, k, v, mesh, "seq",
                                          causal=causal,
                                          use_flash=use_flash),
        (q, k, v), w)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    got = ts.ring_attention(tq, tk, tv, ["cpu"] * n, "seq", causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5)
    (got * _t(w)).sum().backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad), want):
        _grad_close(g.numpy(), r)
    # the reference's plain body, kept in the port for the tests
    chunks = [ts.shard_sequence(_t(a), ["cpu"] * n) for a in (q, k, v)]
    plain = torch.cat(ts.ring_local(*chunks, causal=causal), 2)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-5)


def test_causal_ring_skips_the_masked_pairs(monkeypatch):
    """n (n + 1) / 2 flash calls for a causal ring of n, n^2 full."""
    calls = []
    real = ts.flash_attention_with_lse

    def counted(q, k, v, causal=False):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ts, "flash_attention_with_lse", counted)
    q, k, v, _ = _qkv()
    for causal, want in ((True, 10), (False, 16)):
        calls.clear()
        ts.ring_attention(_t(q), _t(k), _t(v), ["cpu"] * 4, causal=causal)
        assert len(calls) == want
        assert sum(calls) == (4 if causal else 0)   # the diagonal pairs


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [4, 8])
def test_ulysses_matches_reference(multi_device_cpu, n, causal):
    q, k, v, w = _qkv(h=8)
    mesh = _mesh(n)
    ref, want = _ref_out_and_grads(
        lambda q, k, v: js.ulysses_attention(q, k, v, mesh, "seq",
                                             causal=causal), (q, k, v), w)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    got = ts.ulysses_attention(tq, tk, tv, ["cpu"] * n, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5)
    (got * _t(w)).sum().backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad), want):
        _grad_close(g.numpy(), r)


def test_ulysses_rejects_indivisible_heads(multi_device_cpu):
    q, k, v, _ = _qkv(h=6)
    with pytest.raises(ValueError, match="not divisible"):
        js.ulysses_attention(q, k, v, _mesh(8), "seq")
    with pytest.raises(ValueError, match="not divisible"):
        ts.ulysses_attention(_t(q), _t(k), _t(v), ["cpu"] * 8)


def test_indivisible_sequence_is_refused():
    q = _t(_qkv()[0][:, :, :30])
    with pytest.raises(ValueError, match="does not split"):
        ts.ring_attention(q, q, q, ["cpu"] * 4)


@pytest.mark.parametrize("heads,picked", [(8, "ulysses"), (6, "ring")])
def test_sequence_attention_choice(multi_device_cpu, monkeypatch, heads,
                                   picked):
    q, k, v, _ = _qkv(h=heads)
    ref = np.asarray(js.sequence_attention(q, k, v, _mesh(8), "seq",
                                           causal=True))
    seen = []
    for name in ("ring_attention", "ulysses_attention"):
        real = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _r=real, _n=name, **kw: (
            seen.append(_n), _r(*a, **kw))[1])
    got = ts.sequence_attention(_t(q), _t(k), _t(v), ["cpu"] * 8,
                                causal=True)
    assert seen == [f"{picked}_attention"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


# ------------------------------------------------------- MultiHeadAttention
HS, NH, N = 16, 4, 4


def _mha_case(seed=3):
    rng = np.random.default_rng(seed)
    params = {w: rng.standard_normal((HS, HS), dtype=np.float32) * 0.3
              for w in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((B, T, HS), dtype=np.float32)
    return params, x, rng.standard_normal((B, T, HS), dtype=np.float32)


def _port_mha(params, sp, causal):
    m = ts.MultiHeadAttention(HS, NH, causal, sequence_parallel=sp,
                              device="cpu")
    m.load_state_dict({f"{w}.weight": torch.from_numpy(a.T.copy())
                       for w, a in params.items()})
    return m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses", "ring_inner"])
def test_mha_sequence_parallel_forms(multi_device_cpu, kind, causal):
    """Forward, and the gradients of the weights and of x, in each form,
    against the reference's layer (``ring_inner`` inside its
    ``shard_map``, as its train step runs it)."""
    params, x, w = _mha_case()
    mesh = _mesh(N)
    if kind == "ring_inner":
        jm = js.MultiHeadAttention(HS, NH, sequence_parallel=(
            "ring_inner", "seq", N), causal=causal)
        spec = P(None, "seq", None)
        call = shard_map(jm.call, mesh=mesh, in_specs=(P(), spec),
                         out_specs=spec, check_vma=False)
        tsp = ("ring_inner", "seq", N)
    else:
        jm = js.MultiHeadAttention(HS, NH, sequence_parallel=(
            kind, mesh, "seq"), causal=causal)
        call = jm.call
        tsp = (kind, ["cpu"] * N, "seq")

    ref, (g_params, g_x) = _ref_out_and_grads(call, (params, x), w)

    tm = _port_mha(params, tsp, causal)
    tx = _t(x, grad=True)
    if kind == "ring_inner":
        outs = tm(list(tx.chunk(N, 1)))
        assert len(outs) == N
        out = torch.cat(outs, 1)
    else:
        out = tm(tx)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    (out * _t(w)).sum().backward()
    _grad_close(tx.grad.numpy(), g_x)
    for name in params:
        _grad_close(getattr(tm, name).weight.grad.numpy().T, g_params[name])


def test_mha_cache_paths_refuse_sequence_parallel():
    m = ts.MultiHeadAttention(HS, NH, causal=True, sequence_parallel=(
        "ring", ["cpu"] * 2, "seq"), device="cpu")
    cache = m.init_cache(1, 8, torch.float32, "cpu")
    x = torch.zeros(1, 4, HS)
    with pytest.raises(ValueError, match="sequence_parallel"):
        m.prefill_heads(x, cache)
    with pytest.raises(ValueError, match="sequence_parallel"):
        m.decode_heads(x[:, :1], cache, 4)
    with pytest.raises(ValueError, match="sequence_parallel"):
        m.paged_qkv(x, m.init_paged_pool(4, 4, torch.float32, "cpu"), None)


def test_mha_rejects_unknown_form_and_tp():
    with pytest.raises(ValueError, match="kind"):
        ts.MultiHeadAttention(HS, NH, sequence_parallel=("rings", [], "s"),
                              device="cpu")
    with pytest.raises(ValueError, match="tp"):
        ts.MultiHeadAttention(HS, NH, sequence_parallel=(
            "ring_inner", "seq", 2), tp=2, device="cpu")
