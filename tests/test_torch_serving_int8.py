"""The port's int8 serving (``int8_kv``, ``int8_weights``, ``kv_bytes``)
against the JAX reference, on the CPU, on the tiny config of
``test_torch_serving.py``.

``int8_kv`` alone is row-local (one scale per written token and head), so
the threaded engines are compared: greedy tokens must be identical, with
the reference's Pallas kernel (``BIGDL_TPU_PAGED_KERNEL=1``, interpret
mode) and with its XLA gather path.

``int8_weights`` couples the rows of a dispatch: each activation is
quantised against one amax over the whole batch, junk rows included, so a
request's tokens depend on what else is in its batch and the threaded
engine (whose batching depends on timing) cannot be compared. Both
packages' ``PagedSlotManager`` are driven by hand instead, in one fixed
order, every request greedy. Their tokens must be identical or diverge
only at a step where the port's top-2 logit gap is below ``GAP`` = 1e-3:
there a difference in the last float32 bits may flip an int8 rounding and
so the argmax. (On these weights the logits agree to 3e-7 and the tokens
are identical.)
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.nn.quantized import quantize_params
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import paging as jax_paging
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import Int8Linear, quantize_model
from bigdl_tpu_torch.nn.quantized import qmatmul
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.serving import ServingEngine, paging

CFG = dict(vocab_size=97, hidden_size=64, n_layers=2, n_heads=4,
           max_position=64)
ENGINE = dict(max_slots=2, paged=True, page_size=8, prefill_chunk=8)
WAIT = 120.0
N_NEW = 8
GAP = 1e-3


def _prompts():
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 97, 19)
    return [np.concatenate([prefix, rng.integers(0, 97, 4)]),
            rng.integers(0, 97, 5),
            np.concatenate([prefix, rng.integers(0, 97, 2)]),
            rng.integers(0, 97, 11)]


def _jax_model(monkeypatch, kernel):
    # the reference reads its kernel flag when the attention is built
    monkeypatch.setenv("BIGDL_TPU_PAGED_KERNEL", "1" if kernel else "0")
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(1), None)
    return jm, params


def _port_model(params):
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return m


def _serve(engine, prompts):
    with engine.scheduler._cond:
        handles = [engine.submit(p, N_NEW) for p in prompts]
    return [engine.result(h, timeout=WAIT) for h in handles]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kv_token_bytes_and_pages_for_budget_match(int8, dtype):
    m = GPTForCausalLM(**CFG, device="cpu")
    jm = JaxGPT(**CFG)
    np_dtype = np.float32 if dtype == torch.float32 else jax.numpy.bfloat16
    want = jax_paging.kv_token_bytes(jm, int8, np_dtype)
    assert paging.kv_token_bytes(m, int8, dtype) == want
    for budget in (10 ** 6, 123_457, 2 ** 24):
        assert (paging.pages_for_budget(m, 8, budget, int8, dtype)
                == jax_paging.pages_for_budget(jm, 8, budget, int8,
                                               np_dtype))
    # GPT-2 small: 19,584 B against 73,728 B a token, 3.76x the tokens
    g2 = GPTForCausalLM(vocab_size=11, max_position=16, device="meta")
    assert paging.kv_token_bytes(g2, int8=True) == 19_584
    assert paging.kv_token_bytes(g2) == 73_728


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["jax_kernel", "jax_gather"])
def test_int8_kv_engine_matches_jax_engine(kernel, monkeypatch):
    jm, params = _jax_model(monkeypatch, kernel)
    prompts = _prompts()
    jeng = JaxEngine(jm, params, int8_kv=True, **ENGINE)
    try:
        want = _serve(jeng, prompts)
        jmet = jeng.metrics()
    finally:
        jeng.shutdown()
    launches = (paged_pool_attention.launches,
                paged_pool_attention.int8_launches)
    with ServingEngine(_port_model(params), device="cpu", int8_kv=True,
                       **ENGINE) as eng:
        got = _serve(eng, prompts)
        m = eng.metrics()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert m["retired"] == 4 and m["prefix_hits"] >= 1
    assert m["kv_dtype"] == jmet["kv_dtype"] == "int8"
    assert m["kv_bytes_per_token"] == jmet["kv_bytes_per_token"]
    assert m["pool_bytes"] == jmet["pool_bytes"]
    assert m["kv_bytes_per_token"] == paging.kv_token_bytes(
        eng.model, int8=True)
    # CPU tensors run the plain versions: no kernel launch of either kind
    assert (paged_pool_attention.launches,
            paged_pool_attention.int8_launches) == launches


def _drive(slots, logits):
    """Admit prompts 0 and 1 (one at a time, as ``admit`` does), then
    decode N_NEW greedy steps; returns tokens (2, N_NEW) and each step's
    top-2 logit gaps (2, N_NEW) from ``logits(slots)``."""
    prompts = _prompts()
    slots.admit(prompts[:2])
    toks, gaps = [], []
    for _ in range(N_NEW):
        top2 = np.sort(logits(slots), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        slots.reserve_block()
        toks.append(np.asarray(slots.step())[0])
    return np.stack(toks, 1), np.stack(gaps, 1)


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["jax_kernel", "jax_gather"])
def test_int8_weights_and_kv_hand_driven_match_jax(kernel, monkeypatch):
    jm, params = _jax_model(monkeypatch, kernel)
    kw = dict(page_size=8, prefill_chunk=8, window=2)
    js = jax_paging.PagedSlotManager(jm, quantize_params(params), 2,
                                     int8_kv=True, **kw)
    want, _ = _drive(js, lambda s: np.asarray(s._logits))
    model = quantize_model(_port_model(params))
    model.requires_grad_(False)
    calls = qmatmul.calls
    ts = paging.PagedSlotManager(model, 2, int8_kv=True, **kw)
    got, gaps = _drive(ts, lambda s: s._logits.numpy())
    # 6 int8 products a layer for each prefill chunk and decode step
    dispatches = ts.stats["prefill_chunks"] + ts.stats["steps"]
    assert qmatmul.calls - calls == 6 * CFG["n_layers"] * dispatches
    for row in range(2):
        miss = np.nonzero(got[row] != want[row])[0]
        if miss.size:
            assert gaps[row, miss[0]] < GAP, (row, miss[0], gaps[row])


def test_engine_int8_weights_int8_kv_and_kv_bytes(monkeypatch):
    _, params = _jax_model(monkeypatch, False)
    jm = JaxGPT(**CFG)
    budget = 50_000
    with ServingEngine(_port_model(params), device="cpu",
                       int8_weights=True, int8_kv=True, kv_bytes=budget,
                       **ENGINE) as eng:
        out = _serve(eng, _prompts()[:2])
        m = eng.metrics()
        assert isinstance(eng.model.gpt.layers[0].fc1, Int8Linear)
    assert [o.size for o in out] == [p.size + N_NEW for p in _prompts()[:2]]
    assert m["kv_dtype"] == "int8" and m["int8_matmuls"] > 0
    assert m["num_pages"] == jax_paging.pages_for_budget(jm, 8, budget,
                                                         int8=True)
    assert m["kv_bytes_per_token"] == jax_paging.kv_token_bytes(jm, True)
    # kv_pages wins over kv_bytes
    with ServingEngine(_port_model(params), device="cpu", int8_kv=True,
                       kv_bytes=budget, kv_pages=16, **ENGINE) as eng:
        assert eng.metrics()["num_pages"] == 16


def test_int8_flags_are_read(monkeypatch):
    _, params = _jax_model(monkeypatch, False)
    monkeypatch.setenv("BIGDL_TPU_INT8_WEIGHTS", "1")
    monkeypatch.setenv("BIGDL_TPU_INT8_KV", "1")
    with ServingEngine(_port_model(params), device="cpu", **ENGINE) as eng:
        assert eng.int8_weights and eng.slots.int8_kv
        assert eng.metrics()["kv_dtype"] == "int8"
        assert isinstance(eng.model.gpt.layers[1].attn.wq, Int8Linear)
    monkeypatch.setenv("BIGDL_TPU_INT8_WEIGHTS", "0")
    monkeypatch.setenv("BIGDL_TPU_INT8_KV", "off")
    with ServingEngine(_port_model(params), device="cpu", **ENGINE) as eng:
        assert not eng.int8_weights
        assert eng.metrics()["kv_dtype"] == "float32"
