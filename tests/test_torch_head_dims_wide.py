"""Head dims above 256 (ROADMAP queue C4), on the CPU.

On the card the CUDA-core flash kernels and the paged kernel run a head
dim above 256 on their width-256 instantiations in chunks of 256 values
a row, the chunk a grid axis (``ops/csrc/flash_attention.cu``,
``ops/csrc/paged_attention.cuh``). Here:

- a GPT at head dim 320 (hidden 640, 2 heads, 2 layers): its training
  forward, loss and gradients equal the reference's (whose layers run
  their Pallas flash kernel in interpret mode), rtol 1e-4 / atol 1e-6, and
  its paged engine's greedy tokens equal the reference's paged engine's;
- the host plans (``path``, ``kernel_head_dim``, ``head_dim_chunks``,
  ``cc_plan``, ``paged_plan``, ``kernel_width``) give the chunked launch
  at 320, 512 and 1024;
- no wrapper refuses such a head dim: each goes on to its device check;
- the flash wrapper's zero padding to the next multiple of 256 is exact:
  the plain versions at the padded width, with the true width's softmax
  scale, equal the true width's within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JaxCE
from bigdl_tpu.parallel import sequence as jax_sequence
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import CrossEntropyCriterion
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import paged_attention as pa
from bigdl_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=97, hidden_size=640, n_layers=2, n_heads=2,
           max_position=128)
B, T = 2, 128


@pytest.fixture(scope="module")
def ref():
    jm = JaxGPT(**CFG)
    for lyr in jm.gpt.layers:
        lyr.attn.use_flash = True
    params, _ = jm.setup(jax.random.PRNGKey(3), None)
    tree = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.RandomState(1).randint(0, 97, (B, T + 1)).astype(
        np.int32)
    return jm, params, tree, ids[:, :-1], ids[:, 1:].reshape(-1)


def test_gpt_head_dim_320_trains_like_reference(ref, monkeypatch):
    jm, _, tree, x, y = ref

    def no_fallback(*a, **kw):
        raise AssertionError("the reference left its flash kernel")

    monkeypatch.setattr(jax_sequence, "full_attention", no_fallback)

    def loss_fn(p):
        logits, _ = jm.apply(p, (), jnp.asarray(x), training=True)
        return JaxCE().apply(logits, jnp.asarray(y)), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tm = GPTForCausalLM(**CFG, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tree))
    got_logits = tm(torch.from_numpy(x).long())
    got_loss = CrossEntropyCriterion()(got_logits,
                                       torch.from_numpy(y).long())
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-4)
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, rtol=1e-4, atol=1e-6)


def test_gpt_head_dim_320_paged_greedy_tokens_match_reference(ref):
    """Greedy tokens of 3 prompts on 2 slots through the paged engines
    (one admitted mid-flight)."""
    jm, params, tree, _, _ = ref
    engine = dict(max_slots=2, paged=True, page_size=8, prefill_chunk=8)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, n) for n in (13, 5, 9)]
    jeng = JaxEngine(jm, params, **engine)
    try:
        hs = [jeng.submit(p, 6) for p in prompts]
        want = [np.asarray(jeng.result(h, timeout=300)) for h in hs]
    finally:
        jeng.shutdown()
    tm = GPTForCausalLM(**CFG, device="cpu")
    with ServingEngine(tm, convert.params_from_jax(tree), device="cpu",
                       **engine) as eng:
        hs = [eng.submit(p, 6) for p in prompts]
        got = [eng.result(h, timeout=300) for h in hs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("d,width,chunks", [(320, 512, 2), (512, 512, 2),
                                            (1024, 1024, 4), (257, 512, 2),
                                            (256, 256, 1)])
def test_flash_plans_give_the_chunked_launch(d, width, chunks):
    for fn in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for dtype in (torch.float32, torch.bfloat16):
            assert fa.path(fn, dtype, d) == "cuda_cores"
    assert fa.kernel_head_dim(d) == width
    assert fa.head_dim_chunks(d) == chunks
    for kernel in ("fwd", "dq", "dkv"):
        plan = fa.cc_plan(kernel, 8, 1000, d)
        assert plan["grid"] == (8, 32, chunks)
        assert (plan["head_dim"], plan["tile_rows"], plan["chunks"]) == (
            256, 32, chunks)
        # the staged tiles of width 256, whatever the head dim
        assert plan["smem_bytes"] == fa.cc_plan(kernel, 8, 1000, 256)[
            "smem_bytes"] <= fa.TC_MAX_SMEM
    with pytest.raises(ValueError, match="no tensor-core kernel"):
        fa.tc_plan("fwd", 8, 1000, d)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d,chunks", [(320, 2), (512, 2), (1024, 4)])
def test_paged_plans_give_the_chunked_launch(d, chunks, kv):
    assert pa.kernel_width(d) == 256 and pa.head_dim_chunks(d) == chunks
    for c, tiles in ((1, 1), (64, 4)):
        plan = pa.paged_plan(4, 12, c, d, 16, 64, [0, 5, 9, 600], kv)
        at_256 = pa.paged_plan(4, 12, c, 256, 16, 64, [0, 5, 9, 600], kv)
        assert plan["grid"] == (pa.SPLIT, 48, tiles * chunks)
        assert (plan["head_dim"], plan["chunks"]) == (256, chunks)
        assert plan["smem_bytes"] == at_256["smem_bytes"] <= pa.MAX_SMEM
        assert plan["splits"] == at_256["splits"]


@pytest.mark.parametrize("d", [320, 512, 1024])
def test_no_wrapper_refuses_a_head_dim_above_256(d):
    for fn in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.zeros(1, 2, 8, d, dtype=dtype)
            with pytest.raises(ValueError, match="needs a CUDA tensor"):
                fa._check_cuda_args(fn, q, {}, {})
    for int8 in (False, True):
        dtype = torch.int8 if int8 else torch.float32
        pool = {"k": torch.zeros((6, 4, 16, d), dtype=dtype),
                "v": torch.zeros((6, 4, 16, d), dtype=dtype)}
        if int8:
            pool.update(k_scale=torch.zeros((6, 4, 16)),
                        v_scale=torch.zeros((6, 4, 16)))
        pa._check_cuda_args(torch.zeros((2, 4, 1, d)), pool,
                            torch.zeros((2, 3), dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [320, 300])
def test_flash_padding_to_chunks_is_exact(d, causal):
    """The plain versions at the launched width (zero columns past ``d``)
    with ``d``'s softmax scale equal the true width's: what the wrapper
    hands the chunked kernels and slices back."""
    g = torch.Generator().manual_seed(d)
    q, k, v, do = [torch.randn((1, 2, 96, d), generator=g)
                   for _ in range(4)]
    width = fa.kernel_head_dim(d)
    scale = d ** -0.5

    def wide(t):
        return torch.nn.functional.pad(t, (0, width - d))

    o, lse = fa.flash_fwd_ref(q, k, v, causal, scale)
    wo, wlse = fa.flash_fwd_ref(wide(q), wide(k), wide(v), causal, scale)
    torch.testing.assert_close(wo[..., :d], o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wlse, lse, rtol=1e-6, atol=1e-6)
    delta = (do * o).sum(-1)
    dq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, None, causal, scale)
    wdq = fa.flash_bwd_dq_ref(wide(q), wide(k), wide(v), wide(do), lse,
                              delta, None, causal, scale)
    torch.testing.assert_close(wdq[..., :d], dq, rtol=1e-6, atol=1e-6)
    dk, dv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, None, causal,
                                  scale)
    wdk, wdv = fa.flash_bwd_dkv_ref(wide(q), wide(k), wide(v), wide(do),
                                    lse, delta, None, causal, scale)
    torch.testing.assert_close(wdk[..., :d], dk, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wdv[..., :d], dv, rtol=1e-6, atol=1e-6)
