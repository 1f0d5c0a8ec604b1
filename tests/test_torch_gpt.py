"""The port's GPT (``bigdl_tpu_torch/models/gpt.py``) against the JAX
reference on the same weights.

``convert.params_from_jax`` round-trips the reference's params pytree into
the port's state_dict; then chunked-prefill and decode-step logits through
the paged pools must match the reference's at atol = rtol = 1e-4 (float32
on both sides; the reference's flag-off XLA gather path against the
port's plain paged-attention version).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM, prompt_bucket
from bigdl_tpu_torch.nn import LayerNormalization, Linear

CFG = dict(vocab_size=97, hidden_size=64, n_layers=2, n_heads=4,
           max_position=64)
PS, CHUNK = 8, 8


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = GPTForCausalLM(**CFG, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tree))
    tm.requires_grad_(False)
    return jm, params, tree, tm


def test_params_round_trip(pair):
    _, _, tree, tm = pair
    sd = convert.params_from_jax(tree)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert v.shape == sd[k].shape, k
    # Linear weights are transposed: the port's F.linear equals x @ W + b
    fc1 = tree["gpt"]["layers"][1]["fc1"]
    x = np.random.default_rng(0).standard_normal((3, 64), dtype=np.float32)
    got = tm.gpt.layers[1].fc1(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x @ fc1["weight"] + fc1["bias"],
                               rtol=1e-5, atol=1e-5)
    wq = tree["gpt"]["layers"][0]["attn"]["wq"]
    np.testing.assert_array_equal(
        tm.gpt.layers[0].attn.wq.weight.numpy(), wq.T)


def test_init_params_loads_and_is_seeded():
    m = GPTForCausalLM(**CFG, device="cpu")
    a, b = convert.init_params(m, 3), convert.init_params(m, 3)
    m.load_state_dict(a)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert float(a["gpt.tok_emb"].std()) == pytest.approx(0.02, rel=0.1)


def test_layers_match_reference_formulas():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 8), dtype=np.float32))
    ln = LayerNormalization(8, device="cpu")
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)      # biased
    torch.testing.assert_close(ln(x), (x - mean) / torch.sqrt(var + 1e-5),
                               rtol=1e-5, atol=1e-5)
    lin = Linear(8, 3, with_bias=False, device="cpu")
    torch.nn.init.normal_(lin.weight)
    torch.testing.assert_close(lin(x), x @ lin.weight.T)
    assert prompt_bucket(17, 64) == 32 and prompt_bucket(70, 64) == 70


def test_paged_prefill_and_decode_logits_match(pair):
    jm, params, _, tm = pair
    rng = np.random.default_rng(2)
    lens = [13, 6]
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in lens]
    num_pages = 10
    p = CFG["max_position"] // PS
    table = np.full((2, p), num_pages, np.int32)
    table[0, :2] = [0, 1]
    table[1, :1] = [2]
    jpools = jm.gpt.init_paged_pool(num_pages, PS)
    tpools = tm.gpt.init_paged_pool(num_pages, PS)
    done = [0, 0]
    with torch.no_grad():
        while any(d < n for d, n in zip(done, lens)):
            ids = np.zeros((2, CHUNK), np.int32)
            start = np.array(done, np.int32)
            nvalid = np.ones(2, np.int32)
            write_from = np.array(done, np.int32)
            for i in range(2):
                n = min(CHUNK, lens[i] - done[i])
                if n <= 0:        # finished row: write nothing
                    write_from[i] = CFG["max_position"]
                    start[i] = lens[i] - 1
                    continue
                ids[i, :n] = prompts[i][done[i]:done[i] + n]
                nvalid[i] = n
            jh, jpools = jm.gpt.paged_prefill_chunk(
                params["gpt"], jpools, table, ids, start, nvalid,
                write_from, PS)
            th, tpools = tm.gpt.paged_prefill_chunk(
                tpools, table, ids, start, nvalid, write_from, PS)
            want = np.asarray(jm._lm_logits(params, jh))
            got = tm._lm_logits(th).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            done = [min(d + CHUNK, n) for d, n in zip(done, lens)]
        # decode steps on top of the prefilled pools, greedy from the
        # port's logits, the same tokens fed to both
        pos = np.array(lens, np.int64)
        for _ in range(3):
            tok = np.argmax(got, axis=-1).astype(np.int32)
            for i in range(2):
                if table[i, pos[i] // PS] == num_pages:
                    table[i, pos[i] // PS] = 3 + i + int(pos[i] // PS)
            jh, jpools = jm.gpt.paged_decode_step(
                params["gpt"], jpools, table, tok, pos.astype(np.int32), PS)
            th, tpools = tm.gpt.paged_decode_step(tpools, table,
                                                  torch.from_numpy(tok),
                                                  pos, PS)
            want = np.asarray(jm._lm_logits(params, jh))
            got = tm._lm_logits(th).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            pos += 1


def test_gelu_is_the_tanh_approximation(pair):
    _, _, _, tm = pair
    x = torch.linspace(-3, 3, 50)
    want = np.asarray(jax.nn.gelu(x.numpy()))
    np.testing.assert_allclose(F.gelu(x, approximate="tanh").numpy(), want,
                               rtol=1e-6, atol=1e-6)
