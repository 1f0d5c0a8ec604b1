"""The port's fused sampling (``bigdl_tpu_torch/ops/sampling.py``) against
the JAX reference.

``fused_sample_logits_ref`` — the plain version the CUDA kernel is held
against on the card, and what the wrapper runs on CPU tensors — must
return the reference kernel's tokens (Pallas, interpret mode) when both
see the same gumbel noise: the reference draws it as
``jax.random.gumbel(key, shape, dtype)`` inside ``fused_sample_logits``,
and the test hands the same draw to the port. Tokens are compared for
equality: no top-p boundary of these seeded rows lies near its level.
Rows longer than ``MAX_VOCAB`` (60,000 here; Llama-3's 128,256 on the
card) take the kernel's scratch-row variant, whose launch a fake library
records on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.sampling import \
    fused_sample_logits as jax_fused_sample_logits
from bigdl_tpu_torch.models.gpt import sample_logits
from bigdl_tpu_torch.ops import sampling as sm
from bigdl_tpu_torch.ops.sampling import (MAX_VOCAB, fused_sample_logits,
                                          fused_sample_logits_ref,
                                          gumbel_noise)

S, V = 8, 97
LONG_V = 60000        # above MAX_VOCAB: the kernel's scratch-row variant
TEMPS = np.array([0.5, 0.8, 1.0, 1.3, 0.7, 0.9, 1.1, 0.6], np.float32)


def _case(seed, v=V):
    rng = np.random.default_rng(seed)
    logits = 3.0 * rng.standard_normal((S, v), dtype=np.float32)
    key = jax.random.PRNGKey(seed)
    gumbel = np.array(jax.random.gumbel(key, (S, v), jnp.float32))
    return logits, key, gumbel


@pytest.mark.parametrize("top_k,top_p,vocab", [
    (None, None, V), (10, None, V), (None, 0.9, V), (10, 0.9, V),
    (50, 0.9, LONG_V),
], ids=["none", "topk", "topp", "both", "both-long"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ref_matches_jax_kernel(top_k, top_p, vocab, seed):
    logits, key, gumbel = _case(seed, vocab)
    want = np.asarray(jax_fused_sample_logits(
        jnp.asarray(logits), key, jnp.asarray(TEMPS)[:, None], top_k, top_p,
        interpret=True))
    got = fused_sample_logits_ref(torch.from_numpy(logits),
                                  torch.from_numpy(gumbel),
                                  torch.from_numpy(TEMPS), top_k, top_p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k,top_p", [(10, None), (None, 0.9), (10, 0.9)],
                         ids=["topk", "topp", "both"])
def test_ref_matches_sort_based_chain(top_k, top_p):
    # a second oracle: the reference's multi-op chain (top_k / sort /
    # cumsum) on the same noise keeps the same set
    logits, _, gumbel = _case(7)
    lt, gt, tt = (torch.from_numpy(logits), torch.from_numpy(gumbel),
                  torch.from_numpy(TEMPS)[:, None])
    want = sample_logits(lt, gt, tt, top_k, top_p)
    got = fused_sample_logits_ref(lt, gt, tt, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int32))


def test_top_k_at_vocab_is_disabled():
    logits, _, gumbel = _case(3)
    lt, gt = torch.from_numpy(logits), torch.from_numpy(gumbel)
    np.testing.assert_array_equal(
        fused_sample_logits_ref(lt, gt, 1.0, V, None).numpy(),
        fused_sample_logits_ref(lt, gt, 1.0, None, None).numpy())


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    logits, _, gumbel = _case(4)
    lt, gt = torch.from_numpy(logits), torch.from_numpy(gumbel)
    before = fused_sample_logits.launches
    got = fused_sample_logits(lt, gt, torch.from_numpy(TEMPS), 10, 0.9)
    want = fused_sample_logits_ref(lt, gt, torch.from_numpy(TEMPS), 10, 0.9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert fused_sample_logits.launches == before


def test_gumbel_noise_is_seeded_and_standard():
    g1 = gumbel_noise((4, 4096), torch.Generator().manual_seed(5), "cpu")
    g2 = gumbel_noise((4, 4096), torch.Generator().manual_seed(5), "cpu")
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)
    assert torch.isfinite(g1).all()
    # the standard gumbel has mean ~0.5772 (Euler-Mascheroni)
    assert abs(g1.mean().item() - 0.5772) < 0.05


class _FakeLib:
    """Records the C entry called and its arguments; launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("vocab,long_row", [(50257, False),
                                            (MAX_VOCAB, False),
                                            (MAX_VOCAB + 1, True),
                                            (128256, True)])
def test_launch_passes_a_scratch_for_long_rows(monkeypatch, vocab, long_row):
    """The wrapper's card branch: a row of at most MAX_VOCAB logits stays
    in the kernel's shared memory (no scratch, ``.launches``); a longer
    one gets an (S, V) float32 scratch and moves ``.long_row_launches``.
    Nothing refuses a long row. The library and the card are faked."""
    assert LONG_V > MAX_VOCAB == 57856
    lib = _FakeLib()
    monkeypatch.setattr(sm._build, "load", lambda name, declare: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(fused_sample_logits, "launches", 0)
    monkeypatch.setattr(fused_sample_logits, "long_row_launches", 0)
    allocated = []
    real_empty = torch.empty

    def empty(*args, **kw):
        t = real_empty(*args, **kw)
        allocated.append(t)
        return t

    monkeypatch.setattr(sm.torch, "empty", empty)
    logits = torch.zeros(2, vocab, dtype=torch.bfloat16)
    out = sm._launch(logits, logits, torch.ones(2), 50, 0.9)
    [(name, args)] = lib.calls
    assert name == "bigdl_fused_sample" and out.shape == (2,)
    assert args[5:11] == (2, vocab, 50, 0.9, 1, 7)
    if long_row:
        [_, scratch] = allocated
        assert scratch.shape == (2, vocab) and scratch.dtype == torch.float32
        assert args[4] == scratch.data_ptr()
    else:
        assert args[4] is None and len(allocated) == 1
    assert (fused_sample_logits.launches,
            fused_sample_logits.long_row_launches) == (
        (0, 1) if long_row else (1, 0))
