"""The port's fused sampling (``bigdl_tpu_torch/ops/sampling.py``) against
the JAX reference.

``fused_sample_logits_ref`` — the plain version the CUDA kernel is held
against on the card, and what the wrapper runs on CPU tensors — must
return the reference kernel's tokens (Pallas, interpret mode) when both
see the same gumbel noise: the reference draws it as
``jax.random.gumbel(key, shape, dtype)`` inside ``fused_sample_logits``,
and the test hands the same draw to the port. Tokens are compared for
equality: no top-p boundary of these seeded rows lies near its level.
The kernel's card branch (which variant a row length takes, the C entry's
arguments) is checked against a fake library on the CPU; the kernel's
algorithm is emulated in ``test_torch_sample_plan.py``.
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
LONG_V = 60000        # a row longer than the previous kernel's smem row
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
                                            (128256, False),
                                            (MAX_VOCAB, False),
                                            (MAX_VOCAB + 1, True),
                                            (600000, True)])
def test_launch_passes_a_scratch_for_long_rows(monkeypatch, vocab, long_row):
    """The wrapper's card branch: a row of at most MAX_VOCAB logits
    (Llama-3's 128,256 among them) lives in the cluster's shared memory
    (``.launches``); a longer one moves ``.long_row_launches`` and, as
    every row, takes no scratch: the kernel re-reads it from global
    memory. Nothing refuses a long row. The C entry gets the row's
    fixed-point bits. The library and the card are faked."""
    assert LONG_V < MAX_VOCAB == 428032
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
    assert args[4] is None                       # no paths asked for
    assert args[5:12] == (2, vocab, 50, 0.9, sm.mass_bits(vocab), 1, 7)
    [only] = allocated                           # the tokens, no scratch
    assert only.shape == (2,) and only.dtype == torch.int32
    assert (fused_sample_logits.launches,
            fused_sample_logits.long_row_launches) == (
        (0, 1) if long_row else (1, 0))
    assert sm.sample_plan(2, vocab)["variant"] == (
        "global" if long_row else "shared memory")


def test_paths_are_checked_and_filled_on_the_cpu():
    """``paths=`` must be an (S,) int32 tensor on the logits' device; on
    the CPU the plain version fills in the path the kernel would take."""
    logits, _, gumbel = _case(4)
    lt, gt = torch.from_numpy(logits), torch.from_numpy(gumbel)
    paths = torch.full((S,), -1, dtype=torch.int32)
    fused_sample_logits(lt, gt, 1.0, 10, 0.9, paths=paths)
    assert (paths == sm.PATH_SMALL).all()
    fused_sample_logits(lt, gt, 1.0, None, 0.9, paths=paths)
    assert (paths == sm.PATH_RADIX).all()
    fused_sample_logits(lt, gt, 1.0, None, None, paths=paths)
    assert (paths == sm.PATH_DRAW).all()
    with pytest.raises(ValueError, match="paths must be"):
        fused_sample_logits(lt, gt, 1.0, 10, 0.9,
                            paths=torch.zeros(S, dtype=torch.int64))
