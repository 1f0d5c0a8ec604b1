"""The host side of the port's fused sampler (``bigdl_tpu_torch/ops/
sampling.py``, ``ops/csrc/sampling.cu``):

- ``sample_plan`` mirrors the launch: a cluster of CLUSTER CTAs per row,
  CTA r staging its contiguous share of the row, a split that depends on
  V alone (a row samples alike alone and in a batch), covering the row
  once and in order, and fitting a CTA's shared memory;
- a plain emulation of the kernel's algorithm (the split by
  ``sample_plan``, the order-preserving keys, 4 rounds of 8-bit digits
  with integer counts and fixed-point top-p mass merged in rank order,
  the small kept set gathered to rank 0, the draw merged across ranks)
  returns the tokens of ``fused_sample_logits_ref`` and of the reference's
  Pallas kernel in interpret mode, at the four (top_k, top_p) settings,
  GPT-2's and Llama-3's vocabularies, bfloat16 rows tied at the k-th
  value, rows with NEG_INF entries and ``top_k >= V``. Tokens are equal
  except on a row whose kept-set boundary lies within 1e-6 of its level:
  the emulation's top-p sums are exact integers, the bisection's are
  float32 sums of up to 128,256 terms, which can differ from the exact
  sum by about that much (no seeded row here differs at all).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.sampling import \
    fused_sample_logits as jax_fused_sample_logits
from bigdl_tpu_torch.ops import NEG_INF
from bigdl_tpu_torch.ops import sampling as sm

SETTINGS = [(50, 0.9), (50, None), (None, 0.9), (None, None)]
SET_IDS = ["k50-p0.9", "k50", "p0.9", "none"]


def _keys(l):
    """The kernel's order-preserving uint32 keys of float32 ``l``."""
    u = l.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _value(key):
    u = key & 0x7FFFFFFF if key & 0x80000000 else ~key & 0xFFFFFFFF
    return np.array([u], np.uint32).view(np.float32)[0]


def _mass(l, mx, bits):
    """Fixed-point weights: float32 exp(l - mx) times 2**bits, rounded to
    the nearest integer (ties to even)."""
    e = np.exp((l - np.float32(mx)).astype(np.float32)).astype(np.float32)
    return np.rint(e.astype(np.float64) * 2.0 ** bits).astype(np.uint64)


def _argmax(vals, idx):
    """(value, index) of the largest value, the smallest index on ties."""
    if len(vals) == 0:
        return -np.inf, None
    best = np.max(vals)
    return best, int(np.min(idx[vals == best]))


def _draw(l, g, keep, shares):
    """Each CTA's argmax of l + g over its kept entries, merged in rank
    order (the smaller index on ties)."""
    bv, bi = -np.inf, None
    for lo, hi in shares:
        sel = np.nonzero(keep[lo:hi])[0] + lo
        v, i = _argmax((l[sel] + g[sel]).astype(np.float32), sel)
        if i is not None and (v > bv or (v == bv and i < bi)):
            bv, bi = v, i
    return 0 if bi is None else bi


def _histograms(keys, mask, shift, shares, weights=None):
    """The cluster's merged histogram of digit ``(key >> shift) & 255``
    over the masked entries: counts, and with ``weights`` their uint64
    sums, each CTA's share binned alone and the bins summed in rank
    order."""
    cnt, mass = np.zeros(256, np.int64), [0] * 256
    for lo, hi in shares:
        m = mask[lo:hi]
        d = ((keys[lo:hi][m] >> np.uint32(shift)) & 255).astype(np.int64)
        cnt += np.bincount(d, minlength=256)
        if weights is not None:
            w = np.zeros(256, np.uint64)
            np.add.at(w, d, weights[lo:hi][m])
            mass = [a + int(b) for a, b in zip(mass, w)]
    return cnt, mass


def emulate_row(l, g, top_k, top_p, small_set=sm.SMALL_SET):
    """One row through the kernel's algorithm in plain numpy: ``l`` the
    float32 scaled logits (-0 as +0), ``g`` the float32 noise;
    ``small_set`` 0 keeps every row off the small-set path. Returns
    (token, path)."""
    v = l.shape[0]
    plan = sm.sample_plan(1, v)
    shares, bits = plan["shares"], plan["mass_bits"]
    kon = top_k is not None and 0 < top_k < v
    pon = top_p is not None and top_p < 1.0
    if not kon and not pon:
        return _draw(l, g, np.ones(v, bool), shares), sm.PATH_DRAW
    keys = _keys(l)
    real = l > np.float32(0.5 * NEG_INF)
    mx = max(l[lo:hi].max() for lo, hi in shares if hi > lo)
    n_real = sum(int(real[lo:hi].sum()) for lo, hi in shares)
    if n_real == 0:
        return 0, sm.PATH_RADIX
    ck = -np.inf
    p32 = float(np.float32(top_p)) if pon else None
    if kon:
        krem, prefix, gt, gather = min(top_k, n_real), 0, 0, None
        for r in range(4):
            shift = 24 - 8 * r
            mask = real.copy()
            if r:
                mask &= (keys >> np.uint32(shift + 8)) == (prefix >> (shift + 8))
            cnt, _ = _histograms(keys, mask, shift, shares)
            suffix = np.cumsum(cnt[::-1])[::-1]          # count(bins >= d)
            d = int(np.nonzero(suffix >= krem)[0].max())
            above = int(suffix[d] - cnt[d])
            krem, gt, eq = krem - above, gt + above, int(cnt[d])
            prefix |= d << shift
            limit = min(sm.EARLY_SET, small_set) if r < 3 else small_set
            if gt + eq <= limit:
                gather = shift
                break
        if gather is not None:
            # the small set: rank 0 finishes both cuts by counting, over
            # the real entries at or above the bucket
            cand = np.nonzero(real & ((keys >> np.uint32(gather))
                                      >= (prefix >> gather)))[0]
            lc = l[cand]
            keep = np.array([(lc > x).sum() for x in lc]) < top_k
            if pon:
                e = _mass(lc, mx, bits)
                z = sum(int(x) for x, k in zip(e, keep) if k)
                t = math.ceil(max(float(z) * p32, 0.0))
                mgt = np.array([sum(int(x) for x in e[lc > y]) for y in lc],
                               dtype=object)
                keep &= mgt < t
            full = np.zeros(v, bool)
            full[cand[keep]] = True
            # rank 0 draws over the gathered set: one argmax, no rank order
            tok = _draw(l, g, full, [(0, v)]) if full.any() else 0
            return tok, sm.PATH_SMALL
        ck = _value(prefix)
    cut = ck
    if pon:
        weights = _mass(l, mx, bits)
        a, prefix, t = 0, 0, None
        for r in range(4):
            shift = 24 - 8 * r
            mask = real & (l >= ck)
            if r:
                mask &= (keys >> np.uint32(shift + 8)) == (prefix >> (shift + 8))
            cnt, mass = _histograms(keys, mask, shift, shares, weights)
            if r == 0:
                t = math.ceil(max(float(sum(mass)) * p32, 0.0))
            best, above = None, 0
            for d in range(255, -1, -1):
                run = a + sum(mass[d + 1:])
                if cnt[d] > 0 and run < t:
                    best, above = d, run
            if best is None:
                return 0, sm.PATH_RADIX
            a, prefix = above, prefix | best << shift
        cut = _value(prefix)
    return _draw(l, g, l >= cut, shares), sm.PATH_RADIX


def emulate(logits, gumbel, temps, top_k, top_p, small_set=sm.SMALL_SET):
    """(tokens, paths) of the kernel's algorithm on torch (S, V) logits and
    noise and (S,) temperatures."""
    l = (logits.float() / sm._row_temps(temps, logits)[:, None].clamp_min(
        1e-6)).numpy()
    l = np.where(l == 0, np.float32(0), l).astype(np.float32)
    g = gumbel.float().numpy()
    out = [emulate_row(l[r], g[r], top_k, top_p, small_set)
           for r in range(l.shape[0])]
    return (np.array([t for t, _ in out], np.int32),
            np.array([p for _, p in out], np.int32))


def near_boundary(logits, temps, top_k, top_p, eps=1e-6):
    """Per row: does the kept set's boundary lie within ``eps`` of its
    level? Top-k: the k-th and (k+1)-th scaled logits nearly tie without
    being equal; top-p: a cumulative softmax mass (after top-k) lies within
    ``eps`` of p."""
    l = logits.float() / sm._row_temps(temps, logits)[:, None].clamp_min(
        1e-6)
    srt = torch.sort(l, dim=-1, descending=True).values
    near = torch.zeros(l.shape[0], dtype=torch.bool)
    kept = srt
    if top_k is not None and 0 < top_k < l.shape[1]:
        gap = srt[:, top_k - 1] - srt[:, top_k]
        near |= (gap > 0) & (gap < eps)
        kept = srt[:, :top_k]
    if top_p is not None and top_p < 1.0:
        cum = torch.cumsum(torch.softmax(kept, dim=-1), dim=-1)
        near |= ((cum - top_p).abs() < eps).any(dim=-1)
    return near.numpy()


def _rows(seed, s, v, dtype, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "ties":     # bfloat16 of a narrow range: many equal values
        x = rng.uniform(2.0, 2.25, (s, v)).astype(np.float32)
    else:
        x = 3.0 * rng.standard_normal((s, v), dtype=np.float32)
    if kind == "neg_inf":  # masked entries, and a row with one real entry
        x[0, rng.integers(0, v, v // 3)] = NEG_INF
        x[1, :] = NEG_INF
        x[1, v // 2] = 1.0
    temps = np.array([0.7, 1.0, 1.3, 0.5][:s], np.float32)
    key = jax.random.PRNGKey(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    gumbel = jax.random.gumbel(key, (s, v), jdt)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(tdt),
            torch.from_numpy(np.array(gumbel.astype(jnp.float32))).to(tdt),
            torch.from_numpy(temps), key)


def _check(logits, gumbel, temps, top_k, top_p, key=None):
    """The emulation against the plain version (and, with ``key``, the
    Pallas kernel in interpret mode, which draws the same noise from it):
    tokens equal on every row away from a kept-set boundary, paths equal
    to the ones the plain version names. Returns the near rows."""
    got, paths = emulate(logits, gumbel, temps, top_k, top_p)
    want_paths = torch.zeros(logits.shape[0], dtype=torch.int32)
    want = sm.fused_sample_logits_ref(logits, gumbel, temps, top_k, top_p,
                                      want_paths).numpy()
    np.testing.assert_array_equal(paths, want_paths.numpy())
    near = near_boundary(logits, temps, top_k, top_p)
    np.testing.assert_array_equal(got[~near], want[~near])
    if key is not None:
        jl = jnp.asarray(logits.float().numpy()).astype(
            jnp.bfloat16 if logits.dtype == torch.bfloat16 else jnp.float32)
        pallas = np.asarray(jax_fused_sample_logits(
            jl, key, jnp.asarray(temps.numpy())[:, None], top_k, top_p,
            interpret=True))
        np.testing.assert_array_equal(got[~near], pallas[~near])
    return near


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [50257, 128256])
@pytest.mark.parametrize("top_k,top_p", SETTINGS, ids=SET_IDS)
def test_emulation_matches_plain_and_pallas(top_k, top_p, v, dtype):
    logits, gumbel, temps, key = _rows(v % 97 + len(dtype), 2, v, dtype)
    near = _check(logits, gumbel, temps, top_k, top_p, key)
    assert not near.all()


@pytest.mark.parametrize("top_k,top_p", SETTINGS[:2] + [(2000, 0.9)],
                         ids=["k50-p0.9", "k50", "k2000-p0.9"])
def test_emulation_with_ties_at_the_kth_value(top_k, top_p):
    """bfloat16 rows drawn from a narrow range: the k-th value is tied many
    times over, and both cuts keep every tie (top-k 2000 keeps more than
    SMALL_SET: the cluster's top-p rounds)."""
    logits, gumbel, temps, key = _rows(5, 3, 50257, "bfloat16", "ties")
    l = logits.float() / temps[:, None]
    kth = torch.sort(l, dim=-1, descending=True).values[:, top_k - 1]
    ties = ((l == kth[:, None]).sum(dim=-1)).min()
    assert ties > 10
    _check(logits, gumbel, temps, top_k, top_p, key)
    _, paths = emulate(logits, gumbel, temps, top_k, top_p)
    n_kept = int((l >= kth[:, None]).sum(dim=-1).min())
    assert (paths == (sm.PATH_SMALL if n_kept <= sm.SMALL_SET
                      else sm.PATH_RADIX)).all()


@pytest.mark.parametrize("top_k,top_p", SETTINGS, ids=SET_IDS)
def test_emulation_with_neg_inf_entries(top_k, top_p):
    """A third of a row's logits at NEG_INF, and a row with one real
    entry: the cuts count real entries only, as the bisection does."""
    logits, gumbel, temps, key = _rows(9, 2, 4099, "float32", "neg_inf")
    _check(logits, gumbel, temps, top_k, top_p, key)


def test_emulation_with_no_real_entry_draws_token_zero():
    logits = torch.full((2, 300), NEG_INF)
    gumbel = torch.from_numpy(
        np.random.default_rng(0).gumbel(size=(2, 300)).astype(np.float32))
    for top_k, top_p in SETTINGS[:3]:
        got, paths = emulate(logits, gumbel, torch.ones(2), top_k, top_p)
        want = sm.fused_sample_logits_ref(logits, gumbel, 1.0, top_k, top_p)
        np.testing.assert_array_equal(got, want.numpy())
        assert (got == 0).all() and (paths == sm.PATH_RADIX).all()


@pytest.mark.parametrize("top_k", [1000, 1001, 5000])
def test_emulation_with_top_k_at_or_above_vocab(top_k):
    """top_k >= V disables top-k: the plain version's no-cut draw."""
    logits, gumbel, temps, _ = _rows(3, 2, 1000, "float32")
    got, paths = emulate(logits, gumbel, temps, top_k, None)
    want = sm.fused_sample_logits_ref(logits, gumbel, temps, None, None)
    np.testing.assert_array_equal(got, want.numpy())
    assert (paths == sm.PATH_DRAW).all()


@pytest.mark.parametrize("top_p", [0.9, None], ids=["p0.9", "k-only"])
def test_small_set_and_cluster_paths_agree(top_p):
    """The small kept set (rank 0 alone) and the cluster's top-p rounds
    use the same fixed-point weights and threshold: forced onto the
    cluster path, every row draws the same token."""
    logits, gumbel, temps, _ = _rows(13, 4, 50257, "float32")
    small, p_small = emulate(logits, gumbel, temps, 50, top_p)
    wide, p_wide = emulate(logits, gumbel, temps, 50, top_p, small_set=0)
    assert (p_small == sm.PATH_SMALL).all()
    assert (p_wide == sm.PATH_RADIX).all()
    np.testing.assert_array_equal(small, wide)


def test_a_row_samples_alike_alone_and_in_a_batch():
    logits, gumbel, temps, _ = _rows(17, 4, 50257, "bfloat16")
    batch, _ = emulate(logits, gumbel, temps, 50, 0.9)
    for r in range(4):
        alone, _ = emulate(logits[r:r + 1], gumbel[r:r + 1], temps[r:r + 1],
                           50, 0.9)
        assert alone[0] == batch[r]


@pytest.mark.parametrize("v", [1, 7, 8, 97, 50257, 128256, sm.MAX_VOCAB,
                               sm.MAX_VOCAB + 1, 600000])
def test_sample_plan_shares(v):
    """Shares of V alone (the same at every S), covering the row once and
    in order; the staged share fits a CTA's shared memory, and rows past
    MAX_VOCAB take the global variant."""
    plans = [sm.sample_plan(s, v) for s in (1, 2, 8, 64)]
    assert all(p["shares"] == plans[0]["shares"] for p in plans)
    assert [p["grid"] for p in plans] == [8, 16, 64, 512]
    shares = plans[0]["shares"]
    assert len(shares) == sm.CLUSTER == 8
    assert [i for lo, hi in shares for i in range(lo, hi)] == list(range(v))
    assert max(hi - lo for lo, hi in shares) == -(-v // 8)
    p = plans[0]
    assert p["threads"] == 1024 and p["small_set"] == 512
    assert p["smem_bytes"] <= sm.MAX_SMEM == 232448
    if v <= sm.MAX_VOCAB:
        assert p["variant"] == "shared memory"
        assert p["smem_bytes"] == sm.FIXED_SMEM + 4 * -(-v // 8)
    else:
        assert p["variant"] == "global" and p["smem_bytes"] == sm.FIXED_SMEM
    # the fixed-point weights of a whole row fit 63 bits
    assert v * 2 ** p["mass_bits"] < 2 ** 63 and p["mass_bits"] <= 40


def test_limits():
    """Llama-3's 128,256 logits now live in the cluster's shared memory."""
    assert sm.MAX_VOCAB == 8 * ((232448 - 18432) // 4) == 428032
    assert sm.sample_plan(8, 128256)["variant"] == "shared memory"
    assert sm.sample_plan(8, 128256)["mass_bits"] == 40


def test_bytes_and_flops_count_the_function():
    """The least work: the logits once, the kept set's noise, temperatures
    and tokens; a constant few operations an element, whatever a cut's
    algorithm."""
    x = torch.zeros(8, 50257)
    n = x.numel()
    assert sm.bytes_and_flops(x) == (8 * n + 64, n + 2 * n)
    assert sm.bytes_and_flops(x, 50, 0.9, kept=400) == (
        4 * n + 4 * 400 + 64, 3 * n + 800)
    assert sm.bytes_and_flops(x.bfloat16(), 50, None, kept=400) == (
        2 * n + 2 * 400 + 64, n + 800)
    nbytes, _ = sm.bytes_and_flops(x, 50, 0.9, kept=400)
    assert nbytes / 3.35e12 * 1e3 < 0.0005      # the 0.00048 ms floor
