"""The host side of the port's flash kernels
(``bigdl_tpu_torch/ops/flash_attention.py``): the plain versions the card
holds them against, at every width the kernels are built for (64, 128
and 256), against the reference's Pallas kernels; the zero padding that
runs any head size up to 256 on the next built width; the plans the
tensor-core and CUDA-core C entries make; the path each (type, head size,
kernel) takes, the entry it reaches and the counter it moves.

The reference runs in Pallas interpret mode with ``block_q = block_k =
32`` on (1, 2, 128, D). Tolerances: float32 the reference's own (O and
lse at rtol 2e-4, atol 2e-5; gradients at rtol 1e-3, atol 1e-4);
bfloat16 the card's bar, atol = rtol = 2e-2, because the two sides round
``p`` to bfloat16 at different running maxima. The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash_with_lse
from bigdl_tpu_torch.ops import flash_attention as fa

TOL = {"float32": ({"rtol": 2e-4, "atol": 2e-5},
                   {"rtol": 1e-3, "atol": 1e-4}),
       "bfloat16": ({"rtol": 2e-2, "atol": 2e-2},
                    {"rtol": 2e-2, "atol": 2e-2})}


def _inputs(d, seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = [rs.randn(1, 2, 128, d).astype(np.float32)
                   for _ in range(4)]
    return q, k, v, do, rs.randn(1, 2, 128).astype(np.float32)


@pytest.mark.parametrize("with_dlse", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_plain_versions_match_pallas_kernels(d, dtype, causal, with_dlse):
    """O, lse, dQ, dK and dV of the plain versions against the reference's
    forward and its custom VJP (cotangents dO and, with ``with_dlse``,
    dlse), on the same values in the same type."""
    q, k, v, do, dlse = _inputs(d, seed=d + causal)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    (o, lse), vjp = jax.vjp(
        lambda q, k, v: jax_flash_with_lse(q, k, v, causal=causal,
                                           block_q=32, block_k=32),
        jq, jk, jv)
    jdlse = jnp.asarray(dlse if with_dlse else np.zeros_like(dlse))
    want = [o, lse, *vjp((jdo, jdlse))]
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tdlse = torch.from_numpy(dlse) if with_dlse else None
    got_o, got_lse = fa.flash_fwd_ref(tq, tk, tv, causal)
    delta = (tdo.float() * got_o.float()).sum(-1)
    args = (tq, tk, tv, tdo, got_lse, delta, tdlse, causal)
    got_dq = fa.flash_bwd_dq_ref(*args)
    got_dk, got_dv = fa.flash_bwd_dkv_ref(*args)
    fwd_tol, grad_tol = TOL[dtype]
    for i, (got, w) in enumerate(zip(
            (got_o, got_lse, got_dq, got_dk, got_dv), want)):
        assert got.dtype == (torch.float32 if i == 1 else tdt)
        np.testing.assert_allclose(got.float().numpy(), w,
                                   **(fwd_tol if i < 2 else grad_tol))


def _padded_plain(kernel, args, width, sm_scale):
    """A plain version run as the card branch runs its kernel: q, k, v
    (and dO) zero-padded to ``width`` with the true ``sm_scale``, the
    outputs sliced back to the true head size."""
    q, k, v, do, lse, delta, dlse, causal = args
    d = q.shape[-1]
    q, k, v, do = fa._padded(width, q, k, v, do)
    if kernel == "fwd":
        o, lse = fa.flash_fwd_ref(q, k, v, causal, sm_scale)
        return o[..., :d], lse
    fn = fa.flash_bwd_dq_ref if kernel == "dq" else fa.flash_bwd_dkv_ref
    out = fn(q, k, v, do, lse, delta, dlse, causal, sm_scale)
    return (out[..., :d],) if kernel == "dq" else tuple(
        x[..., :d] for x in out)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 80, 160])
def test_padding_is_exact(d, dtype, causal):
    """Each plain version run zero-padded to its kernel's width (64 for D
    32, 128 for D 80, 256 for D 160) with the true ``sm_scale`` and sliced
    back equals the unpadded plain version: the zero columns add exact
    zeros to every product. float32 to 1e-6 (the same sums in another
    order), bfloat16 to one rounding of the outputs (atol = rtol =
    8e-3)."""
    width = fa.kernel_head_dim(d)
    assert width == {32: 64, 80: 128, 160: 256}[d]
    q, k, v, do, dlse = _inputs(d, seed=d + causal)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    scale = d ** -0.5
    o, lse = fa.flash_fwd_ref(tq, tk, tv, causal)
    delta = (tdo.float() * o.float()).sum(-1)
    args = (tq, tk, tv, tdo, lse, delta, torch.from_numpy(dlse), causal)
    want = {"fwd": (o, lse), "dq": (fa.flash_bwd_dq_ref(*args),),
            "dkv": fa.flash_bwd_dkv_ref(*args)}
    tol = ({"rtol": 1e-6, "atol": 1e-6} if dtype == "float32"
           else {"rtol": 8e-3, "atol": 8e-3})
    for kernel, outs in want.items():
        got = _padded_plain(kernel, args, width, scale)
        for g, w in zip(got, outs):
            assert g.shape == w.shape and g.dtype == w.dtype
            torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 80, 160])
def test_padded_plain_versions_match_pallas_kernels(d, dtype, causal):
    """The padded plain versions (what the card branch computes at D 32,
    80 and 160) against the reference's Pallas kernels at the true D, in
    interpret mode, at the reference's own tolerances."""
    q, k, v, do, dlse = _inputs(d, seed=d + causal)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    (o, lse), vjp = jax.vjp(
        lambda q, k, v: jax_flash_with_lse(q, k, v, causal=causal,
                                           block_q=32, block_k=32),
        jq, jk, jv)
    want = [o, lse, *vjp((jdo, jnp.asarray(dlse)))]
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    width, scale = fa.kernel_head_dim(d), d ** -0.5
    got_o, got_lse = _padded_plain(
        "fwd", (tq, tk, tv, tdo, None, None, None, causal), width, scale)
    delta = (tdo.float() * got_o.float()).sum(-1)
    args = (tq, tk, tv, tdo, got_lse, delta, torch.from_numpy(dlse), causal)
    got = [got_o, got_lse, *_padded_plain("dq", args, width, scale),
           *_padded_plain("dkv", args, width, scale)]
    fwd_tol, grad_tol = TOL[dtype]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.float().numpy(), w,
                                   **(fwd_tol if i < 2 else grad_tol))


# (kernel, B*H, S, D) -> tile_q, tile_k, grid, shared-memory bytes
TC_PLANS = [
    # the training path's shape, and D = 128
    (("fwd", 96, 1024, 64), 128, 128, (96, 8),
     1024 + 128 * 64 * 2 + 2 * 2 * 128 * 64 * 2),
    (("fwd", 96, 1024, 128), 128, 64, (96, 8),
     1024 + 128 * 128 * 2 + 2 * 2 * 64 * 128 * 2),
    (("dkv", 96, 1024, 64), 64, 128, (96, 8),
     1024 + 2 * 128 * 64 * 2 + 2 * (2 * 64 * 64 * 2 + 3 * 64 * 4)),
    (("dkv", 96, 1024, 128), 64, 128, (96, 8),
     1024 + 2 * 128 * 128 * 2 + 2 * (2 * 64 * 128 * 2 + 3 * 64 * 4)),
    (("dq", 96, 1024, 64), 128, 128, (96, 8),
     1024 + 2 * 128 * 64 * 2 + 2 * 2 * 128 * 64 * 2),
    (("dq", 96, 1024, 128), 128, 64, (96, 8),
     1024 + 2 * 128 * 128 * 2 + 2 * 2 * 64 * 128 * 2),
    # ragged: S = 1000 (a partial last tile), and tiny sequences
    (("fwd", 96, 1000, 64), 128, 128, (96, 8), 82944),
    (("dkv", 96, 1000, 64), 64, 128, (96, 8), 68096),
    (("fwd", 1, 1, 128), 128, 64, (1, 1), 99328),
    (("dkv", 2, 130, 128), 64, 128, (2, 2), 133632),
    (("dq", 96, 1000, 64), 128, 128, (96, 8), 99328),
    (("dq", 96, 1000, 128), 128, 64, (96, 8), 132096),
    (("dq", 1, 1, 128), 128, 64, (1, 1), 132096),
    (("dq", 2, 130, 64), 128, 128, (2, 2), 99328),
    # head sizes below a built width run on it: the plan is that width's
    (("fwd", 96, 1024, 32), 128, 128, (96, 8),
     1024 + 128 * 64 * 2 + 2 * 2 * 128 * 64 * 2),
    (("dq", 96, 1024, 80), 128, 64, (96, 8),
     1024 + 2 * 128 * 128 * 2 + 2 * 2 * 64 * 128 * 2),
    (("dkv", 96, 1024, 96), 64, 128, (96, 8),
     1024 + 2 * 128 * 128 * 2 + 2 * (2 * 64 * 128 * 2 + 3 * 64 * 4)),
]


@pytest.mark.parametrize("args,tile_q,tile_k,grid,smem", TC_PLANS,
                         ids=[str(p[0]) for p in TC_PLANS])
def test_tensor_core_plan(args, tile_q, tile_k, grid, smem):
    """Every host-side quantity of a tensor-core launch: 256 threads (two
    warpgroups of 64 rows), a two-stage ring, the forward's 128 query rows
    a CTA with key tiles of 128 (D 64) or 64 (D 128), dQ's the same with
    Q and dO resident, dK/dV's 128 keys a CTA with query tiles of 64, and
    the dynamic shared memory (alignment slack, the resident tiles, the
    ring's tiles, dK/dV's staged rows), under the 232,448 bytes a CTA may
    use; ``head_dim`` is the launched width (64 up to D 64, else 128)."""
    plan = fa.tc_plan(*args)
    width = 64 if args[3] <= 64 else 128
    assert plan == {"tile_q": tile_q, "tile_k": tile_k, "grid": grid,
                    "threads": 256, "stages": 2, "smem_bytes": smem,
                    "head_dim": width}
    assert smem <= fa.TC_MAX_SMEM == 232448


def test_tensor_core_plan_refuses_what_has_no_tensor_core_kernel():
    """Above 128 the bfloat16 kernels run on the CUDA cores: no
    tensor-core plan."""
    with pytest.raises(ValueError, match="head_dim 160 above 128"):
        fa.tc_plan("fwd", 1, 64, 160)
    with pytest.raises(ValueError, match="head_dim 256 above 128"):
        fa.tc_plan("dq", 1, 64, 256)
    with pytest.raises(ValueError, match="head_dim 300 above 128"):
        fa.tc_plan("dkv", 1, 64, 300)
    with pytest.raises(ValueError, match="'bwd'"):
        fa.tc_plan("bwd", 1, 64, 64)


TC, CC = "tensor_cores", "cuda_cores"


@pytest.mark.parametrize("fn,dtype,d,want", [
    ("flash_fwd", torch.bfloat16, 64, TC),
    ("flash_fwd", torch.bfloat16, 128, TC),
    ("flash_bwd_dkv", torch.bfloat16, 64, TC),
    ("flash_bwd_dkv", torch.bfloat16, 128, TC),
    ("flash_bwd_dq", torch.bfloat16, 64, TC),
    ("flash_bwd_dq", torch.bfloat16, 128, TC),
    ("flash_fwd", torch.float32, 64, CC),           # float32: CUDA cores
    ("flash_bwd_dkv", torch.float32, 64, CC),
    ("flash_bwd_dq", torch.float32, 64, CC),
    ("flash_fwd", torch.float32, 128, CC),
    ("flash_bwd_dkv", torch.float32, 128, CC),
    ("flash_bwd_dq", torch.float32, 128, CC),
    ("flash_fwd", torch.bfloat16, 32, TC),          # padded to 64
    ("flash_bwd_dq", torch.float32, 96, CC),        # padded to 128
    ("flash_bwd_dkv", torch.bfloat16, 80, TC),
    ("flash_fwd", torch.float32, 1, CC),
    ("flash_bwd_dq", torch.bfloat16, 160, CC),      # above 128: CUDA cores
    ("flash_fwd", torch.float32, 256, CC),
    ("flash_bwd_dkv", torch.bfloat16, 256, CC),
    ("flash_fwd", torch.bfloat16, 257, None),       # above 256
    ("flash_fwd", torch.float16, 64, None),
    ("flash_bwd", torch.bfloat16, 64, None),        # no such wrapper
])
def test_tensor_core_eligibility(fn, dtype, d, want):
    """``path``: the tensor cores for bfloat16 up to D 128 and the CUDA
    cores for float32 and for bfloat16 above 128, every wrapper at any D
    up to 256 (on the width ``kernel_head_dim`` names); no kernel for the
    rest."""
    assert fa.path(fn, dtype, d) == want
    if want is not None:
        assert fa.kernel_head_dim(d) == (64 if d <= 64 else
                                         128 if d <= 128 else 256)


class _FakeLib:
    """Records the C entry called and its arguments; launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _on_card(kernel, q):
    """Run the card branch of ``kernel``'s wrapper on CPU tensors shaped
    like ``q``."""
    rows = torch.zeros(q.shape[:-1])
    if kernel == "fwd":
        return fa._fwd_on_card(q, q, q, True, 0.125)
    on_card = fa._dq_on_card if kernel == "dq" else fa._dkv_on_card
    return on_card(q, q, q, q, rows, rows, rows, True, 0.125)


WRAPPERS = {"fwd": fa.flash_fwd, "dq": fa.flash_bwd_dq,
            "dkv": fa.flash_bwd_dkv}
ENTRIES = {"fwd": "bigdl_flash_fwd", "dq": "bigdl_flash_bwd_dq",
           "dkv": "bigdl_flash_bwd_dkv"}
POINTERS = {"fwd": 5, "dq": 8, "dkv": 9}


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 80),
                                     (torch.bfloat16, 160),
                                     (torch.float32, 256)])
def test_launch_takes_one_path_and_moves_its_counter(monkeypatch, kernel,
                                                     dtype, d):
    """The wrappers' card branch: the C entry each (type, head size,
    kernel) reaches, with its arguments (the launched head size is the
    padded width; the outputs come back at the true one), and the counter
    it moves (``tc_launches`` for the tensor-core kernels in bfloat16 up to
    D 128, ``launches`` for the CUDA-core kernels in float32 and in
    bfloat16 above 128). The library, the card and the device checks are
    faked; the head-size check is the wrappers' own."""
    lib = _FakeLib()
    monkeypatch.setattr(fa, "_check_cuda_args",
                        lambda fn, q, planes, rows: fa._check_head_dim(fn,
                                                                       q))
    monkeypatch.setattr(fa._build, "load", lambda name, declare: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    fn = WRAPPERS[kernel]
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "tc_launches", 0)
    q = torch.zeros(2, 3, 40, d, dtype=dtype)
    tc = dtype == torch.bfloat16 and d <= 128
    outs = _on_card(kernel, q)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert outs[0].shape == q.shape and outs[0].is_contiguous()
    [(name, args)] = lib.calls
    assert name == ENTRIES[kernel] + ("_tc" if tc else "")
    n = POINTERS[kernel]
    width = fa.kernel_head_dim(d)
    assert args[n:n + 5] == (6, 40, width, 0.125, 1) and args[-1] == 7
    if tc:
        assert len(args) == n + 6
        assert (fn.tc_launches, fn.launches) == (1, 0)
    else:
        assert args[n + 5] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
        assert (fn.tc_launches, fn.launches) == (0, 1)


WRAPPER_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", WRAPPER_NAMES)
def test_every_wrapper_takes_head_dim_128_in_both_types(fn, dtype):
    """``_check_cuda_args`` takes D = 128 for every wrapper in both types
    and goes on to the device check, which refuses these CPU tensors."""
    q = torch.zeros(1, 2, 8, 128, dtype=dtype)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fa._check_cuda_args(fn, q, {}, {})


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", WRAPPER_NAMES)
def test_head_dims_below_128_pass_on_to_the_device_check(fn, dtype, d):
    """``_check_cuda_args`` takes a head size that runs zero-padded on a
    built width (32 on 64, 96 on 128) and goes on to the device check,
    which refuses these CPU tensors."""
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fa._check_cuda_args(fn, q, {}, {})


@pytest.mark.parametrize("d", [257, 320])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", WRAPPER_NAMES)
def test_other_head_dims_raise_naming_queue_c(fn, dtype, d):
    """``_check_cuda_args`` refuses a head size above 256, naming the
    ROADMAP queue C item that keeps it open, before it looks at the
    device."""
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    with pytest.raises(ValueError, match=r"queue C, 'flash and paged head "
                                         r"dims above 256'"):
        fa._check_cuda_args(fn, q, {}, {})


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", WRAPPER_NAMES)
def test_head_dims_up_to_256_pass_on_to_the_device_check(fn, dtype, d):
    """``_check_cuda_args`` takes a head size in (128, 256] (the CUDA-core
    kernels at 256, 160 zero-padded) in both types and goes on to the
    device check, which refuses these CPU tensors."""
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fa._check_cuda_args(fn, q, {}, {})
