"""The port's tensor-parallel layout (``bigdl_tpu_torch/parallel/
layout.py``) against the JAX reference's (``bigdl_tpu/parallel/
layout.py``), on the CPU.

Every parameter's split dimension must be the one the reference's
``GPTForCausalLM.partition_specs`` gives it over the ``tp`` axis, mapped
through ``_jax_path`` (``convert``'s name table: a transposed Linear
weight splits the other dimension), float and int8. ``fit``'s replicate
fallback, ``validate_heads`` and ``serving_mesh`` behave as the
reference's; state dicts split and re-join exactly; the collectives give every shard the same bits.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.nn.quantized import quantize_params
from bigdl_tpu.parallel.layout import ModelLayout as JaxLayout
from bigdl_tpu.parallel.layout import SpecLayout as JaxSpec
from bigdl_tpu.parallel.layout import serving_mesh as jax_serving_mesh
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM, partition_specs
from bigdl_tpu_torch.parallel.layout import (ModelLayout, SpecLayout,
                                             all_reduce_sum, broadcast,
                                             gather, reduce_sum,
                                             serving_mesh)

CFG = dict(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)


@pytest.fixture(scope="module")
def tree():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    return jm, params


def _leaf(t, path):
    for k in path:
        t = t[k]
    return t


_LINEARS = ("wq", "wk", "wv", "wo", "fc1", "fc2")


def _jax_path(name, int8=False):
    """``(path, transposed)``: the key path of the port's GPT parameter
    ``name`` in the reference's params tree (the mapping of
    ``convert.params_from_jax``), and whether the leaf is the transpose of
    the port's tensor (Linear weights). ``int8``: a quantized model's
    names, whose Linear weights are ``{"q", "scale"}`` leaves."""
    path = ["gpt"] + [int(p) if p.isdigit() else p
                      for p in name.split(".")[1:]]
    leaf = path[-1]
    if len(path) < 3 or path[-2] not in _LINEARS or leaf == "bias":
        return tuple(path), False
    if path[-2] in ("fc1", "fc2"):
        path[-1] = "weight"                   # fc's weight (or its scale)
    else:
        path.pop()                            # attention weights are bare
    if leaf == "scale":
        path.append("scale")
    elif int8:
        path.append("q")
    return tuple(path), leaf == "weight"


def _tp_dim(spec, ndim):
    """The dimension a reference PartitionSpec puts the ``tp`` axis on."""
    for i, entry in enumerate(tuple(spec)[:ndim]):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "tp" in axes:
            return i
    return None


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_roles_match_reference_partition_specs(tree, int8):
    jm, params = tree
    if int8:
        params = quantize_params(params)
    jspecs = jm.partition_specs(params, JaxSpec())
    sd = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    dims = partition_specs(sd)
    assert set(dims) == set(sd)
    for name, t in sd.items():
        path, transposed = _jax_path(name, int8=int8)
        spec = _leaf(jspecs, path)
        assert isinstance(spec, PartitionSpec), name
        want = _tp_dim(spec, t.dim())
        if want is not None and transposed:
            want = t.dim() - 1 - want
        assert dims[name] == want, (name, spec)


def test_spec_table_names_pool_axes():
    spec = SpecLayout()
    jspec = JaxSpec()
    assert spec.kv_pool() == _tp_dim(jspec.kv_pool(), 4) == 1
    assert spec.kv_pool_scale() == _tp_dim(jspec.kv_pool_scale(), 3) == 1


@pytest.mark.parametrize("vocab,want", [(64, 0), (61, None)])
def test_fit_replicate_fallback_matches_reference(multi_device_cpu, vocab,
                                                  want):
    lay = ModelLayout(["cpu", "cpu"])
    assert lay.fit(SpecLayout().embeddings(), (vocab, 32)) == want
    jlay = JaxLayout(jax_serving_mesh(2))
    jfit = jlay.fit(JaxSpec().embeddings(), (vocab, 32))
    assert _tp_dim(jfit, 2) == want


def test_fit_splits_only_divisible_split_roles():
    lay = ModelLayout(["cpu", "cpu"])
    assert lay.fit(SpecLayout().kv_pool(), (8, 4, 16, 8)) == 1
    assert lay.fit(SpecLayout().kv_pool_scale(), (8, 4, 16)) == 1
    assert lay.fit(SpecLayout().attention_output(), (32, 64)) == 1
    assert lay.fit(SpecLayout().kv_pool(), (8, 3, 16, 8)) is None
    # tp 1 and replicated roles never split
    assert ModelLayout(["cpu"]).fit(0, (64, 32)) is None
    assert lay.fit(None, (64, 32)) is None


def test_validate_heads():
    lay = ModelLayout(["cpu", "cpu"])
    lay.validate_heads(4)
    with pytest.raises(ValueError, match="divisible"):
        lay.validate_heads(3)
    assert lay.describe() == {"tp_degree": 2, "distinct_devices": 1,
                              "shard_devices": ["cpu", "cpu"]}


def test_serving_mesh_blocks_and_errors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert serving_mesh(2) == [torch.device("cuda", 0),
                               torch.device("cuda", 1)]
    assert len(serving_mesh(8)) == 8
    with pytest.raises(ValueError, match="mesh="):
        serving_mesh(16)
    with pytest.raises(ValueError, match=">= 1"):
        serving_mesh(0)


def test_serving_mesh_without_cards_names_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="mesh="):
        serving_mesh(2)
    with pytest.raises(ValueError, match="only 0 are visible"):
        serving_mesh(1)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_state_dict_split_and_join_round_trip(tree, tp):
    _, params = tree
    lay = ModelLayout(["cpu"] * tp)
    t = jax.tree_util.tree_map(np.asarray, params)
    sd = convert.params_from_jax(t)
    dims = lay.split_dims(sd)
    shards = lay.shard_state_dict(sd)
    assert len(shards) == tp
    for name, full in sd.items():
        for part in (s[name] for s in shards):
            want = list(full.shape)
            if dims[name] is not None:
                want[dims[name]] //= tp
            assert list(part.shape) == want and part.is_contiguous()
            assert part.untyped_storage().data_ptr() != \
                full.untyped_storage().data_ptr()
    back = {name: (shards[0][name] if dims[name] is None
                   else gather([s[name] for s in shards], dims[name]))
            for name in shards[0]}
    assert back.keys() == sd.keys()
    for name in sd:
        assert torch.equal(back[name], sd[name]), name
    # and back into the reference's layout
    rt = convert.params_to_jax(back)
    for a, b in zip(jax.tree_util.tree_leaves(rt),
                    jax.tree_util.tree_leaves(t)):
        np.testing.assert_array_equal(a, b)


def test_gpt2_vocab_replicates_and_heads_split():
    m = GPTForCausalLM(vocab_size=50257, hidden_size=64, n_layers=1,
                       n_heads=4, max_position=16, device="cpu")
    for tp in (2, 4):
        dims = ModelLayout(["cpu"] * tp).split_dims(m.state_dict())
        assert dims["gpt.tok_emb"] is None
        assert dims["gpt.layers.0.attn.wq.weight"] == 0
        assert dims["gpt.layers.0.attn.wo.weight"] == 1
        assert dims["gpt.layers.0.fc1.bias"] == 0
        assert dims["gpt.layers.0.fc2.bias"] is None


def test_collectives_give_every_shard_the_same_bits():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((3, 5), dtype=np.float32))
             for _ in range(4)]
    out = all_reduce_sum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]   # shard order
    assert len(out) == 4
    for o in out:
        assert torch.equal(o, want)
    assert torch.equal(reduce_sum(parts), want)
    assert torch.equal(gather(parts, -1), torch.cat(parts, -1))
    copies = broadcast(parts[0], ["cpu", "cpu"])
    assert copies[0] is parts[0] and copies[1] is parts[0]
