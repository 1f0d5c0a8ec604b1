"""The port's sharded checkpoints and ``allreduce_bandwidth``
(``bigdl_tpu_torch/parallel/distri_optimizer.py`` under
``BIGDL_TPU_SHARDED_CHECKPOINT``, ``parallel/allreduce.py``) against the
JAX reference's on the CPU.

The reference runs on the 8-device virtual CPU mesh of
``tests/conftest.py``, the port on ``mesh=["cpu"] * 8``, both from the
reference's seeded weights of a model with BN buffers, on a
``DistributedDataSet`` (the same batches in both). Bars: what one package
writes, the other reads exactly (the float32 master blocks, the
optimizer slots under the reference's ``keystr`` paths, the scalars, the
buffers); a sharded retry's losses within 1e-4 relative of the
reference's sharded retry and its weights within 1e-4 absolute (the bar
of ``tests/test_torch_distri_optimizer.py``); block round trips exact.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from jax.tree_util import keystr, tree_flatten_with_path

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as jopt
from bigdl_tpu import obs as jobs
from bigdl_tpu.parallel import DistriOptimizer as JaxDistri
from bigdl_tpu.parallel import allreduce_bandwidth as jax_bandwidth
from bigdl_tpu_torch import convert, obs
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.parallel import DistriOptimizer, allreduce_bandwidth
from bigdl_tpu_torch.parallel.allreduce import (ici_peak_gbps,
                                                ring_allreduce_bytes)
from bigdl_tpu_torch.utils.serializer import load_module
from bigdl_tpu.utils.serializer import load_module as jax_load_module

from test_torch_distri_optimizer import (_check_weights, _datasets,
                                         _failing, _mesh, _train)

N = 8


def _models(seed=0):
    def build(pkg, **kw):
        # BN after the nonlinearity: a bias right before a BN has no
        # gradient but rounding, which Adam turns into steps of lr
        return (pkg.Sequential().add(pkg.Linear(4, 16, **kw))
                .add(pkg.Tanh()).add(pkg.BatchNormalization(16, **kw))
                .add(pkg.Linear(16, 3, **kw)).add(pkg.LogSoftMax()))

    jm = build(jnn).build(seed, (2, 4))
    tm = build(tnn, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.state)))
    return jm, tm


def _sharded_run(pkg, tmp_path, monkeypatch, iters=5, fail_at=None):
    """One package's sharded run at N = 8 with Adam, a checkpoint every 2
    iterations (the last, ``shard.6``, after the 5th and last step by
    default); returns (optimizer, summary, model, checkpoint dir)."""
    monkeypatch.setenv("BIGDL_TPU_SHARDED_CHECKPOINT", "1")
    jm, tm = _models()
    jds, tds = _datasets()
    jo, to, (js, _, ts, _) = _train(
        jm, tm, jds, tds, n=N, epochs=3, wire="float32",
        ckpt=tmp_path, jmethod=jopt.Adam(learningrate=0.01),
        tmethod=topt.Adam(learningrate=0.01))
    o, s, m = (jo, js, jm) if pkg == "jax" else (to, ts, tm)
    o.set_end_when((jopt if pkg == "jax" else topt).Trigger.max_iteration(
        iters))
    if fail_at is not None:
        _failing(o, fail_at)
    o.optimize()
    root = tmp_path / ("bigdl_tpu" if pkg == "jax" else "bigdl_tpu_torch")
    return o, s, m, root


def _payload(root, neval):
    with open(root / f"shard.{neval}.p0", "rb") as f:
        return pickle.load(f)


def _all_numpy(tree):
    return all(isinstance(a, np.ndarray) or a is None or isinstance(a, int)
               for a in jax.tree_util.tree_leaves(tree))


def test_port_shard_file_reads_through_the_reference(tmp_path,
                                                     monkeypatch):
    to, _, tm, root = _sharded_run("torch", tmp_path, monkeypatch)
    names = set(os.listdir(root))
    assert {"shard.2.p0", "shard.4.p0", "shard.6.p0", "model.6",
            "optimMethod.6"} <= names
    payload = _payload(root, 6)
    assert payload["neval"] == 6 and payload["pid"] == 0 \
        and payload["nprocs"] == 1 and _all_numpy(payload["flat"])
    state = to._step.state
    ss = state.arp.slice_size
    assert [s for s, _ in payload["flat"]] == [p * ss for p in range(N)]
    mesh = _mesh(N)
    like = jax.device_put(jnp.zeros(state.arp.padded_size),
                          NamedSharding(mesh, P("data")))
    flat = JaxDistri._from_blocks(payload["flat"], like)
    np.testing.assert_array_equal(np.asarray(flat),
                                  state.full_master("cpu").numpy())
    # the reference's slot tree for the same slice
    ref_tree = jopt.Adam().init_state(jnp.zeros(ss))
    leaves, _ = tree_flatten_with_path(ref_tree)
    assert set(payload["opt"]) == {keystr(p) for p, _ in leaves}
    gathered = state.gathered_opt_state()
    for key, blocks in payload["opt"].items():
        name = key[2:-2]
        if blocks[0][0] is None:
            got = JaxDistri._from_blocks(blocks, jax.device_put(
                jnp.zeros((), blocks[0][1].dtype),
                NamedSharding(mesh, P())))
            assert got.dtype == blocks[0][1].dtype
            assert int(got) == int(blocks[0][1])
            if name == "step":
                assert int(got) == int(gathered[name]) == 5
        else:
            got = JaxDistri._from_blocks(blocks, like)
            np.testing.assert_array_equal(
                np.asarray(got), gathered[name]["flat"].numpy())
    want = convert.model_state_to_jax(state.replicas[0])
    assert len(jax.tree_util.tree_leaves(want)) == 2
    for a, b in zip(jax.tree_util.tree_leaves(payload["state"]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    # the marker model file: the native format, the reference's marker
    # attribute at its root, replica 0's buffers (what a resume restores)
    marker = load_module(str(root / "model.6"), device="cpu")
    assert marker._sharded_weights_marker == {"neval": 6, "nprocs": 1}
    for (k, a), (_, b) in zip(marker.named_buffers(),
                              state.replicas[0].named_buffers()):
        assert torch.equal(a, b.cpu()), k
    assert jax_load_module(str(root / "model.6"))._sharded_weights_marker \
        == {"neval": 6, "nprocs": 1}


def test_reference_shard_file_reads_into_the_port(tmp_path, monkeypatch):
    _, _, jm, root = _sharded_run("jax", tmp_path, monkeypatch)
    payload = _payload(root, 6)
    _, tm = _models()
    to = DistriOptimizer(model=tm, dataset=_datasets()[1],
                         criterion=tnn.ClassNLLCriterion(), mesh=["cpu"] * N)
    to.set_optim_method(topt.Adam(learningrate=0.01))
    to._build_step()
    state = to._step.state
    masters = to._from_blocks(payload["flat"], state.masters)
    np.testing.assert_array_equal(
        torch.cat(masters).numpy(),
        np.concatenate([b for _, b in sorted(payload["flat"],
                                             key=lambda t: t[0])]))
    leaves = to._opt_leaves(state.opt_states)
    assert set(leaves) == set(payload["opt"])
    for key, (scalar, parts) in leaves.items():
        blocks = payload["opt"][key]
        assert scalar == (blocks[0][0] is None)
        if scalar:
            got = to._from_blocks(blocks, parts[0])
            np.testing.assert_array_equal(got.numpy(), blocks[0][1])
        else:
            got = to._from_blocks(blocks, parts)
            for t, (start, b) in zip(got, sorted(blocks,
                                                 key=lambda t: t[0])):
                np.testing.assert_array_equal(t.numpy(), b)
    bufs = convert.model_state_from_jax(tm, payload["state"])
    assert sorted(bufs) == ["2.running_mean", "2.running_var"]
    for k, v in bufs.items():
        np.testing.assert_array_equal(
            v.numpy(), payload["state"][2][k.split(".")[1]])
    assert not np.array_equal(payload["state"][2]["running_var"],
                              np.ones(16, np.float32))   # trained


def test_sharded_retry_matches_the_reference_sharded_retry(tmp_path,
                                                           monkeypatch):
    """One failure at the sixth batch: both reload shard.6.p0 (after
    iteration 5) with its Adam slots and go on."""
    jo, js, jm, _ = _sharded_run("jax", tmp_path, monkeypatch, iters=10,
                                 fail_at=6)
    to, ts, tm, root = _sharded_run("torch", tmp_path, monkeypatch,
                                    iters=10, fail_at=6)
    assert to.retries == 1
    assert ts.steps() == js.steps() and max(ts.steps()) >= 10
    np.testing.assert_allclose(ts.values(), js.values(), rtol=1e-4)
    _check_weights(jm, tm)
    assert "shard.10.p0" in os.listdir(root)


def test_block_round_trip_is_exact():
    parts = [torch.arange(8.0) + 8 * p for p in range(N)]
    blocks = DistriOptimizer._local_blocks(parts, 8)
    assert len(blocks) == N and blocks[0][0] == 0 and blocks[1][0] == 8
    back = DistriOptimizer._from_blocks(blocks, [torch.zeros(8)] * N)
    torch.testing.assert_close(torch.cat(back), torch.arange(64.0),
                               rtol=0, atol=0)
    scalar = torch.tensor(3, dtype=torch.int32)
    blocks = DistriOptimizer._local_blocks(scalar)
    assert blocks[0][0] is None
    assert int(DistriOptimizer._from_blocks(blocks, torch.zeros(
        (), dtype=torch.int32))) == 3
    with pytest.raises(RuntimeError, match="does not cover offset"):
        DistriOptimizer._from_blocks(blocks[:0] + [(0, np.zeros(8))],
                                     [torch.zeros(8)] * 2)


def _opt(tmp_path, n=2):
    _, tm = _models()
    to = DistriOptimizer(model=tm, dataset=_datasets()[1],
                         criterion=tnn.ClassNLLCriterion(), mesh=["cpu"] * n)
    to.set_optim_method(topt.Adam(learningrate=0.01))
    to.checkpoint_path = str(tmp_path)
    return to


def test_incomplete_shard_set_raises_not_stale_restore(tmp_path):
    to = _opt(tmp_path)
    (tmp_path / "shard.4.p1").write_bytes(b"partial")
    (tmp_path / "model.4").write_bytes(b"stale")
    (tmp_path / "optimMethod.4").write_bytes(b"stale")
    with pytest.raises(RuntimeError, match="none is complete"):
        to._reload_latest()


def test_candidates_newest_first_sharded_on_a_tie():
    files = ["shard.4.p0", "model.4", "optimMethod.4", "model.6",
             "optimMethod.6", "model.2", "shard.8.p1", "model.8",
             "optimMethod.8", "model.6.tmp", "shard.9.p0.tmp"]
    cands, groups = DistriOptimizer._candidates(files)
    assert cands == [(6, "gathered"), (4, "sharded")]
    assert groups == {4: {0}, 8: {1}}
    key = [(4, "gathered"), (4, "sharded")]
    assert sorted(key, key=lambda t: (t[0], t[1] == "sharded"),
                  reverse=True)[0] == (4, "sharded")


def test_a_garbled_candidate_demotes_across_formats(tmp_path, monkeypatch):
    """Gathered 2 and 6 and sharded 4 in one directory: newest first, and
    a candidate that fails to restore demotes to the next older, of
    either format."""
    monkeypatch.setenv("BIGDL_TPU_SHARDED_CHECKPOINT", "1")
    sharded = _opt(tmp_path / "s")
    sharded.set_end_when(topt.Trigger.max_iteration(4))
    sharded.set_checkpoint(str(tmp_path / "s"),
                           topt.Trigger.several_iteration(2))
    sharded.optimize()
    monkeypatch.setenv("BIGDL_TPU_SHARDED_CHECKPOINT", "0")
    gathered = _opt(tmp_path / "g")
    gathered.set_end_when(topt.Trigger.max_iteration(6))
    gathered.set_checkpoint(str(tmp_path / "g"),
                            topt.Trigger.several_iteration(2))
    gathered.optimize()
    d = tmp_path / "d"
    d.mkdir()
    for src, n in (("g", 2), ("g", 6), ("s", 4)):
        for f in os.listdir(tmp_path / src):
            if f.split(".")[1] == str(n):
                shutil.copy(tmp_path / src / f, d / f)
    to = _opt(d)
    assert to._reload_latest()["neval"] == 6
    (d / "model.6").write_bytes(b"garbled")
    assert to._reload_latest()["neval"] == 4
    want = _payload(tmp_path / "s", 4)["flat"]
    np.testing.assert_array_equal(
        to._step.state.full_master("cpu").numpy(),
        np.concatenate([b for _, b in want]))
    (d / "shard.4.p0").write_bytes(b"garbled")
    assert to._reload_latest()["neval"] == 2


def test_marker_model_file_is_refused_without_its_shards(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SHARDED_CHECKPOINT", "1")
    to = _opt(tmp_path)
    to.set_end_when(topt.Trigger.max_iteration(2))
    to.set_checkpoint(str(tmp_path), topt.Trigger.several_iteration(2))
    to.optimize()
    m = load_module(str(tmp_path / "model.2"), device="cpu")
    assert m._sharded_weights_marker == {"neval": 2, "nprocs": 1}
    os.replace(tmp_path / "shard.2.p0", tmp_path / "shard.2.p0.tmp")
    with pytest.raises(ValueError, match="STALE placeholder"):
        load_module(str(tmp_path / "model.2"), device="cpu")
    with pytest.raises(RuntimeError, match="no checkpoint to retry from"):
        to._reload_latest()       # its only candidate, refused, demotes


# ---------------------------------------------------- allreduce_bandwidth
def _registry(pkg):
    o = jobs if pkg == "jax" else obs
    return (o.counter("bigdl_allreduce_bytes_total",
                      "wire bytes moved by gradient allreduce").value,
            o.histogram("bigdl_allreduce_sync_seconds",
                        "blocking allreduce sync time").count)


@pytest.mark.parametrize("pattern,label", [
    ("step", "all_gather+psum_scatter (train step)"), ("psum", "psum")])
def test_allreduce_bandwidth_matches_reference_registry(pattern, label,
                                                        monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PEAK_ICI_GBPS", "50")   # even with a peak
    j0, t0 = _registry("jax"), _registry("torch")
    want = jax_bandwidth(_mesh(N), size_mb=2, iters=3, pattern=pattern)
    got = allreduce_bandwidth(["cpu"] * N, size_mb=2, iters=3,
                              pattern=pattern)
    j1, t1 = _registry("jax"), _registry("torch")
    assert got["pattern"] == want["pattern"] == label
    n = 2 * 1024 * 1024 // 2
    assert got["ring_bytes"] == ring_allreduce_bytes(n, N)
    assert t1[0] - t0[0] == j1[0] - j0[0] == got["ring_bytes"] * 3
    assert t1[1] - t0[1] == j1[1] - j0[1] == 1
    assert got["seconds_per_allreduce"] > 0
    # every device here is the CPU: no byte crosses a link
    assert not any(k.endswith("bandwidth_gbps") or k.startswith("efficiency")
                   for k in got), got
    assert "efficiency_vs_peak" in want
    with pytest.raises(ValueError, match="unknown pattern"):
        allreduce_bandwidth(["cpu"] * 2, size_mb=1, pattern="ring")


def test_link_peak_table_and_override(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_PEAK_ICI_GBPS", raising=False)
    assert ici_peak_gbps("NVIDIA H100 80GB HBM3") == 450.0
    assert ici_peak_gbps("NVIDIA H100 SXM5 80GB") == 450.0
    assert ici_peak_gbps("NVIDIA H100 PCIe") is None
    assert ici_peak_gbps("TPU v4") is None
    if not torch.cuda.is_available():
        assert ici_peak_gbps() is None
    monkeypatch.setenv("BIGDL_TPU_PEAK_ICI_GBPS", "123.5")
    assert ici_peak_gbps() == ici_peak_gbps("anything") == 123.5


def test_preemption_and_write_faults_take_the_sharded_path(tmp_path,
                                                           monkeypatch):
    """Under the flag the preemption checkpoint is a shard set, and a
    shard write failing under ``ckpt.write`` surfaces at the next
    checkpoint, whose retry resumes from the set before it."""
    import signal
    from bigdl_tpu_torch.resilience import TrainingPreempted, faults, preempt
    orig = signal.getsignal(signal.SIGTERM)
    monkeypatch.setenv("BIGDL_TPU_SHARDED_CHECKPOINT", "1")
    try:
        to = _opt(tmp_path / "p")
        to.set_end_when(topt.Trigger.max_iteration(8))
        to.set_checkpoint(str(tmp_path / "p"),
                          topt.Trigger.several_iteration(5))
        faults.configure("train.step:preempt:after=2:times=1")
        with pytest.raises(TrainingPreempted) as err:
            to.optimize()
        n = err.value.neval
        names = os.listdir(tmp_path / "p")
        assert n == 4 and {f"shard.{n}.p0", f"driverState.{n}"} <= set(names)
        preempt.clear()
        faults.configure("ckpt.write:error:after=1:times=1")
        to = _opt(tmp_path / "w")
        to.set_end_when(topt.Trigger.max_iteration(8))
        to.set_checkpoint(str(tmp_path / "w"),
                          topt.Trigger.several_iteration(2))
        reloads, real = [], to._reload_sharded
        to._reload_sharded = lambda k: reloads.append(k) or real(k)
        to.optimize()
        assert to.retries == 1 and reloads == [2]
    finally:
        faults.configure(None)
        preempt.clear()
        preempt.uninstall()
        signal.signal(signal.SIGTERM, orig)
