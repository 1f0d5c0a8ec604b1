"""The port's ``utils/profiling.py`` (per-layer timing, the dispatch
counters' obs collector, the modelled cost behind ``bigdl_mfu``, the card
peak table and the ``torch.profiler`` trace), on the CPU.

The modelled cost of one decode step (``serving.slots.DispatchCost``)
equals a hand count at this test's size exactly, on the paged and the
dense manager; the reference's ``CostStampedJit`` figure for the same
step (XLA's compile-time cost analysis of its whole step executable, every
slot row and the sampler included) is printed beside it, not held.
"""

import gc
import json
import re

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving.paging import PagedSlotManager as JaxPaged
from bigdl_tpu.serving.slots import SlotManager as JaxSlots
from bigdl_tpu_torch import convert, obs
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.obs import reqtrace
from bigdl_tpu_torch.serving import PagedSlotManager, SlotManager
from bigdl_tpu_torch.utils import profiling
from bigdl_tpu_torch.utils.profiling import (DispatchCounters, format_times,
                                             per_layer_times)

H, LAYERS, VOCAB, INTER = 64, 2, 97, 256
CFG = dict(vocab_size=VOCAB, hidden_size=H, n_layers=LAYERS, n_heads=4,
           max_position=64)
PROMPTS = [list(range(3, 8)), list(range(10, 21))]      # lengths 5 and 11


def _model():
    return (nn.Sequential()
            .add(nn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1, device="cpu"))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2))
            .add(nn.Reshape((4 * 4 * 4,)))
            .add(nn.Linear(4 * 4 * 4, 10, device="cpu"))).reset(0)


def test_per_layer_times_covers_every_layer():
    x = torch.ones(2, 1, 8, 8)
    entries = per_layer_times(_model(), x, repeats=2)
    assert [e[0].split(":")[-1] for e in entries] == [
        "SpatialConvolution", "ReLU", "SpatialMaxPooling", "Reshape",
        "Linear"]
    assert all(e[0].startswith(f"Sequential[{i}]:")
               for i, e in enumerate(entries))
    assert all(f > 0 and b > 0 for _, f, b in entries)
    table = format_times(entries)
    assert "Linear" in table and "TOTAL" in table
    assert len(table.splitlines()) == len(entries) + 2


def test_per_layer_times_leaf_module_and_no_grad_input():
    lin = nn.Linear(4, 2, device="cpu").reset(0)
    (entry,) = per_layer_times(lin, torch.ones(3, 4), repeats=2)
    assert entry[0] == "Linear" and entry[1] > 0 and entry[2] > 0
    # nothing to differentiate: an integer input into a parameter-free layer
    (entry,) = per_layer_times(nn.Reshape((4,)),
                               torch.ones(3, 2, 2, dtype=torch.long))
    assert entry[1] > 0 and entry[2] == 0.0


def _hand_decode(lengths, kv_token_bytes):
    """One decode step of the slots at ``lengths`` by hand: every layer's
    four projections and two MLP matrices, the head, and QK^T + PV over
    each token's ``length + 1`` positions; the weights once plus the K/V
    read (each row's new context) and written (one token a row)."""
    n = len(lengths)
    per_token = LAYERS * (3 * H * H + H * H + H * INTER + INTER * H)
    flops = (2 * n * per_token + 2 * n * VOCAB * H
             + sum(2 * 2 * H * LAYERS * (L + 1) for L in lengths))
    weight_bytes = 4 * (per_token + VOCAB * H)
    return flops, weight_bytes + kv_token_bytes * (
        sum(L + 1 for L in lengths) + n)


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(7), None)
    return jm, params, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_modelled_decode_step_cost_equals_a_hand_count(pair, paged):
    jm, params, sd = pair
    assert reqtrace.enabled()
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    m.requires_grad_(False)
    if paged:
        sl = PagedSlotManager(m, max_slots=2, page_size=8, prefill_chunk=8)
        ref = JaxPaged(jm, params, 2, page_size=8, prefill_chunk=8)
    else:
        sl = SlotManager(m, max_slots=2, window=2)
        ref = JaxSlots(jm, params, 2, window=2)
    sl.admit(PROMPTS)
    ref.admit(PROMPTS)
    kv = sl.pool_stats()["kv_bytes_per_token"]
    assert kv == LAYERS * 2 * H * 4
    f0, b0 = sl.stats.flops, sl.stats.hbm_bytes
    sl.reserve_block()
    sl.step()
    got = (sl.stats.flops - f0, sl.stats.hbm_bytes - b0)
    assert got == _hand_decode([len(p) for p in PROMPTS], kv)
    rf0 = ref.stats.flops
    if paged:
        ref.reserve_block()
    ref.step()
    ref_flops = ref.stats.flops - rf0
    print(f"\n{'paged' if paged else 'dense'} decode step: modelled "
          f"{got[0]:.0f} flops, reference CostStampedJit {ref_flops:.0f} "
          f"(ratio {got[0] / ref_flops if ref_flops else float('nan'):.4f})")


def test_cost_is_added_only_while_request_tracing_is_on(pair):
    _, _, sd = pair
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    prev = reqtrace.set_enabled(False)
    try:
        sl = PagedSlotManager(m, max_slots=2, page_size=8, prefill_chunk=8)
    finally:
        reqtrace.set_enabled(prev)
    sl.admit(PROMPTS)
    sl.reserve_block()
    sl.step()
    assert sl.stats.flops == 0.0 and sl.stats.hbm_bytes == 0.0
    assert sl.stats["dispatches"] > 0


def test_dispatch_counters_publish_as_collector(monkeypatch):
    reg = obs.default_registry()
    stats = DispatchCounters("prefills", "steps", obs_name="proftest")
    stats.tick("steps", 5)
    text = reg.prometheus_text()
    src = [ln for ln in text.splitlines() if "proftest" in ln]
    assert any(ln.startswith("bigdl_decode_dispatches") and ln.endswith(" 5")
               for ln in src)
    assert not any("bigdl_decode_traces" in ln for ln in src)
    assert not any("bigdl_device_flops" in ln for ln in src)  # no cost yet
    name = re.search(r'source="(proftest-\d+)"', src[0]).group(1)
    monkeypatch.setattr(profiling, "_peak_cache", [1e12])
    stats.add_cost(2e9, 3e6)
    reg.prometheus_text()                      # first costed scrape
    stats.add_cost(2e9, 3e6)
    snap = reg.snapshot()
    assert snap["bigdl_device_flops"]["series"][-1]["value"] == 4e9
    assert snap["bigdl_hbm_bytes"]["series"][-1]["value"] == 6e6
    rate = [s for s in snap["bigdl_device_flops_per_sec"]["series"]
            if s["labels"]["source"] == name][0]["value"]
    mfu = [s for s in snap["bigdl_mfu"]["series"]
           if s["labels"]["source"] == name][0]["value"]
    assert rate > 0 and mfu == pytest.approx(rate / 1e12)
    stats.reset()
    assert stats["steps"] == 0 and stats.flops == 4e9
    del stats, src
    gc.collect()
    assert name not in reg.prometheus_text()


def test_device_peak_flops(monkeypatch):
    monkeypatch.setattr(profiling, "_peak_cache", [])
    assert profiling.device_peak_flops() is None          # the CPU
    for card, want in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(profiling, "_peak_cache", [])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, c=card: c)
        assert profiling.device_peak_flops() == want


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
