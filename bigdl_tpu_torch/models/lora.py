"""LoRA adapter math for multi-tenant GPT serving (the port of
``bigdl_tpu/models/lora.py``).

One base model serves many fine-tuned variants (S-LoRA, Punica): every
adapter is a pair of low-rank slabs per target projection, and a dispatch
gathers the slabs of the adapters its rows run under from a device pool
(``serving/adapters.py``). This module owns the adapter data model and the
per-dispatch slab trees:

- an adapter is a plain numpy tree ``{"rank", "alpha", "layers": [{target:
  {"a": (in, r), "b": (r, out)}}]}`` in the reference's orientation (not
  ``F.linear``'s (out, in)), so a tree made by the reference's
  ``init_adapter`` serves here unchanged and digests the same;
- :func:`init_adapter` draws one from a ``torch.Generator``: A ~ N(0,
  0.02), B zero (an exact no-op; ``b_std > 0`` draws B too);
- :func:`adapter_planes` / :func:`adapter_from_planes` are the reference's
  host-plane layout (one dict a layer, ``"<target>.a"`` / ``"<target>.b"``,
  then a meta plane of (rank, alpha)): the K/V page layout, so the host
  tier and the page store hold adapters as they hold pages;
- :func:`adapter_digest` is the reference's 16-byte blake2b content
  address, byte for byte: the pool's identity of an adapter and the
  prefix-cache domain separator (``serving.paging.chain_seed``);
- :func:`gather_pool_rows` selects one pool row a batch row, with the
  rows' scales: the batched slab tree a dispatch passes down
  (``models.gpt``: every target projection adds
  ``nn.quantized.lora_delta``); row 0 is the base model, scale 0;
- :class:`SingleAdapter` is the reference's ``wrap_params_single``: one
  adapter for every row, unbatched 2-D slabs and a scalar scale, the
  single-tenant oracle of the serving tests.

Under tensor parallelism a slab follows its base weight
(:func:`split_slab`): a column-parallel target (``wq``, ``wk``, ``wv``,
``fc1``) keeps A whole and splits B's output columns as the head split
does; a row-parallel target (``wo``, ``fc2``) splits A's input rows and
keeps B whole: the shards' rank-r partials ``x_i @ A_i`` are summed,
then B applied once on the first shard (``models.gpt._row_parallel``).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from bigdl_tpu_torch.nn.quantized import quantize_array

# the reference's versioned domain seed: equal digests across packages
_ADAPTER_SEED = b"bigdl-tpu-adapter-v1"

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "fc1", "fc2")
_ATTN_TARGETS = frozenset(("wq", "wk", "wv", "wo"))
ROW_PARALLEL_TARGETS = frozenset(("wo", "fc2"))


def _target_linear(block, tgt):
    """The ``Linear`` (or ``Int8Linear``) of target ``tgt`` in a
    ``TransformerDecoderBlock``."""
    return getattr(block.attn, tgt) if tgt in _ATTN_TARGETS \
        else getattr(block, tgt)


def target_shapes(model):
    """Per-layer ``{target: (in, out)}`` of the default targets of an
    unsharded ``GPTForCausalLM`` (float or int8 weights; torch's (out, in)
    read the reference's way)."""
    shapes = []
    for blk in model.gpt.layers:
        layer = {}
        for tgt in DEFAULT_TARGETS:
            w = _target_linear(blk, tgt).weight
            layer[tgt] = (int(w.shape[1]), int(w.shape[0]))
        shapes.append(layer)
    return shapes


def init_adapter(generator, model, rank, alpha=None, b_std=0.0):
    """A fresh adapter sized for ``model``: per layer and target (sorted),
    A ~ 0.02 N(0, 1) of (in, rank) then B of (rank, out), zero or ``b_std``
    N(0, 1), float32 numpy arrays drawn from ``generator`` (a CPU
    ``torch.Generator``). Zero B makes the adapter an exact no-op."""
    rank = int(rank)
    if rank < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {rank}")
    alpha = float(rank if alpha is None else alpha)
    layers = []
    for shapes in target_shapes(model):
        layer = {}
        for tgt in sorted(shapes):
            din, dout = shapes[tgt]
            a = 0.02 * torch.randn((din, rank), generator=generator)
            if b_std > 0.0:
                b = b_std * torch.randn((rank, dout), generator=generator)
            else:
                b = torch.zeros((rank, dout))
            layer[tgt] = {"a": a.numpy(), "b": b.numpy()}
        layers.append(layer)
    return {"rank": rank, "alpha": alpha, "layers": layers}


# ---------------------------------------------------------------- identity
def adapter_planes(adapter):
    """An adapter as host planes: one dict a layer keyed ``"<target>.a"`` /
    ``"<target>.b"``, then ``{"meta": [rank, alpha]}`` float32."""
    planes = []
    for layer in adapter["layers"]:
        pl = {}
        for tgt in sorted(layer):
            pl[tgt + ".a"] = np.ascontiguousarray(layer[tgt]["a"])
            pl[tgt + ".b"] = np.ascontiguousarray(layer[tgt]["b"])
        planes.append(pl)
    planes.append({"meta": np.asarray(
        [float(adapter["rank"]), float(adapter["alpha"])], np.float32)})
    return planes


def adapter_from_planes(planes):
    """Inverse of :func:`adapter_planes`."""
    if not planes:
        raise ValueError("empty adapter planes")
    meta = planes[-1]["meta"]
    layers = []
    for pl in planes[:-1]:
        layer = {}
        for key in pl:
            tgt, part = key.rsplit(".", 1)
            layer.setdefault(tgt, {})[part] = np.asarray(pl[key])
        layers.append(layer)
    return {"rank": int(round(float(meta[0]))), "alpha": float(meta[1]),
            "layers": layers}


def adapter_digest(adapter):
    """16-byte blake2b over the adapter's planes (per plane its layer,
    name, dtype, shape, then bytes) under the versioned domain seed: the
    reference's digest of the same tree."""
    h = hashlib.blake2b(_ADAPTER_SEED, digest_size=16)
    for li, pl in enumerate(adapter_planes(adapter)):
        for k in sorted(pl):
            a = np.ascontiguousarray(pl[k])
            h.update(f"{li}:{k}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.digest()


# ------------------------------------------------------------------- slabs
def host_slabs(adapter, int8=False):
    """An adapter's slabs as CPU tensors, per layer ``{target: {"a", "b"}}``:
    float32, or with ``int8`` each slab ``{"q", "scale"}`` from
    ``quantize_array(slab, reduce_axes=(0,))`` (a scale per column, over
    the contraction dim), as the reference's int8 pool stores them."""
    layers = []
    for al in adapter["layers"]:
        layer = {}
        for tgt in sorted(al):
            slabs = {}
            for part in ("a", "b"):
                v = torch.tensor(np.asarray(al[tgt][part], np.float32))
                if int8:
                    q, scale = quantize_array(v, reduce_axes=(0,))
                    slabs[part] = {"q": q, "scale": scale}
                else:
                    slabs[part] = v
            layer[tgt] = slabs
        layers.append(layer)
    return layers


def split_slab(slab, tgt, part, tp, dim_offset=0):
    """Shard ``i``'s part of one slab (a tensor, or int8 ``{"q",
    "scale"}``) for each of ``tp`` shards: A of a row-parallel target on
    its input dim, B of a column-parallel target on its output dim, the
    rest whole. ``dim_offset`` 1 for pooled (rows, ...) slabs. An int8
    slab's per-column scale splits with B's columns and stays whole for
    A."""
    row = tgt in ROW_PARALLEL_TARGETS
    if part == "a":
        dim = 0 if row else None
    else:
        dim = None if row else 1
    if isinstance(slab, dict):
        q = split_slab(slab["q"], tgt, part, tp, dim_offset)
        sc = (split_slab(slab["scale"], tgt, part, tp, dim_offset)
              if part == "b" else [slab["scale"]] * tp)
        return [{"q": a, "scale": b} for a, b in zip(q, sc)]
    if dim is None or tp == 1:
        return [slab] * tp
    return list(slab.chunk(tp, dim + dim_offset))


def gather_pool_rows(layers, scale, rows):
    """One batch's slab tree from a pool (``layers`` per layer ``{target:
    {"a", "b"}}`` of (pool rows, ...) tensors or int8 ``{"q", "scale"}``,
    ``scale`` (pool rows,)): the pool rows ``rows`` (a (B,) int64 tensor on
    the pool's device), one a batch row. Returns ``{"scale": (B,),
    "layers": [...]}`` of (B, ...) slabs."""
    def take(v):
        if isinstance(v, dict):
            return {k: x.index_select(0, rows) for k, x in v.items()}
        return v.index_select(0, rows)

    return {"scale": scale.index_select(0, rows),
            "layers": [{tgt: {"a": take(s["a"]), "b": take(s["b"])}
                        for tgt, s in layer.items()} for layer in layers]}


def layer_lora(tree, i):
    """Layer ``i``'s ``{target: (a, b, scale)}`` of a slab tree, the form
    ``nn.quantized.lora_linear`` takes."""
    s = tree["scale"]
    return {tgt: (ab["a"], ab["b"], s)
            for tgt, ab in tree["layers"][i].items()}


class SingleAdapter:
    """One adapter for every row (the reference's ``wrap_params_single``):
    unbatched 2-D slabs on ``device`` (or, with a ``layout``, each shard's
    part on its device) and the scalar scale ``alpha / rank``. Its
    :meth:`gathered` is the slab tree whatever the rows, so a slot manager
    given it as ``adapter_pool`` runs every row under this one adapter:
    the single-tenant oracle. ``int8`` quantises the slabs as an int8
    pool does."""

    def __init__(self, adapter, device="cpu", int8=False, layout=None):
        s = float(adapter["alpha"]) / float(adapter["rank"])
        host = host_slabs(adapter, int8)
        devices = [torch.device(device)] if layout is None else layout.devices
        tp = len(devices)
        trees = []
        for i, dev in enumerate(devices):
            layers = []
            for layer in host:
                out = {}
                for tgt, ab in layer.items():
                    out[tgt] = {part: _to(split_slab(ab[part], tgt, part,
                                                     tp)[i], dev)
                                for part in ("a", "b")}
                layers.append(out)
            trees.append({"scale": s, "layers": layers})
        self.tree = trees[0] if layout is None else trees

    def gathered(self, rows):
        return self.tree


def _to(slab, device):
    if isinstance(slab, dict):
        return {k: v.to(device).contiguous() for k, v in slab.items()}
    return slab.to(device).contiguous()


__all__ = ["DEFAULT_TARGETS", "ROW_PARALLEL_TARGETS", "target_shapes",
           "init_adapter", "adapter_planes", "adapter_from_planes",
           "adapter_digest", "host_slabs", "split_slab", "gather_pool_rows",
           "layer_lora", "SingleAdapter"]
