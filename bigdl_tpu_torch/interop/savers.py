"""Model exporters: Caffe (prototxt + caffemodel) and TensorFlow GraphDef
(the port of ``bigdl_tpu/interop/savers.py``: reference
``utils/caffe/CaffePersister.scala``, which walks a BigDL graph and emits a
caffe NetParameter in TextFormat and binary with the weight blobs, and
``utils/tf/TensorflowSaver.scala:36``, which maps each layer to TF ops and
writes a GraphDef pb).

Each exporter reuses its loader's wire codec and field numbers
(``interop/caffe.py``, ``interop/tf_loader.py``), so an export loads back
in-process. The port's layouts are Caffe's: a convolution's weight is
OIHW and a ``Linear``'s ``(out, in)``, written as they are. TF's are the
reference's: HWIO and ``(in, out)``, through ``nn.module.jax_layout``, so
both packages write the same GraphDef bytes for the same module and
weights. ``LogSoftMax`` exports as ``SoftmaxWithLoss`` to Caffe (the
inverse of the loader's mapping) and as ``LogSoftmax`` to TF. The TF
saver takes NHWC convolutions and pooling and one output, as the
reference's does.

``_linearize`` walks ``Sequential`` containers and ``Graph`` nodes, as the
reference's does; any other container (a ``Concat``) is one layer, which
``_caffe_layer`` refuses as the reference does. Its shapes come from
``utils.shape.trace_shapes`` (one forward of a batch-1 CPU copy) where the
reference's come from ``output_spec``.
"""

from __future__ import annotations

import os

import numpy as np

from bigdl_tpu_torch.interop import caffe as caffe_fmt
from bigdl_tpu_torch.interop import tf_loader as tf_fmt
from bigdl_tpu_torch.interop.torch_file import _np_of
from bigdl_tpu_torch.utils import protowire
from bigdl_tpu_torch.utils.shape import trace_shapes


# ------------------------------------------------------------- linearizer --

class _Layer:
    def __init__(self, name, module, bottoms, top, in_spec, out_spec):
        self.name, self.module = name, module
        self.bottoms, self.top = bottoms, top
        self.in_spec, self.out_spec = in_spec, out_spec


def _linearize(model, input_spec):
    """Flatten a Sequential/Graph model into an ordered layer list with
    blob names and per-layer shapes (the saver's view of the net)."""
    from bigdl_tpu_torch import nn

    shapes = trace_shapes(model, input_spec)
    layers = []
    seen = {}

    def unique(name):
        k = seen.get(name, 0)
        seen[name] = k + 1
        return name if k == 0 else f"{name}_{k}"

    def walk(m, bottoms):
        """Returns the top name(s) of the sub-model."""
        if isinstance(m, nn.Sequential):
            top = bottoms[0]
            for child in m:
                top = walk(child, [top])
            return top
        if isinstance(m, nn.Graph):
            values = {}
            for node in m.exec_order:
                if not node.prev_nodes:
                    values[node.id] = bottoms[m.input_nodes.index(node)]
                    continue
                values[node.id] = walk(node.module,
                                       [values[p.id] for p in node.prev_nodes])
            outs = [values[o.id] for o in m.output_nodes]
            return outs[0] if len(outs) == 1 else outs
        # leaf layer
        name = unique(m.get_name())
        in_spec, out_spec = shapes.get(id(m), (None, None))
        layers.append(_Layer(name, m, bottoms, name, in_spec, out_spec))
        return name

    top = walk(model, ["data"])
    return layers, top


# ---------------------------------------------------------- CaffePersister --

class CaffePersister:
    """Export to Caffe prototxt + caffemodel
    (reference ``utils/caffe/CaffePersister.scala``)."""

    @staticmethod
    def save(model, prototxt_path, model_path, input_spec,
             overwrite=False):
        for p in (prototxt_path, model_path):
            if os.path.exists(p) and not overwrite:
                raise FileExistsError(f"{p} exists; pass overwrite=True")
        layers, _ = _linearize(model, input_spec)
        defs = []
        for l in layers:
            defs.extend(_caffe_layer(l))
        # prototxt (structure only, no blobs)
        text = [f'name: "{model.get_name()}"', 'input: "data"']
        shape = tuple(int(d) for d in layers[0].in_spec)
        text.append("input_shape { " +
                    " ".join(f"dim: {d}" for d in shape) + " }")
        for d in defs:
            text.append(_prototxt_block(d))
        with open(prototxt_path, "w") as f:
            f.write("\n".join(text) + "\n")
        # binary (with blobs)
        net = {"name": model.get_name(), "input": ["data"], "layer": defs}
        with open(model_path, "wb") as f:
            f.write(protowire.encode(net, caffe_fmt.NET))

    save_caffe = save


def _blob(a):
    a = np.asarray(a, dtype=np.float32)
    return {"shape": {"dim": list(a.shape)}, "data": a.ravel()}


def _caffe_layer(l):
    """One linearized layer -> caffe layer def dict(s) for the LAYER schema."""
    from bigdl_tpu_torch import nn
    m = l.module
    base = {"name": l.name, "bottom": l.bottoms, "top": [l.top]}

    if isinstance(m, nn.SpatialConvolution):
        if m.format != "NCHW":
            raise ValueError("caffe export requires NCHW convs")
        if m.pad_w == -1 or m.pad_h == -1:
            raise ValueError(
                f"caffe export: {l.name} uses SAME padding; caffe has only "
                "explicit pads — rebuild with explicit pad_w/pad_h")
        with_bias = m.bias is not None
        blobs = [_blob(_np_of(m.weight))]                 # OIHW
        if with_bias:
            blobs.append(_blob(_np_of(m.bias)))
        return [{**base, "type": "Convolution",
                 "convolution_param": {
                     "num_output": m.n_output_plane,
                     "bias_term": with_bias, "group": m.n_group,
                     "kernel_h": m.kernel_h, "kernel_w": m.kernel_w,
                     "stride_h": m.stride_h, "stride_w": m.stride_w,
                     "pad_h": max(m.pad_h, 0), "pad_w": max(m.pad_w, 0)},
                 "blobs": blobs}]
    if isinstance(m, nn.Linear):
        w = _np_of(m.weight)                              # (out, in)
        with_bias = m.bias is not None
        blobs = [_blob(w)]
        if with_bias:
            blobs.append(_blob(_np_of(m.bias)))
        return [{**base, "type": "InnerProduct",
                 "inner_product_param": {"num_output": w.shape[0],
                                         "bias_term": with_bias},
                 "blobs": blobs}]
    if isinstance(m, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
        is_max = isinstance(m, nn.SpatialMaxPooling)
        pp = {"pool": 0 if is_max else 1}
        if m.global_pooling:
            pp["global_pooling"] = True
        elif m.pad_w == -1 or m.pad_h == -1:
            raise ValueError(
                f"caffe export: {l.name} uses SAME padding; caffe has only "
                "explicit pads")
        else:
            pp.update({"kernel_h": m.kh, "kernel_w": m.kw,
                       "stride_h": m.dh, "stride_w": m.dw,
                       "pad_h": max(m.pad_h, 0), "pad_w": max(m.pad_w, 0)})
        return [{**base, "type": "Pooling", "pooling_param": pp}]
    if isinstance(m, nn.SpatialCrossMapLRN):
        return [{**base, "type": "LRN",
                 "lrn_param": {"local_size": m.size, "alpha": m.alpha,
                               "beta": m.beta, "k": m.k}}]
    if isinstance(m, nn.Dropout):
        return [{**base, "type": "Dropout",
                 "dropout_param": {"dropout_ratio": m.p}}]
    if isinstance(m, nn.ReLU):
        return [{**base, "type": "ReLU"}]
    if isinstance(m, nn.Tanh):
        return [{**base, "type": "TanH"}]
    if isinstance(m, nn.Sigmoid):
        return [{**base, "type": "Sigmoid"}]
    if isinstance(m, nn.SoftMax):
        return [{**base, "type": "Softmax"}]
    if isinstance(m, nn.LogSoftMax):
        # inverse of the loader's SoftmaxWithLoss -> LogSoftMax mapping
        return [{**base, "type": "SoftmaxWithLoss"}]
    if isinstance(m, nn.Flatten):
        return [{**base, "type": "Flatten"}]
    if isinstance(m, nn.JoinTable):
        return [{**base, "type": "Concat",
                 "concat_param": {"axis": m.dimension}}]
    if isinstance(m, nn.CAddTable):
        return [{**base, "type": "Eltwise", "eltwise_param": {"operation": 1}}]
    if isinstance(m, nn.CMulTable):
        return [{**base, "type": "Eltwise", "eltwise_param": {"operation": 0}}]
    if isinstance(m, nn.CMaxTable):
        return [{**base, "type": "Eltwise", "eltwise_param": {"operation": 2}}]
    if isinstance(m, nn.SpatialBatchNormalization):
        out = [{**base, "type": "BatchNorm",
                "batch_norm_param": {"use_global_stats": True, "eps": m.eps},
                "blobs": [_blob(_np_of(m.running_mean)),
                          _blob(_np_of(m.running_var)),
                          _blob(np.ones((1,), np.float32))]}]
        if m.affine:
            out.append({"name": l.name + "_scale", "type": "Scale",
                        "bottom": [l.top], "top": [l.top],
                        "blobs": [_blob(_np_of(m.weight).ravel()),
                                  _blob(_np_of(m.bias).ravel())]})
        return out
    from bigdl_tpu_torch.nn.basic import Input as _InputModule
    if type(m).__name__ == "Identity" or isinstance(m, _InputModule):
        return [{**base, "type": "Split"}]
    raise ValueError(
        f"caffe export: unsupported layer {type(m).__name__} ({l.name})")


_PROTO_ENUMS = {("pooling_param", "pool"): {0: "MAX", 1: "AVE"},
                ("eltwise_param", "operation"): {0: "PROD", 1: "SUM", 2: "MAX"}}


def _prototxt_block(d):
    lines = ["layer {", f'  name: "{d["name"]}"', f'  type: "{d["type"]}"']
    for b in d.get("bottom", []):
        lines.append(f'  bottom: "{b}"')
    for t in d.get("top", []):
        lines.append(f'  top: "{t}"')
    for key, val in d.items():
        if not key.endswith("_param"):
            continue
        lines.append(f"  {key} {{")
        for k, v in val.items():
            enum = _PROTO_ENUMS.get((key, k))
            if enum is not None:
                v = enum[v]
            elif isinstance(v, bool):
                v = "true" if v else "false"
            lines.append(f"    {k}: {v}")
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


def save_caffe(model, prototxt_path, model_path, input_spec, overwrite=False):
    """One-call exporter (reference ``AbstractModule.saveCaffe:565``)."""
    CaffePersister.save(model, prototxt_path, model_path, input_spec,
                        overwrite=overwrite)


# --------------------------------------------------------- TensorflowSaver --

_DT_FLOAT = 1
_DT_INT32 = 3


class TensorflowSaver:
    """Export to a TF GraphDef pb (reference
    ``utils/tf/TensorflowSaver.scala:36``)."""

    @staticmethod
    def save(model, path, input_spec, input_name="input", overwrite=False):
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(f"{path} exists; pass overwrite=True")
        layers, top = _linearize(model, input_spec)
        if isinstance(top, list):
            raise ValueError("TF export supports single-output models; "
                             f"got {len(top)} outputs")
        nodes = [_tf_placeholder(input_name, layers[0].in_spec)]
        renames = {"data": input_name}
        for l in layers:
            new_nodes, out_name = _tf_layer(l, renames)
            nodes.extend(new_nodes)
            renames[l.top] = out_name
        graph = {"node": nodes}
        with open(path, "wb") as f:
            f.write(protowire.encode(graph, tf_fmt.GRAPH_DEF))
        return renames.get(top, top)  # the graph's output node name


def _tf_placeholder(name, shape):
    return {"name": name, "op": "Placeholder", "attr": [
        {"key": "dtype", "value": {"type": _DT_FLOAT}},
        {"key": "shape", "value": {"shape": {"dim": [{"size": int(d)}
                                                     for d in shape]}}}]}


def _tf_const(name, arr, dtype=None):
    a = np.asarray(arr)
    if dtype is None:
        dtype = _DT_INT32 if np.issubdtype(a.dtype, np.integer) else _DT_FLOAT
    a = a.astype("<i4" if dtype == _DT_INT32 else "<f4")
    return {"name": name, "op": "Const", "attr": [
        {"key": "dtype", "value": {"type": dtype}},
        {"key": "value", "value": {"tensor": {
            "dtype": dtype,
            "tensor_shape": {"dim": [{"size": int(d)} for d in a.shape]},
            "tensor_content": a.tobytes()}}}]}


def _attr_s(key, s):
    return {"key": key, "value": {"s": s.encode()}}


def _attr_ints(key, ints):
    return {"key": key, "value": {"list": {"i": [int(i) for i in ints]}}}


def _weight_in_tf_layout(m):
    """``m.weight`` in TF's layout (the reference's: ``Linear`` (in, out),
    a convolution HWIO)."""
    from bigdl_tpu_torch.convert import _leaf_to_jax
    return np.asarray(_leaf_to_jax(m, "weight", m.weight), np.float32)


def _tf_layer(l, renames):
    """One linearized layer -> ([NodeDef dicts], output node name)."""
    from bigdl_tpu_torch import nn
    m = l.module
    ins = [renames.get(b, b) for b in l.bottoms]
    name = l.name
    t = {"attr": [{"key": "T", "value": {"type": _DT_FLOAT}}]}

    def simple(op):
        return ([{"name": name, "op": op, "input": ins, **t}], name)

    if isinstance(m, nn.Linear):
        w = _tf_const(name + "/weight", _weight_in_tf_layout(m))  # (in, out)
        mm = {"name": name + "/matmul", "op": "MatMul",
              "input": [ins[0], w["name"]], **t}
        nodes = [w, mm]
        out = mm["name"]
        if m.bias is not None:
            b = _tf_const(name + "/bias", _np_of(m.bias))
            nodes += [b, {"name": name, "op": "BiasAdd",
                          "input": [out, b["name"]], **t}]
            out = name
        return nodes, out
    if isinstance(m, nn.SpatialConvolution):
        if m.format != "NHWC":
            raise ValueError("TF export supports NHWC convs (TPU layout); "
                             "build the model with format='NHWC'")
        if m.pad_w not in (0, -1) or m.pad_h not in (0, -1):
            raise ValueError("TF export: conv padding must be SAME (-1) or "
                             "VALID (0)")
        k = _tf_const(name + "/kernel", _weight_in_tf_layout(m))  # HWIO = TF layout
        conv = {"name": name + "/conv2d", "op": "Conv2D",
                "input": [ins[0], k["name"]],
                "attr": t["attr"] + [
                    _attr_ints("strides", [1, m.stride_h, m.stride_w, 1]),
                    _attr_s("padding",
                            "SAME" if m.pad_w == -1 else "VALID"),
                    _attr_s("data_format", "NHWC")]}
        nodes = [k, conv]
        out = conv["name"]
        if m.bias is not None:
            b = _tf_const(name + "/bias", _np_of(m.bias))
            nodes += [b, {"name": name, "op": "BiasAdd",
                          "input": [out, b["name"]], **t}]
            out = name
        return nodes, out
    if isinstance(m, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
        if m.format != "NHWC":
            raise ValueError("TF export supports NHWC pooling")
        if getattr(m, "global_pooling", False):
            # would serialize as a ksize [1,1,1,1] identity node
            raise ValueError(
                "TF export: global pooling has no fixed ksize; use an "
                "explicit kernel the size of the feature map")
        if m.pad_w not in (0, -1) or m.pad_h not in (0, -1):
            raise ValueError("TF export: pooling padding must be SAME/VALID")
        op = ("MaxPool" if isinstance(m, nn.SpatialMaxPooling) else "AvgPool")
        return ([{"name": name, "op": op, "input": ins,
                  "attr": t["attr"] + [
                      _attr_ints("ksize", [1, m.kh, m.kw, 1]),
                      _attr_ints("strides", [1, m.dh, m.dw, 1]),
                      _attr_s("padding", "SAME" if m.pad_w == -1 else "VALID"),
                      _attr_s("data_format", "NHWC")]}], name)
    if isinstance(m, nn.ReLU):
        return simple("Relu")
    if isinstance(m, nn.Tanh):
        return simple("Tanh")
    if isinstance(m, nn.Sigmoid):
        return simple("Sigmoid")
    if isinstance(m, nn.SoftMax):
        return simple("Softmax")
    if isinstance(m, nn.LogSoftMax):
        return simple("LogSoftmax")
    if isinstance(m, nn.Flatten):
        n = int(np.prod(tuple(l.out_spec)[1:]))
        shape = _tf_const(name + "/shape", np.asarray([-1, n], np.int32))
        return ([shape, {"name": name, "op": "Reshape",
                         "input": [ins[0], shape["name"]], **t}], name)
    if isinstance(m, nn.Reshape):
        dims = [-1] + [int(d) for d in tuple(l.out_spec)[1:]]
        shape = _tf_const(name + "/shape", np.asarray(dims, np.int32))
        return ([shape, {"name": name, "op": "Reshape",
                         "input": [ins[0], shape["name"]], **t}], name)
    if isinstance(m, nn.JoinTable):
        axis = _tf_const(name + "/axis",
                         np.asarray(m.dimension, np.int32))
        return ([axis, {"name": name, "op": "ConcatV2",
                        "input": ins + [axis["name"]],
                        "attr": t["attr"] + [
                            {"key": "N", "value": {"i": len(ins)}},
                            {"key": "Tidx", "value": {"type": _DT_INT32}}],
                        }], name)
    if isinstance(m, nn.CAddTable):
        nodes, cur = [], ins[0]
        for i, nxt in enumerate(ins[1:]):
            nm = name if i == len(ins) - 2 else f"{name}/add{i}"
            nodes.append({"name": nm, "op": "Add", "input": [cur, nxt], **t})
            cur = nm
        return nodes, cur
    from bigdl_tpu_torch.nn.basic import Input as _InputModule
    if isinstance(m, nn.Dropout) or type(m).__name__ == "Identity" \
            or isinstance(m, _InputModule):
        return ([{"name": name, "op": "Identity", "input": ins, **t}], name)
    raise ValueError(
        f"TF export: unsupported layer {type(m).__name__} ({l.name})")


def save_tf(model, path, input_spec, input_name="input", overwrite=False):
    """One-call exporter (reference ``AbstractModule.saveTF:580``)."""
    return TensorflowSaver.save(model, path, input_spec,
                                input_name=input_name, overwrite=overwrite)
