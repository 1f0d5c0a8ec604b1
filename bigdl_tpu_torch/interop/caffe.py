"""Caffe model loader: prototxt (text) + caffemodel (binary) (the port of
``bigdl_tpu/interop/caffe.py``: reference ``utils/caffe/CaffeLoader.scala:57``,
``loadBinary:96`` merging the prototxt's net with the caffemodel's weights
by layer name, and the layer translation of ``Converter.scala``/
``LayerConverter.scala``).

The schemas, the V1 type enum, :func:`parse_prototxt` and the blob reader
are the reference's, copied. :func:`_build_graph` gives one port ``Graph``
node per layer, with the reference's rules and layer names: a ``Slice``
becomes one ``Narrow`` node per top (``"<name>:<i>"``); an ``Eltwise``
with coefficients a ``MulConstant`` per input into a ``CAddTable`` (``[1,
-1]``: ``CSubTable``); ``Power``, ``Exp`` and ``Log`` ``MulConstant``/
``AddConstant`` chains; a ``SoftmaxWithLoss`` a ``LogSoftMax`` on its first
bottom; every pooling rounds up (Caffe's rule, ``ceil``); an
``InnerProduct`` is a ``Flatten`` then a ``Linear``; ``Recurrent`` is
refused. Without a caffemodel blob a convolution takes its input width
from the layer's ``_n_in``, else 3, and an ``InnerProduct`` from ``_n_in``,
else 1, as the reference's does: the port infers no shapes either.

The graph's layers are made on the card unless given ``device="cpu"``,
with seeded weights (``Module.reset(0)``); the caffemodel's blobs are
recorded on the graph and copied in by :func:`apply_caffe_weights`, which
:func:`load_caffe` calls when given ``sample_input`` (the reference's
build). Blob layouts are the port's as they are: a convolution's OIHW, an
``InnerProduct``'s ``(out, in)``, a ``Deconvolution``'s ``(in, out / g,
kh, kw)``. Supported layer types (the reference's
``caffe_layer_list.md`` coverage): Input/Data, Convolution,
Deconvolution, InnerProduct, ReLU, PReLU, ELU, TanH, Sigmoid, AbsVal,
BNLL, Power, Exp, Log, Threshold, Pooling, LRN, Dropout, Softmax,
SoftmaxWithLoss, Concat, Slice (multi-top), Eltwise (SUM/PROD/MAX),
BatchNorm, Scale, Bias, Flatten, Reshape, Tile.
"""

from __future__ import annotations

import math
import re

import numpy as np

from bigdl_tpu_torch.interop.torch_file import _assign
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.protowire import decode
from bigdl_tpu_torch.utils.shape import trace_shapes

# ------------------------------------------------------------- pb schemas ---

BLOB_SHAPE = {1: ("dim[]", "int")}
BLOB = {1: ("num", "int"), 2: ("channels", "int"), 3: ("height", "int"),
        4: ("width", "int"), 5: ("data[]", "floats_packed"),
        7: ("shape", ("msg", BLOB_SHAPE))}
CONV_PARAM = {1: ("num_output", "int"), 2: ("bias_term", "bool"),
              3: ("pad[]", "int"), 4: ("kernel_size[]", "int"),
              5: ("group", "int"), 6: ("stride[]", "int"),
              9: ("pad_h", "int"), 10: ("pad_w", "int"),
              11: ("kernel_h", "int"), 12: ("kernel_w", "int"),
              13: ("stride_h", "int"), 14: ("stride_w", "int"),
              18: ("dilation[]", "int")}
IP_PARAM = {1: ("num_output", "int"), 2: ("bias_term", "bool")}
POOL_PARAM = {1: ("pool", "int"), 2: ("kernel_size", "int"),
              3: ("stride", "int"), 4: ("pad", "int"),
              5: ("kernel_h", "int"), 6: ("kernel_w", "int"),
              7: ("stride_h", "int"), 8: ("stride_w", "int"),
              9: ("pad_h", "int"), 10: ("pad_w", "int"),
              12: ("global_pooling", "bool")}
LRN_PARAM = {1: ("local_size", "int"), 2: ("alpha", "float"),
             3: ("beta", "float"), 4: ("norm_region", "int"),
             5: ("k", "float")}
BN_PARAM = {1: ("use_global_stats", "bool"),
            2: ("moving_average_fraction", "float"), 3: ("eps", "float")}
DROPOUT_PARAM = {1: ("dropout_ratio", "float")}
ELTWISE_PARAM = {1: ("operation", "int"), 2: ("coeff[]", "floats_packed")}
CONCAT_PARAM = {2: ("axis", "int"), 1: ("concat_dim", "int")}
POWER_PARAM = {1: ("power", "float"), 2: ("scale", "float"),
               3: ("shift", "float")}
SLICE_PARAM = {3: ("axis", "int"), 2: ("slice_point[]", "int"),
               1: ("slice_dim", "int")}
TILE_PARAM = {1: ("axis", "int"), 2: ("tiles", "int")}
THRESHOLD_PARAM = {1: ("threshold", "float")}
ELU_PARAM = {1: ("alpha", "float")}
BIAS_PARAM = {1: ("axis", "int"), 2: ("num_axes", "int")}
EXP_PARAM = {1: ("base", "float"), 2: ("scale", "float"),
             3: ("shift", "float")}
LOG_PARAM = EXP_PARAM
RESHAPE_PARAM = {1: ("shape", ("msg", BLOB_SHAPE)), 2: ("axis", "int"),
                 3: ("num_axes", "int")}
LAYER = {1: ("name", "string"), 2: ("type", "string"),
         3: ("bottom[]", "string"), 4: ("top[]", "string"),
         7: ("blobs[]", ("msg", BLOB)),
         103: ("pooling_param", ("msg", POOL_PARAM)),
         106: ("convolution_param", ("msg", CONV_PARAM)),
         108: ("dropout_param", ("msg", DROPOUT_PARAM)),
         110: ("eltwise_param", ("msg", ELTWISE_PARAM)),
         117: ("inner_product_param", ("msg", IP_PARAM)),
         118: ("lrn_param", ("msg", LRN_PARAM)),
         120: ("concat_param", ("msg", CONCAT_PARAM)),
         139: ("batch_norm_param", ("msg", BN_PARAM)),
         122: ("power_param", ("msg", POWER_PARAM)),
         126: ("slice_param", ("msg", SLICE_PARAM)),
         138: ("tile_param", ("msg", TILE_PARAM)),
         128: ("threshold_param", ("msg", THRESHOLD_PARAM)),
         140: ("elu_param", ("msg", ELU_PARAM)),
         141: ("bias_param", ("msg", BIAS_PARAM)),
         111: ("exp_param", ("msg", EXP_PARAM)),
         134: ("log_param", ("msg", LOG_PARAM)),
         133: ("reshape_param", ("msg", RESHAPE_PARAM))}
# V1LayerParameter.LayerType — values from upstream caffe.proto (the
# reference ships them generated in java/caffe/Caffe.java *_VALUE consts)
V1_TYPES = {1: "Accuracy", 2: "BNLL", 3: "Concat", 4: "Convolution",
            5: "Data", 6: "Dropout", 7: "EuclideanLoss", 8: "Flatten",
            9: "HDF5Data", 10: "HDF5Output", 11: "Im2col", 12: "ImageData",
            13: "InfogainLoss", 14: "InnerProduct", 15: "LRN",
            16: "MultinomialLogisticLoss", 17: "Pooling", 18: "ReLU",
            19: "Sigmoid", 20: "Softmax", 21: "SoftmaxWithLoss",
            22: "Split", 23: "TanH", 24: "WindowData", 25: "Eltwise",
            26: "Power", 27: "SigmoidCrossEntropyLoss", 28: "HingeLoss",
            29: "MemoryData", 30: "ArgMax", 31: "Threshold",
            32: "DummyData", 33: "Slice", 34: "MVN", 35: "AbsVal",
            36: "Silence", 37: "ContrastiveLoss", 38: "Exp",
            39: "Deconvolution"}

# the reference matches layer types case-insensitively with alias
# spellings (Converter.scala:631-669 uppercases and registers both
# INNERPRODUCT and INNER_PRODUCT); canonicalise to the V2 CamelCase
# names the dispatch below uses
_TYPE_CANON = {
    "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "INNERPRODUCT": "InnerProduct", "RELU": "ReLU", "LRN": "LRN",
    "POOLING": "Pooling", "DROPOUT": "Dropout", "SOFTMAX": "Softmax",
    "SOFTMAXLOSS": "SoftmaxWithLoss", "SOFTMAXWITHLOSS": "SoftmaxWithLoss",
    "TANH": "TanH", "SIGMOID": "Sigmoid",
    "SIGMOIDCROSSENTROPYLOSS": "Sigmoid",  # Converter.scala:644
    "ABSVAL": "AbsVal", "BATCHNORM": "BatchNorm", "CONCAT": "Concat",
    "ELU": "ELU", "FLATTEN": "Flatten", "LOG": "Log", "POWER": "Power",
    "PRELU": "PReLU", "RECURRENT": "Recurrent", "RNN": "Recurrent",
    "RESHAPE": "Reshape", "SCALE": "Scale", "BIAS": "Bias",
    "THRESHOLD": "Threshold", "EXP": "Exp", "SLICE": "Slice",
    "TILE": "Tile", "ELTWISE": "Eltwise", "INPUT": "Input",
    "DATA": "Data", "DUMMYDATA": "DummyData", "ANNOTATEDDATA": "Data",
    "MEMORYDATA": "Data", "IMAGEDATA": "ImageData", "HDF5DATA": "HDF5Data",
    "ACCURACY": "Accuracy", "SILENCE": "Silence", "SPLIT": "Split",
    "BNLL": "BNLL",
}


def _canon_type(t):
    return _TYPE_CANON.get(str(t).upper().replace("_", ""), t)
V1_LAYER = {2: ("bottom[]", "string"), 3: ("top[]", "string"),
            4: ("name", "string"), 5: ("type_enum", "int"),
            6: ("blobs[]", ("msg", BLOB)),
            10: ("convolution_param", ("msg", CONV_PARAM)),
            17: ("inner_product_param", ("msg", IP_PARAM)),
            19: ("pooling_param", ("msg", POOL_PARAM)),
            18: ("lrn_param", ("msg", LRN_PARAM))}
NET = {1: ("name", "string"), 3: ("input[]", "string"),
       2: ("layers[]", ("msg", V1_LAYER)),
       100: ("layer[]", ("msg", LAYER))}


def _blob_array(blob):
    data = np.asarray(blob.get("data", []), dtype=np.float32)
    shape = blob.get("shape", {}).get("dim")
    if not shape:
        shape = [blob.get(k, 1) for k in ("num", "channels", "height", "width")]
    shape = [int(s) for s in shape if int(s) != 0] or [data.size]
    return data.reshape(shape)


# ----------------------------------------------------------- prototxt text --

_TOKEN = re.compile(r'\s*(?:(#[^\n]*)|([A-Za-z_][\w]*)\s*(\{|:)|(\})|("(?:[^"\\]|\\.)*")|([^\s{}]+))')


def parse_prototxt(text):
    """Parse Caffe TextFormat into nested dicts (repeated keys -> lists)."""
    pos = 0
    root = {}
    stack = [root]
    n = len(text)
    while pos < n:
        m = _TOKEN.match(text, pos)
        if not m:
            break
        pos = m.end()
        comment, key, opener, closer, _, _ = m.groups()
        if comment:
            continue
        if closer:
            stack.pop()
            continue
        if key:
            if opener == "{":
                child = {}
                _store(stack[-1], key, child)
                stack.append(child)
            else:  # key: value
                vm = re.match(r'\s*("(?:[^"\\]|\\.)*"|[^\s{}]+)', text[pos:])
                raw = vm.group(1)
                pos += vm.end()
                _store(stack[-1], key, _coerce(raw))
    return root


def _store(d, key, value):
    if key in d:
        if not isinstance(d[key], list):
            d[key] = [d[key]]
        d[key].append(value)
    else:
        d[key] = value


def _coerce(raw):
    if raw.startswith('"'):
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return raw  # enum identifier


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ---------------------------------------------------------------- builder ---

class CaffeLoader:
    """(reference ``CaffeLoader.scala:57``)"""

    def __init__(self, def_path=None, model_path=None):
        self.def_path = def_path
        self.model_path = model_path

    def _layers_from_prototxt(self):
        with open(self.def_path) as f:
            net = parse_prototxt(f.read())
        layers = _as_list(net.get("layer") or net.get("layers"))
        out = []
        for l in layers:
            out.append({
                "name": l.get("name"), "type": l.get("type"),
                "bottom": _as_list(l.get("bottom")),
                "top": _as_list(l.get("top")),
                "params": l,
            })
        inputs = _as_list(net.get("input"))
        return inputs, out

    def _layers_from_binary(self):
        with open(self.model_path, "rb") as f:
            net = decode(f.read(), NET)
        layers = net.get("layer") or []
        for v1 in net.get("layers") or []:
            v1["type"] = V1_TYPES.get(v1.get("type_enum"), "Unknown")
            layers.append(v1)
        out = []
        for l in layers:
            out.append({
                "name": l.get("name"), "type": l.get("type"),
                "bottom": l.get("bottom", []), "top": l.get("top", []),
                "params": l,
                "blobs": [_blob_array(b) for b in l.get("blobs", [])],
            })
        return net.get("input", []), out

    def load(self, device=None):
        """A port ``Graph`` from the prototxt's structure, on ``device``
        (default the card), with the binary weights recorded for
        :func:`apply_caffe_weights` (reference ``loadBinary:96``)."""
        inputs, proto_layers = self._layers_from_prototxt()
        weights = {}
        if self.model_path:
            _, bin_layers = self._layers_from_binary()
            weights = {l["name"]: l.get("blobs", []) for l in bin_layers}
        return _build_graph(inputs, proto_layers, weights,
                            resolve_device(device))

    def load_weights_into(self, module, match_all=True):
        """Copy weights into an existing model by layer name
        (reference ``CaffeLoader.load`` with matchAll)."""
        _, bin_layers = self._layers_from_binary()
        blobs = {l["name"]: l.get("blobs", []) for l in bin_layers}
        copied = _copy_weights_by_name(module, blobs)
        if match_all:
            named = _collect_named_with_params(module)
            missing = [n for n in named if n not in blobs]
            if missing:
                raise ValueError(f"no caffe weights for layers {missing}")
        return module, copied


def _leaves(module):
    """The leaf layers under ``module``: containers' children and graphs'
    nodes in order."""
    from bigdl_tpu_torch import nn
    if isinstance(module, nn.Container):
        for c in module:
            yield from _leaves(c)
    elif isinstance(module, nn.Graph):
        for node in module.exec_order:
            yield from _leaves(node.module)
    else:
        yield module


def _collect_named_with_params(module):
    from bigdl_tpu_torch import nn
    return [m.get_name() for m in _leaves(module)
            if isinstance(m, (nn.Linear, nn.SpatialConvolution))]


def _copy_weights_by_name(module, blobs):
    """Apply caffe blobs to matching layers; returns copied names."""
    from bigdl_tpu_torch import nn
    copied = []
    for m in _leaves(module):
        bl = blobs.get(m.get_name())
        if not bl:
            continue
        has_bias = getattr(m, "bias", None) is not None
        if isinstance(m, nn.SpatialConvolution):
            if bl[0].ndim == 4:                           # caffe OIHW
                _assign(m.weight, bl[0])
            if len(bl) > 1 and has_bias:
                _assign(m.bias, bl[1].reshape(-1))
            copied.append(m.get_name())
        elif isinstance(m, nn.Linear):
            w = bl[0].reshape(bl[0].shape[-2], bl[0].shape[-1]) \
                if bl[0].ndim > 2 else bl[0]               # (out, in)
            _assign(m.weight, w)
            if len(bl) > 1 and has_bias:
                _assign(m.bias, bl[1].reshape(-1))
            copied.append(m.get_name())
        elif isinstance(m, nn.SpatialBatchNormalization):
            # caffe BatchNorm blobs: mean, var, scale_factor
            sf = float(bl[2].ravel()[0]) if len(bl) > 2 else 1.0
            sf = 1.0 / sf if sf != 0 else 0.0
            _assign(m.running_mean, bl[0].reshape(-1) * sf)
            _assign(m.running_var, bl[1].reshape(-1) * sf)
            copied.append(m.get_name())
        elif isinstance(m, nn.SpatialFullConvolution):
            if bl[0].ndim == 4:          # caffe deconv (in, out/g, kh, kw)
                _assign(m.weight, bl[0])
            if len(bl) > 1 and has_bias:
                _assign(m.bias, bl[1].reshape(-1))
            copied.append(m.get_name())
        elif isinstance(m, nn.Scale):
            _assign(m.weight, bl[0].reshape(1, -1, 1, 1))
            if len(bl) > 1:
                _assign(m.bias, bl[1].reshape(1, -1, 1, 1))
            copied.append(m.get_name())
    return copied


def _build_graph(inputs, layers, weights, device):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.graph import Input, Node

    blob_nodes = {}
    input_nodes = []
    for name in inputs:
        node = Input()
        blob_nodes[name] = node
        input_nodes.append(node)

    def conv_from(l):
        p = l["params"].get("convolution_param", {})
        ks = _as_list(p.get("kernel_size"))
        kh = int(p.get("kernel_h", ks[0] if ks else 1))
        kw = int(p.get("kernel_w", ks[-1] if ks else 1))
        st = _as_list(p.get("stride")) or [1]
        sh = int(p.get("stride_h", st[0]))
        sw = int(p.get("stride_w", st[-1]))
        pd = _as_list(p.get("pad")) or [0]
        ph = int(p.get("pad_h", pd[0]))
        pw = int(p.get("pad_w", pd[-1]))
        group = int(p.get("group", 1))
        n_out = int(p["num_output"])
        bl = weights.get(l["name"], [])
        if bl:
            n_in = bl[0].shape[1] * group
        else:
            n_in = int(l["params"].get("_n_in", 3))
        m = nn.SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph,
                                  n_group=group,
                                  with_bias=p.get("bias_term", True),
                                  device=device)
        m.set_name(l["name"])
        return m

    def ip_from(l):
        p = l["params"].get("inner_product_param", {})
        n_out = int(p["num_output"])
        bl = weights.get(l["name"], [])
        n_in = bl[0].shape[-1] if bl else int(l["params"].get("_n_in", 1))
        linear = nn.Linear(n_in, n_out,
                           with_bias=p.get("bias_term", True),
                           device=device).set_name(l["name"])
        # caffe InnerProduct flattens trailing dims implicitly
        return nn.Sequential().add(nn.Flatten()).add(linear)

    def pool_from(l):
        p = l["params"].get("pooling_param", {})
        k = int(p.get("kernel_size", 2))
        kh, kw = int(p.get("kernel_h", k)), int(p.get("kernel_w", k))
        s = int(p.get("stride", 1))
        sh, sw = int(p.get("stride_h", s)), int(p.get("stride_w", s))
        pad = int(p.get("pad", 0))
        ph, pw = int(p.get("pad_h", pad)), int(p.get("pad_w", pad))
        pool = p.get("pool", 0)
        if p.get("global_pooling"):
            if pool in (0, "MAX"):
                return nn.SpatialMaxPooling(1, 1, global_pooling=True)
            return nn.SpatialAveragePooling(1, 1, global_pooling=True)
        if pool in (0, "MAX"):
            return nn.SpatialMaxPooling(kw, kh, sw, sh, pw, ph).ceil()
        return nn.SpatialAveragePooling(kw, kh, sw, sh, pw, ph,
                                        ceil_mode=True)

    last_node = None
    for l in layers:
        t = _canon_type(l["type"])
        if t in ("Input", "Data", "DummyData", "ImageData", "HDF5Data"):
            node = Input()
            for top in l["top"]:
                blob_nodes[top] = node
            input_nodes.append(node)
            last_node = node
            continue
        if t in ("SoftmaxWithLoss", "Accuracy", "Silence"):
            # training/eval-only heads: softmax-with-loss becomes LogSoftMax
            if t == "SoftmaxWithLoss":
                m = nn.LogSoftMax().set_name(l["name"])
                node = Node(m).inputs(blob_nodes[l["bottom"][0]])
                for top in l["top"]:
                    blob_nodes[top] = node
                last_node = node
            continue
        if t == "Convolution":
            m = conv_from(l)
        elif t == "InnerProduct":
            m = ip_from(l)
        elif t == "ReLU":
            m = nn.ReLU().set_name(l["name"])
        elif t == "TanH":
            m = nn.Tanh().set_name(l["name"])
        elif t == "Sigmoid":
            m = nn.Sigmoid().set_name(l["name"])
        elif t == "Pooling":
            m = pool_from(l).set_name(l["name"])
        elif t == "LRN":
            p = l["params"].get("lrn_param", {})
            # norm_region: 0/ACROSS_CHANNELS (default) | 1/WITHIN_CHANNEL
            # (reference Converter.scala:92-97)
            region = p.get("norm_region", 0)
            cls = (nn.SpatialWithinChannelLRN
                   if region in (1, "WITHIN_CHANNEL")
                   else nn.SpatialCrossMapLRN)
            args = [int(p.get("local_size", 5)),
                    float(p.get("alpha", 1e-4)),
                    float(p.get("beta", 0.75))]
            if cls is nn.SpatialCrossMapLRN:
                args.append(float(p.get("k", 1.0)))
            m = cls(*args).set_name(l["name"])
        elif t == "Dropout":
            p = l["params"].get("dropout_param", {})
            m = nn.Dropout(float(p.get("dropout_ratio", 0.5))).set_name(l["name"])
        elif t == "Softmax":
            m = nn.SoftMax().set_name(l["name"])
        elif t == "Concat":
            p = l["params"].get("concat_param", {})
            m = nn.JoinTable(int(p.get("axis", 1))).set_name(l["name"])
        elif t == "Eltwise":
            p = l["params"].get("eltwise_param", {})
            op = p.get("operation", 1)
            coeffs = [float(v) for v in _as_list(p.get("coeff"))]
            if op in (1, "SUM") and coeffs \
                    and coeffs != [1.0] * len(coeffs):
                # reference Converter.scala:233-245: [1,-1] -> CSubTable,
                # arbitrary coeffs -> MulConstant per input into CAddTable
                if len(coeffs) != len(l["bottom"]):
                    raise ValueError(
                        f"Eltwise {l['name']}: {len(coeffs)} coeffs for "
                        f"{len(l['bottom'])} bottoms (caffe requires one "
                        "per input)")
                if coeffs == [1.0, -1.0]:
                    m = nn.CSubTable().set_name(l["name"])
                else:
                    bottoms = [blob_nodes[b] for b in l["bottom"]]
                    scaled = [Node(nn.MulConstant(c)).inputs(bn)
                              for c, bn in zip(coeffs, bottoms)]
                    node = Node(nn.CAddTable()
                                .set_name(l["name"])).inputs(*scaled)
                    for top in l["top"]:
                        blob_nodes[top] = node
                    last_node = node
                    continue
            else:
                m = {0: nn.CMulTable, 1: nn.CAddTable,
                     "PROD": nn.CMulTable, "SUM": nn.CAddTable,
                     2: nn.CMaxTable, "MAX": nn.CMaxTable}[op]()
                m.set_name(l["name"])
        elif t == "Flatten":
            m = nn.Flatten().set_name(l["name"])
        elif t == "BatchNorm":
            bl = weights.get(l["name"], [])
            if bl:
                n = int(bl[0].size)
                p = l["params"].get("batch_norm_param", {})
                m = nn.SpatialBatchNormalization(
                    n, eps=float(p.get("eps", 1e-5)), affine=False,
                    device=device).set_name(l["name"])
            else:
                # structure-only load: no channel count without blobs
                m = nn.Identity().set_name(l["name"])
        elif t == "Scale":
            bl = weights.get(l["name"], [])
            if bl:
                n = int(bl[0].size)
                m = nn.Scale((1, n, 1, 1), device=device).set_name(l["name"])
            else:
                m = nn.Identity().set_name(l["name"])
        elif t == "Split":
            m = nn.Identity().set_name(l["name"])
        elif t == "AbsVal":
            m = nn.Abs().set_name(l["name"])
        elif t in ("ELU", "Elu"):
            p = l["params"].get("elu_param", {})
            m = nn.ELU(float(p.get("alpha", 1.0))).set_name(l["name"])
        elif t == "PReLU":
            m = nn.PReLU(device=device).set_name(l["name"])
        elif t == "Power":
            p = l["params"].get("power_param", {})
            power = float(p.get("power", 1.0))
            scale = float(p.get("scale", 1.0))
            shift = float(p.get("shift", 0.0))
            # (shift + scale*x)^power
            m = nn.Sequential(nn.MulConstant(scale), nn.AddConstant(shift),
                      nn.Power(power)).set_name(l["name"])
        elif t == "Exp":
            p = l["params"].get("exp_param", {})
            scale = float(p.get("scale", 1.0))
            shift = float(p.get("shift", 0.0))
            base = float(p.get("base", -1.0))
            ln_base = 1.0 if base <= 0 else math.log(base)
            m = nn.Sequential(nn.MulConstant(scale * ln_base),
                      nn.AddConstant(shift * ln_base),
                      nn.Exp()).set_name(l["name"])
        elif t == "Log":
            p = l["params"].get("log_param", {})
            scale = float(p.get("scale", 1.0))
            shift = float(p.get("shift", 0.0))
            m = nn.Sequential(nn.MulConstant(scale), nn.AddConstant(shift),
                      nn.Log()).set_name(l["name"])
        elif t in ("BNLL",):
            m = nn.SoftPlus().set_name(l["name"])
        elif t == "Threshold":
            p = l["params"].get("threshold_param", {})
            m = nn.BinaryThreshold(float(p.get("threshold", 0.0))) \
                .set_name(l["name"])
        elif t == "Tile":
            p = l["params"].get("tile_param", {})
            m = nn.Tile(int(p.get("axis", 1)),
                        int(p.get("tiles", 1))).set_name(l["name"])
        elif t == "Deconvolution":
            p = l["params"].get("convolution_param", {})
            ks = _as_list(p.get("kernel_size"))
            kh = int(p.get("kernel_h", ks[0] if ks else 1))
            kw = int(p.get("kernel_w", ks[-1] if ks else 1))
            st = _as_list(p.get("stride")) or [1]
            pd = _as_list(p.get("pad")) or [0]
            bl = weights.get(l["name"], [])
            # caffe deconv weight: (in, out/group, kh, kw)
            n_in = bl[0].shape[0] if bl else int(l["params"].get("_n_in", 1))
            n_out = int(p["num_output"])
            m = nn.SpatialFullConvolution(
                n_in, n_out, kw, kh, int(st[-1]), int(st[0]),
                int(pd[-1]), int(pd[0]),
                no_bias=not p.get("bias_term", True),
                device=device).set_name(l["name"])
        elif t == "Bias":
            bl = weights.get(l["name"], [])
            n = int(bl[0].size) if bl else 1
            m = nn.CAdd((1, n, 1, 1), device=device).set_name(l["name"])
        elif t == "Reshape":
            # reference LayerConverter.scala:160 -> InferReshape(dims):
            # 0 copies the input dim, -1 infers from the remainder
            p = l["params"].get("reshape_param", {})
            if int(p.get("axis", 0)) != 0 or int(p.get("num_axes", -1)) != -1:
                # partial-range reshape (SSD-style axis/num_axes) would
                # silently fold the batch dim through InferReshape; the
                # reference ignores these fields too — reject loudly
                raise ValueError(
                    f"Reshape {l['name']}: axis/num_axes sub-range "
                    "reshapes are not supported; rewrite with a full "
                    "shape spec (0 = copy dim)")
            dims = [int(v) for v in p.get("shape", {}).get("dim", [])]
            m = nn.InferReshape(dims).set_name(l["name"])
        elif t == "Recurrent":
            # the reference (Converter.scala:200) emits a bare Recurrent()
            # here, which can never run (no cell); fail at load time with
            # an actionable message instead of an opaque build crash
            raise ValueError(
                f"caffe RECURRENT/RNN layer {l['name']!r}: caffe carries "
                "no cell definition to map — build the recurrent stack "
                "with bigdl_tpu_torch.nn.Recurrent(cell) directly")
        elif t == "Slice":
            # multi-top layer: one Narrow node per output blob
            p = l["params"].get("slice_param", {})
            axis = int(p.get("axis", p.get("slice_dim", 1)))
            points = [int(v) for v in _as_list(p.get("slice_point"))]
            bottoms = [blob_nodes[b] for b in l["bottom"]]
            tops = l["top"]
            if not points:
                raise ValueError(
                    f"Slice {l['name']}: even split without slice_point "
                    "needs blob shapes; specify slice_point explicitly")
            bounds = [0] + points + [None]
            for ti, top in enumerate(tops):
                start = bounds[ti]
                end = bounds[ti + 1]
                # standard caffe form: N tops, N-1 slice_points — the last
                # top runs to the end of the bottom blob (Narrow length -1)
                length = -1 if end is None else end - start
                nd = Node(nn.Narrow(axis, start, length)
                          .set_name(f"{l['name']}:{ti}")).inputs(*bottoms)
                blob_nodes[top] = nd
                last_node = nd
            continue
        else:
            raise ValueError(f"unsupported caffe layer type {t} "
                             f"({l['name']})")
        bottoms = [blob_nodes[b] for b in l["bottom"]]
        node = Node(m).inputs(*bottoms)
        for top in l["top"]:
            blob_nodes[top] = node
        last_node = node

    graph = nn.Graph(input_nodes, last_node).reset(0)
    graph._caffe_weights = weights  # applied by apply_caffe_weights
    return graph


def apply_caffe_weights(graph):
    """Copy the recorded caffe blobs into the graph's layers."""
    if getattr(graph, "_caffe_weights", None):
        _copy_weights_by_name(graph, graph._caffe_weights)
    return graph


def load_caffe(def_path, model_path=None, sample_input=None, device=None):
    """One-call loader (reference ``Module.loadCaffeModel:80``): the graph
    on ``device`` (default the card); with ``sample_input`` (a shape, an
    array or tensor, or a list of them for several inputs) one forward of
    a CPU copy at batch 1 checks that the widths fit, as the reference's
    build does, and the weights are copied in."""
    graph = CaffeLoader(def_path, model_path).load(device=device)
    if sample_input is not None:
        trace_shapes(graph, sample_input)
        apply_caffe_weights(graph)
    return graph
