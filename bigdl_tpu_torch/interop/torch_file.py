"""Torch7 ``.t7`` binary reader and writer and the legacy-nn module
conversion (the port of ``bigdl_tpu/interop/torch_file.py``: reference
``utils/TorchFile.scala:67``, type tags at ``:37-64``: NIL=0 NUMBER=1
STRING=2 TABLE=3 TORCH=4 BOOLEAN=5, and ``Module.loadTorch``).

The reader and writer are the reference's, copied (numpy only): the
object graph decodes to Python (tensors to numpy), and the writer numbers
its objects and picks float, double or long storage as the reference's
does, so both packages write the same bytes for the same object graph.

:func:`load_torch` turns the recognised ``nn.*`` classes into the port's
modules with their weights, on the card unless given ``device="cpu"``:
``nn.Linear``'s ``(out, in)`` weight and a ``SpatialConvolution(MM)``'s
``(out, in * kh * kw)`` one are the port's layouts as they are (the
convolution's reshaped to OIHW). :func:`save_torch` is its inverse on the
classes the reference writes: ungrouped, undilated NCHW convolutions
only, and a ``Flatten`` as an ``nn.View(-1)`` with the per-sample rank of
the last input it flattened (or 3 after a spatial layer); anything else
raises as the reference does.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import resolve_device

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_TENSOR_DTYPES = {
    "torch.FloatTensor": (np.float32, "torch.FloatStorage"),
    "torch.DoubleTensor": (np.float64, "torch.DoubleStorage"),
    "torch.LongTensor": (np.int64, "torch.LongStorage"),
    "torch.IntTensor": (np.int32, "torch.IntStorage"),
    "torch.ByteTensor": (np.uint8, "torch.ByteStorage"),
}
_STORAGE_DTYPES = {
    "torch.FloatStorage": (np.float32, 4),
    "torch.DoubleStorage": (np.float64, 8),
    "torch.LongStorage": (np.int64, 8),
    "torch.IntStorage": (np.int32, 4),
    "torch.ByteStorage": (np.uint8, 1),
}


class TorchObject:
    """A decoded ``torch.*`` object that is not a tensor/storage."""

    def __init__(self, torch_class, payload):
        self.torch_class = torch_class
        self.payload = payload  # usually a dict (lua table)

    def get(self, key, default=None):
        if isinstance(self.payload, dict):
            return self.payload.get(key, default)
        return default

    def __repr__(self):
        return f"TorchObject({self.torch_class})"


class _Reader:
    def __init__(self, f):
        self.f = f
        self.memo = {}

    def _read(self, fmt, size):
        return struct.unpack(fmt, self.f.read(size))[0]

    def read_int(self):
        return self._read("<i", 4)

    def read_long(self):
        return self._read("<q", 8)

    def read_double(self):
        return self._read("<d", 8)

    def read_string(self):
        n = self.read_int()
        return self.f.read(n).decode("utf-8", errors="replace")

    def read_object(self):
        t = self.read_int()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            return self.read_double()
        if t == TYPE_STRING:
            return self.read_string()
        if t == TYPE_BOOLEAN:
            return bool(self.read_int())
        if t == TYPE_TABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            table = {}
            self.memo[idx] = table
            n = self.read_int()
            for _ in range(n):
                k = self.read_object()
                v = self.read_object()
                if isinstance(k, float) and k.is_integer():
                    k = int(k)
                table[k] = v
            return table
        if t == TYPE_TORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            version = self.read_string()
            if version.startswith("V "):
                cls = self.read_string()
            else:
                cls = version
            obj = self._read_torch_class(cls, idx)
            return obj
        raise ValueError(f"unknown t7 type tag {t}")

    def _read_torch_class(self, cls, idx):
        if cls in _TENSOR_DTYPES:
            dtype, _ = _TENSOR_DTYPES[cls]
            placeholder = TorchObject(cls, None)
            self.memo[idx] = placeholder
            ndim = self.read_int()
            size = [self.read_long() for _ in range(ndim)]
            stride = [self.read_long() for _ in range(ndim)]
            offset = self.read_long() - 1
            storage = self.read_object()
            if storage is None or ndim == 0:
                arr = np.zeros(size, dtype)
            else:
                data = storage if isinstance(storage, np.ndarray) else np.zeros(0, dtype)
                arr = np.lib.stride_tricks.as_strided(
                    data[offset:], shape=size,
                    strides=[s * data.itemsize for s in stride]).copy()
            self.memo[idx] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            dtype, itemsize = _STORAGE_DTYPES[cls]
            n = self.read_long()
            arr = np.frombuffer(self.f.read(n * itemsize), dtype=dtype).copy()
            self.memo[idx] = arr
            return arr
        placeholder = TorchObject(cls, None)
        self.memo[idx] = placeholder
        placeholder.payload = self.read_object()
        return placeholder


class _Writer:
    def __init__(self, f):
        self.f = f
        self.next_idx = 1

    def _w(self, fmt, v):
        self.f.write(struct.pack(fmt, v))

    def write_string(self, s):
        data = s.encode("utf-8")
        self._w("<i", len(data))
        self.f.write(data)

    def write_object(self, obj):
        if obj is None:
            self._w("<i", TYPE_NIL)
        elif isinstance(obj, bool):
            self._w("<i", TYPE_BOOLEAN)
            self._w("<i", int(obj))
        elif isinstance(obj, (int, float)):
            self._w("<i", TYPE_NUMBER)
            self._w("<d", float(obj))
        elif isinstance(obj, str):
            self._w("<i", TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, TorchObject):
            self._w("<i", TYPE_TORCH)
            self._w("<i", self.next_idx)
            self.next_idx += 1
            self.write_string("V 1")
            self.write_string(obj.torch_class)
            self.write_object(obj.payload)
        elif isinstance(obj, dict):
            self._w("<i", TYPE_TABLE)
            self._w("<i", self.next_idx)
            self.next_idx += 1
            self._w("<i", len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        else:
            raise TypeError(f"cannot write {type(obj)} to t7")

    def _write_tensor(self, arr):
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            tcls, scls = "torch.DoubleTensor", "torch.DoubleStorage"
        elif arr.dtype == np.int64:
            tcls, scls = "torch.LongTensor", "torch.LongStorage"
        else:
            arr = arr.astype(np.float32)
            tcls, scls = "torch.FloatTensor", "torch.FloatStorage"
        self._w("<i", TYPE_TORCH)
        self._w("<i", self.next_idx)
        self.next_idx += 1
        self.write_string("V 1")
        self.write_string(tcls)
        self._w("<i", arr.ndim)
        for s in arr.shape:
            self._w("<q", s)
        stride = [st // arr.itemsize for st in arr.strides]
        for s in stride:
            self._w("<q", s)
        self._w("<q", 1)  # storageOffset (1-based)
        # storage
        self._w("<i", TYPE_TORCH)
        self._w("<i", self.next_idx)
        self.next_idx += 1
        self.write_string("V 1")
        self.write_string(scls)
        self._w("<q", arr.size)
        self.f.write(arr.tobytes())


def read_t7(path):
    with open(path, "rb") as f:
        return _Reader(f).read_object()


def write_t7(path, obj):
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)


# ---------------------------------------------- legacy-nn -> the port ---

def _assign(t, a):
    """Copy the array ``a`` (a t7 tensor or a caffe blob) into the
    parameter or buffer ``t`` in place; a shape that does not fit raises
    (``copy_`` would broadcast some)."""
    a = np.asarray(a, dtype=np.float32)
    if tuple(a.shape) != tuple(t.shape):
        raise ValueError(f"a tensor of shape {a.shape} does not fit "
                         f"{tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def _to_module(obj, device):
    from bigdl_tpu_torch import nn
    cls = obj.torch_class if isinstance(obj, TorchObject) else None
    get = obj.get if isinstance(obj, TorchObject) else (lambda *_: None)

    def tensor(key):
        v = get(key)
        return np.asarray(v, dtype=np.float32) if v is not None else None

    if cls in ("nn.Sequential", "nn.Concat", "nn.ConcatTable",
               "nn.ParallelTable"):
        mods = get("modules", {})
        children = [_to_module(mods[k], device) for k in sorted(
            k for k in mods if isinstance(k, int))]
        if cls == "nn.Sequential":
            m = nn.Sequential()
        elif cls == "nn.Concat":
            m = nn.Concat(int(get("dimension", 2)) - 1)
        elif cls == "nn.ConcatTable":
            m = nn.ConcatTable()
        else:
            m = nn.ParallelTable()
        for c in children:
            m.add(c)
        return m
    if cls == "nn.Linear":
        w = tensor("weight")          # torch: (out, in)
        b = tensor("bias")
        m = nn.Linear(w.shape[1], w.shape[0], with_bias=b is not None,
                      device=device)
        _assign(m.weight, w)
        if b is not None:
            _assign(m.bias, b)
        return m
    if cls in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
        w = tensor("weight")
        b = tensor("bias")
        n_out = int(get("nOutputPlane"))
        n_in = int(get("nInputPlane"))
        kw, kh = int(get("kW")), int(get("kH"))
        m = nn.SpatialConvolution(n_in, n_out, kw, kh,
                                  int(get("dW", 1)), int(get("dH", 1)),
                                  int(get("padW", 0)), int(get("padH", 0)),
                                  with_bias=b is not None, device=device)
        _assign(m.weight, w.reshape(n_out, n_in, kh, kw))     # torch OIHW
        if b is not None:
            _assign(m.bias, b)
        return m
    if cls == "nn.SpatialBatchNormalization" or cls == "nn.BatchNormalization":
        w, b = tensor("weight"), tensor("bias")
        rm, rv = tensor("running_mean"), tensor("running_var")
        n = len(rm)
        ctor = (nn.SpatialBatchNormalization
                if cls == "nn.SpatialBatchNormalization"
                else nn.BatchNormalization)
        m = ctor(n, eps=float(get("eps", 1e-5)),
                 momentum=float(get("momentum", 0.1)),
                 affine=w is not None, device=device)
        if w is not None:
            _assign(m.weight, w)
            _assign(m.bias, b)
        _assign(m.running_mean, rm)
        _assign(m.running_var, rv)
        return m
    if cls == "nn.SpatialMaxPooling":
        m = nn.SpatialMaxPooling(int(get("kW")), int(get("kH")),
                                 int(get("dW", 1)), int(get("dH", 1)),
                                 int(get("padW", 0)), int(get("padH", 0)))
        if get("ceil_mode"):
            m.ceil()
        return m
    if cls == "nn.SpatialAveragePooling":
        return nn.SpatialAveragePooling(int(get("kW")), int(get("kH")),
                                        int(get("dW", 1)), int(get("dH", 1)),
                                        int(get("padW", 0)), int(get("padH", 0)))
    if cls == "nn.ReLU":
        return nn.ReLU()
    if cls == "nn.Tanh":
        return nn.Tanh()
    if cls == "nn.Sigmoid":
        return nn.Sigmoid()
    if cls == "nn.LogSoftMax":
        return nn.LogSoftMax()
    if cls == "nn.SoftMax":
        return nn.SoftMax()
    if cls == "nn.Dropout":
        return nn.Dropout(float(get("p", 0.5)))
    if cls in ("nn.View", "nn.Reshape"):
        size = get("size")
        dims = ([int(v) for k, v in sorted(size.items())]
                if isinstance(size, dict) else
                [int(s) for s in np.asarray(size).ravel()])
        bm = get("batchMode")
        return nn.Reshape(tuple(dims),
                          batch_mode=None if bm is None else bool(bm))
    if cls == "nn.Identity":
        return nn.Identity()
    if cls == "nn.SpatialCrossMapLRN":
        return nn.SpatialCrossMapLRN(int(get("size", 5)),
                                     float(get("alpha", 1e-4)),
                                     float(get("beta", 0.75)),
                                     float(get("k", 1.0)))
    if cls == "nn.SpatialZeroPadding":
        return nn.SpatialZeroPadding(int(get("pad_l", 0)), int(get("pad_r", 0)),
                                     int(get("pad_t", 0)), int(get("pad_b", 0)))
    if cls == "nn.CAddTable":
        return nn.CAddTable()
    if cls == "nn.JoinTable":
        return nn.JoinTable(int(get("dimension", 2)) - 1)
    raise ValueError(f"unsupported torch class for conversion: {cls}")


def load_torch(path, device=None):
    """Load a legacy-torch nn model from ``.t7`` (reference
    ``Module.loadTorch``), its modules on ``device`` (default the card)."""
    return _to_module(read_t7(path), resolve_device(device))


# ---------------------------------------------- the port -> legacy-nn ---

def _np_of(t):
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def _from_module(m):
    """Module -> legacy-torch ``nn.*`` TorchObject (the inverse of
    ``_to_module``; reference ``AbstractModule.saveTorch`` ->
    ``TorchFile.scala`` writes the same class/field layout)."""
    from bigdl_tpu_torch import nn

    def container(cls_name, extra=None):
        children = list(m)
        spatial = (nn.SpatialConvolution, nn.SpatialMaxPooling,
                   nn.SpatialAveragePooling, nn.SpatialBatchNormalization,
                   nn.SpatialCrossMapLRN)
        for i, c in enumerate(children):
            if isinstance(c, nn.Flatten) and i > 0 \
                    and isinstance(children[i - 1], spatial):
                c._t7_sample_rank = 3
        mods = {i + 1: _from_module(c) for i, c in enumerate(children)}
        fields = {"modules": mods}
        fields.update(extra or {})
        return TorchObject(cls_name, fields)

    if isinstance(m, nn.Sequential):
        return container("nn.Sequential")
    if isinstance(m, nn.Concat):
        return container("nn.Concat", {"dimension": m.dimension + 1})
    if isinstance(m, nn.ConcatTable):
        return container("nn.ConcatTable")
    if isinstance(m, nn.ParallelTable):
        return container("nn.ParallelTable")
    if type(m) is nn.Linear:
        fields = {"weight": _np_of(m.weight)}          # (out, in)
        if m.bias is not None:
            fields["bias"] = _np_of(m.bias)
        return TorchObject("nn.Linear", fields)
    if type(m) is nn.SpatialConvolution and m.n_group == 1 \
            and m.format == "NCHW" \
            and m.dilation_w == 1 and m.dilation_h == 1:
        fields = {"weight": _np_of(m.weight).reshape(m.n_output_plane, -1),
                  "nInputPlane": m.n_input_plane,
                  "nOutputPlane": m.n_output_plane,
                  "kW": m.kernel_w, "kH": m.kernel_h,
                  "dW": m.stride_w, "dH": m.stride_h,
                  "padW": m.pad_w, "padH": m.pad_h}
        if m.bias is not None:
            fields["bias"] = _np_of(m.bias)
        return TorchObject("nn.SpatialConvolutionMM", fields)
    if isinstance(m, (nn.SpatialBatchNormalization, nn.BatchNormalization)):
        cls = ("nn.SpatialBatchNormalization"
               if isinstance(m, nn.SpatialBatchNormalization)
               else "nn.BatchNormalization")
        fields = {"running_mean": _np_of(m.running_mean),
                  "running_var": _np_of(m.running_var),
                  "eps": float(m.eps), "momentum": float(m.momentum)}
        if m.affine:
            fields["weight"] = _np_of(m.weight)
            fields["bias"] = _np_of(m.bias)
        return TorchObject(cls, fields)
    if isinstance(m, nn.SpatialMaxPooling) and m.format == "NCHW" \
            and not m.global_pooling:
        # a global max pool would serialize as a 1x1 kernel (identity);
        # fall through to the unsupported-export error instead
        return TorchObject("nn.SpatialMaxPooling", {
            "kW": m.kw, "kH": m.kh, "dW": m.dw, "dH": m.dh,
            "padW": m.pad_w, "padH": m.pad_h,
            "ceil_mode": bool(m.ceil_mode)})
    if isinstance(m, nn.SpatialAveragePooling) and m.format == "NCHW" \
            and not m.global_pooling and not m.ceil_mode \
            and m.count_include_pad:
        return TorchObject("nn.SpatialAveragePooling", {
            "kW": m.kw, "kH": m.kh, "dW": m.dw, "dH": m.dh,
            "padW": m.pad_w, "padH": m.pad_h})
    if isinstance(m, nn.SpatialCrossMapLRN):
        return TorchObject("nn.SpatialCrossMapLRN", {
            "size": m.size, "alpha": float(m.alpha),
            "beta": float(m.beta), "k": float(m.k)})
    if isinstance(m, nn.Reshape):
        fields = {"size": np.asarray(m.size, np.int64)}
        if m.batch_mode is not None:
            fields["batchMode"] = bool(m.batch_mode)
        return TorchObject("nn.Reshape", fields)
    if isinstance(m, nn.Flatten):
        # legacy torch spells per-sample flatten as
        # nn.View(-1):setNumInputDims(n); without numInputDims Torch7 would
        # flatten the batch dim too. The sample rank is the last input's
        # (batch excluded); the container's spatial heuristic is only a
        # fallback for a Flatten that has not run yet.
        rank = getattr(m, "_input_rank", None)
        if rank is None:
            rank = getattr(m, "_t7_sample_rank", None)
        if rank is None or rank < 1:
            raise ValueError(
                "saveTorch: cannot derive Flatten's per-sample rank — "
                "build() the model on a sample input before exporting "
                "(legacy nn.View needs an explicit numInputDims)")
        return TorchObject("nn.View", {
            "size": np.asarray([-1], np.int64),
            "numElements": -1,
            "numInputDims": int(rank)})
    if isinstance(m, nn.Dropout):
        return TorchObject("nn.Dropout", {"p": float(m.p)})
    if isinstance(m, nn.CAddTable):
        return TorchObject("nn.CAddTable", {})
    if isinstance(m, nn.JoinTable):
        return TorchObject("nn.JoinTable", {"dimension": m.dimension + 1})
    simple = {nn.ReLU: "nn.ReLU", nn.Tanh: "nn.Tanh",
              nn.Sigmoid: "nn.Sigmoid", nn.LogSoftMax: "nn.LogSoftMax",
              nn.SoftMax: "nn.SoftMax", nn.Identity: "nn.Identity"}
    for klass, name in simple.items():
        if type(m) is klass:
            return TorchObject(name, {})
    raise ValueError(
        f"saveTorch: no legacy-nn mapping for {type(m).__name__}")


def _tree_leaves(tree):
    """The arrays of a dict/list/tuple tree of tensors or arrays, dict keys
    sorted, ``None`` skipped (the reference's ``tree_leaves`` order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _tree_leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def save_torch(module, path, overwrite=False):
    """Write a module as a legacy-torch ``nn.*`` object graph that Torch7
    (and ``load_torch``) can read (reference ``AbstractModule.saveTorch``,
    ``utils/TorchFile.scala:67``). Raw tensors and trees of them (a
    ``state_dict``) are written as a plain t7 table of their leaves."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    if isinstance(module, torch.nn.Module):
        write_t7(path, _from_module(module))
        return
    write_t7(path, {i + 1: v for i, v in enumerate(_tree_leaves(module))})
