"""The native model format, ``bigdl_tpu.module.v2``, both ways (the port of
``bigdl_tpu/utils/serializer.py``, reference
``utils/serializer/ModuleSerializer.scala:33``).

A model file is one protobuf-wire message (``utils/protowire.py``, no
pickle, no zip): the magic, the architecture as a tree of typed attribute
values, the weights as the reference's ``params``/``state`` pytrees at the
root, and a table of tensors deduplicated by identity (or, with
``weight_path``, a sidecar file holding that table). Files of either
package load in the other.

The architecture names the reference's classes (``bigdl_tpu.<module>:
<Class>``) with the reference's attribute set for each (its constructor
values, init methods, regularizers, ``name``, ``train_mode``, ``_frozen``,
``_scale_w``, ``_scale_b``, ``_times``; its runtime fields None), because
the reference's loader builds every object from such a record. Loading
goes the other way through explicit tables, never an import of a name
from the file:

- the layer table (:class:`NativeSpec` entries): every port module class
  of ``nn``, ``ops``, ``models``, ``interop.tf_loader`` and
  ``parallel.sequence`` under the reference's name for it, the port's
  module path with ``bigdl_tpu_torch`` read as ``bigdl_tpu``, except the
  few classes the reference has none of (``_PORT_ONLY``). Where a class
  keeps its constructor's values under their own names, the generic entry
  writes them, its other public attributes and its children, and builds
  the class through its constructor, then sets the rest (as the
  reference's loader sets an object's attributes). Where it does not, an
  entry of :func:`_nn_table` says how; a model owns its entries (its
  class's ``native_spec()``), so this module names no model class;
- ``_plain_table()``: the init methods, the regularizers and
  ``Proposal``'s ``Anchor``, plain objects whose attributes the two
  packages share;
- the function table: the ``_FUNC``/``_CLASS`` values naming ``jax`` or
  reference functions (a recurrent cell's activation, a TF graph's
  comparison) and the port's function for each (a ``_DTYPE`` names a
  numpy or torch type).

A name on none of them raises, naming it, as the reference's ``_resolve``
refuses a name outside its roots and its encoder a value it cannot write.

Weights go in and out through ``convert`` (``module_params_to_jax`` and
``module_params_from_jax``, or an entry's own ``trees``/``load_trees``) in
the reference's layout, each tensor keeping its type; a module's
constructor gets the file's floating type where the file holds one other
than float32. A ``Graph``'s params are keyed by node id, as the
reference's; a loaded graph's nodes keep the file's ids. A model that the
reference builds as another module (the port's ``ResNet``, a ``Graph`` in
the reference) is written in that form by its entry's ``form``, which
records how to build the model back; it loads back as the model.

Objects and messages nest as deep as the model does (a graph's chain of
nodes), so the encoder and decoder walk them on stacks of their own
(:func:`_run`, and ``protowire``'s), never by Python recursion.

``load_module(path, weight_path=None, device=None)`` builds the model on
the card unless ``device`` names another (``"cpu"``). A model file that a
sharded checkpoint wrote (its root carries ``_sharded_weights_marker``)
is refused once its shard files are gone (:func:`_check_sharded_marker`).
Paths go through ``utils/fileio.py``, so a registered ``scheme://``
filesystem serves them.
"""

from __future__ import annotations

import inspect
import logging
import types

import numpy as np
import torch

from bigdl_tpu_torch.utils import protowire

MAGIC = "bigdl_tpu.module.v2"
WEIGHTS_MAGIC = "bigdl_tpu.weights.v2"

# AttrValue kinds
_NONE, _BOOL, _INT, _FLOAT, _STRING, _BYTES = 0, 1, 2, 3, 4, 5
_LIST, _TUPLE, _DICT, _TABLE, _OBJ, _REF = 6, 7, 8, 9, 10, 11
_TENSOR, _FUNC, _CLASS, _DTYPE, _SET = 12, 13, 14, 15, 16

# ---------------------------------------------------------------- schemas
ATTR_VALUE: dict = {}
ATTR_ENTRY = {
    1: ("key", ("msg", ATTR_VALUE)),
    2: ("value", ("msg", ATTR_VALUE)),
}
ATTR_VALUE.update({
    1: ("kind", "int"),
    2: ("i", "int"),
    3: ("f", "double"),
    4: ("s", "string"),
    5: ("raw", "bytes"),
    6: ("items[]", ("msg", ATTR_VALUE)),
    7: ("entries[]", ("msg", ATTR_ENTRY)),
})
TENSOR_STORAGE = {
    1: ("id", "int"),
    2: ("dtype", "string"),
    3: ("shape[]", "int"),
    4: ("data", "bytes"),
}
MODEL_FILE = {
    1: ("magic", "string"),
    2: ("module", ("msg", ATTR_VALUE)),
    3: ("params", ("msg", ATTR_VALUE)),
    4: ("state", ("msg", ATTR_VALUE)),
    5: ("tensors[]", ("msg", TENSOR_STORAGE)),
    6: ("weights_file", "string"),
}
WEIGHTS_FILE = {
    1: ("magic", "string"),
    2: ("tensors[]", ("msg", TENSOR_STORAGE)),
}

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class _Rec:
    """A decoded object record: the reference's class name and its
    attributes (children still records). A record the port writes for a
    reference object it holds no module for (``Maxout``'s ``Linear``)
    is one too."""

    __slots__ = ("name", "attrs")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def __repr__(self):
        return f"_Rec({self.name})"


def _module_attrs(name, **own):
    """The reference's ``Module.__init__`` attributes, runtime fields None
    as ``Module.__getstate__`` leaves them, then the class's own."""
    return {"name": name, "params": None, "state": None,
            "grad_params": None, "output": None, "grad_input": None,
            "train_mode": True, "_frozen": False, "_vjp_fn": None,
            "_scale_w": 1.0, "_scale_b": 1.0,
            "_times": {"forward_s": 0.0, "backward_s": 0.0, "count": 0},
            **own}


# ------------------------------------------------------------ plain tables
def _plain_table():
    from bigdl_tpu_torch.nn import init_methods as im
    from bigdl_tpu_torch.optim import regularizer as rg
    out = {f"bigdl_tpu.nn.init_methods:{c}": getattr(im, c)
           for c in ("Zeros", "Ones", "ConstInitMethod", "RandomUniform",
                     "RandomNormal", "Xavier", "MsraFiller",
                     "BilinearFiller")}
    out.update({f"bigdl_tpu.optim.regularizer:{c}": getattr(rg, c)
                for c in ("L1Regularizer", "L2Regularizer",
                          "L1L2Regularizer")})
    from bigdl_tpu_torch.nn.detection import Anchor
    out["bigdl_tpu.nn.detection:Anchor"] = Anchor
    return out


def _func_table():
    """The functions a record may name and the port's stand-ins: a
    recurrent cell's activation, and the comparisons and divisions a TF
    graph closes over a constant operand (``interop/tf_loader.py``
    ``_ConstBinary``) under the reference's names for them."""
    from bigdl_tpu_torch.ops import tf_ops
    return {"jax.numpy:tanh": torch.tanh, "jax.nn:sigmoid": torch.sigmoid,
            "jax.nn:relu": torch.relu,
            "jax.numpy:equal": torch.eq, "jax.numpy:not_equal": torch.ne,
            "jax.numpy:greater": torch.gt,
            "jax.numpy:greater_equal": torch.ge,
            "jax.numpy:less": torch.lt, "jax.numpy:less_equal": torch.le,
            "jax.numpy:logical_and": torch.logical_and,
            "jax.numpy:logical_or": torch.logical_or,
            "jax.numpy:floor_divide": tf_ops._floor_div,
            "jax.numpy:mod": torch.remainder,
            "bigdl_tpu.ops.tf_ops:_truncate_div": tf_ops._truncate_div,
            "bigdl_tpu.ops.tf_ops:_truncate_mod": tf_ops._truncate_mod}


def _resolve_func(name):
    funcs = _tables()["funcs"]
    if name not in funcs:
        raise ValueError(f"refusing to load {name!r} from model file: not "
                         "a function or type the port maps")
    return funcs[name]


def _dtype_value(name):
    try:
        return np.dtype(name)
    except TypeError:
        if name in _TORCH_DTYPES:
            return _TORCH_DTYPES[name]
        raise ValueError(f"refusing to load dtype {name!r} from model "
                         "file") from None


# ------------------------------------------------------------ layer table
# the keys every record carries (``_module_attrs``), restored by the builder
_MODULE_KEYS = frozenset(_module_attrs("")) | {"_sharded_weights_marker"}


class NativeSpec:
    """How one reference class is written and built (module docstring).

    ``ref``: the reference's ``module:Class``; ``cls``: the port's class.
    ``attrs``: the reference's own attributes of the class, in its order
    (a space-separated string), or None for the generic record: the
    constructor's values (``args`` maps a constructor argument to the
    attribute that keeps it, where the names differ), the other public
    attributes and the children. ``extra``: attributes the port does not
    keep, each with a function of the module giving the reference's
    default; ``get``: the port's way to any other attribute that is not
    the same-named attribute of its module; ``optional``: attributes
    written where the module has them and set again on load. ``build(a,
    make, at)``: the port's module from the record's attributes ``a``
    (``make`` builds a child record; ``at.device``, ``at.dtype`` where to
    build); default: through the constructor. ``trees(module,
    state_dict)`` / ``load_trees(module, params, state)``: the weights
    in the reference's layout and back (a state_dict), where
    ``convert``'s walk does not give them. ``form(module, state_dict)``:
    the ``(module, state_dict)`` written in this class's place, and
    ``from_form(written, form, at)`` the class built back from it (the
    written module carries ``form``, a dict, as ``_native_form``).
    ``write_only``: the class is written under a name another class
    loads as."""

    def __init__(self, ref, cls, attrs=None, extra=None, get=None,
                 build=None, name=None, optional="", args=None,
                 trees=None, load_trees=None, form=None, from_form=None,
                 write_only=False):
        self.ref = ref
        self.cls = cls
        self.name = name
        self.attrs = None if attrs is None else tuple(attrs.split())
        self.extra = extra or {}
        self.get = get or {}
        self.optional = tuple(optional.split())
        self.args = args or {}
        self.build = build or (self._construct if attrs is not None
                               else self._generic_build)
        self.trees = trees
        self.load_trees = load_trees
        self.form = form
        self.from_form = from_form
        self.write_only = write_only

    def record(self, m):
        a = _module_attrs(self.name or _name_of(m),
                          train_mode=bool(m.training),
                          _frozen=bool(getattr(m, "_frozen", False)),
                          _scale_w=getattr(m, "_scale_w", 1.0),
                          _scale_b=getattr(m, "_scale_b", 1.0))
        if self.attrs is None:
            a.update(self._generic_attrs(m))
        native = getattr(m, "_native_attrs", {})
        for k in self.attrs or ():
            if k in self.get:
                a[k] = self.get[k](m)
            elif k in self.extra:
                a[k] = native[k] if k in native else self.extra[k](m)
            else:
                a[k] = getattr(m, k)
        for k in self.optional:
            if hasattr(m, k):
                a[k] = getattr(m, k)
        return a

    def _generic_attrs(self, m):
        own = vars(m)
        children = dict(m.named_children())
        a = {}
        for p, required in _ctor_params(self.cls):
            src = self.args.get(p, p)
            if p in self.get:
                a[p] = self.get[p](m)
            elif src in own or src in children:
                a[src] = own[src] if src in own else children[src]
            elif required:
                raise TypeError(
                    f"cannot serialize {type(m).__name__}: it keeps no "
                    f"attribute for its constructor argument {p!r}; its "
                    "layer table entry must say where the value lives")
        for k, v in list(own.items()) + list(children.items()):
            if not k.startswith("_") and k != "training" \
                    and k not in _MODULE_KEYS:
                a.setdefault(k, v)
        return a

    def _generic_build(self, a, make, at):
        kw, used = {}, set()
        for p, _ in _ctor_params(self.cls):
            src = self.args.get(p, p)
            if src in a:
                kw[p] = make(a[src])
                used.add(src)
        m = _call(self.cls, kw, at)
        for k, v in a.items():
            if k not in used and k not in _MODULE_KEYS \
                    and k not in self.optional:
                v = make(v)
                setattr(m, k, v.to(at.device)
                        if isinstance(v, torch.Tensor) else v)
        return m

    def _construct(self, a, make, at):
        return _call(self.cls, {k: make(v) for k, v in a.items()}, at)


def built_inside(owner):
    """A ``build`` for a part that loads only inside its ``owner`` (whose
    own build reads the part's record)."""
    def build(a, make, at):
        raise ValueError(f"{a.get('name')!r}: this part loads only inside "
                         f"its {owner}")
    return build


def _ctor_params(cls):
    """``(name, required)`` of the constructor arguments a record carries
    (not ``device``, which the load chooses; ``dtype`` where the module
    keeps one)."""
    out = []
    for n, p in inspect.signature(cls.__init__).parameters.items():
        if n in ("self", "device") or p.kind in (
                p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        out.append((n, p.default is p.empty))
    return out


def _call(cls, kwargs, at):
    """``cls`` with the keyword arguments its constructor names, on
    ``at.device``, and in ``at.dtype`` where the file gives one."""
    names = inspect.signature(cls.__init__).parameters
    kw = {k: v for k, v in kwargs.items() if k in names}
    if "device" in names:
        kw["device"] = at.device
    if "dtype" in names and "dtype" not in kw and at.dtype is not None:
        kw["dtype"] = at.dtype
    return cls(**kw)


def _name_of(m):
    get = getattr(m, "get_name", None)
    return get() if get is not None else type(m).__name__


def _with_bias(m):
    return m.bias is not None


def _init(name, **attrs):
    """A default init method's record, as the reference's constructors
    make them."""
    return lambda m: _Rec(f"bigdl_tpu.nn.init_methods:{name}", dict(attrs))


def _linear_rec(input_size, output_size, with_bias):
    """The reference's ``Linear`` record (``Maxout``'s inner map)."""
    return _Rec("bigdl_tpu.nn.linear:Linear", _module_attrs(
        "Linear", input_size=input_size, output_size=output_size,
        with_bias=with_bias, w_regularizer=None, b_regularizer=None,
        weight_init=_init("RandomUniform", lower=None, upper=None)(None),
        bias_init=_init("RandomUniform", lower=None, upper=None)(None)))


_XAVIER_ZEROS = {"weight_init": _init("Xavier"), "bias_init": _init("Zeros")}
_CONV_GEOMETRY = ("n_input_plane n_output_plane kernel_w kernel_h stride_w "
                  "stride_h pad_w pad_h n_group")


def _nn_table():
    """The entries of the ``nn`` classes whose record the generic one does
    not give: the reference's exact attribute set, or a constructor that
    takes other names than the module keeps."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.basic import Input as InputModule

    def ref(mod, cls):
        return f"bigdl_tpu.{mod}:{cls}"

    def children(m):
        return list(m)

    def container(cls, **kw):
        def build(a, make, at):
            c = _call(cls, {k: make(v) for k, v in a.items()
                            if k != "modules"}, at)
            for child in a["modules"]:
                c.add(make(child))
            return c
        return dict(get={"modules": children}, build=build, **kw)

    def spatial_pool(cls):
        def build(a, make, at):
            m = _call(cls, a, at)
            m.ceil_mode = a.get("ceil_mode", False)
            return m
        return build

    def bn_format(m):
        return 1 if m.feature_axis == 1 else -1

    def lstm_gru(cls):
        return NativeSpec(ref("nn.recurrent", cls), getattr(nn, cls),
                          "input_size hidden_size p w_regularizer "
                          "u_regularizer b_regularizer")

    def dilated_conv(a, make, at):
        return nn.SpatialDilatedConvolution(
            a["n_input_plane"], a["n_output_plane"], a["kernel_w"],
            a["kernel_h"], a["stride_w"], a["stride_h"], a["pad_w"],
            a["pad_h"], a["dilation_w"], a["dilation_h"],
            n_group=a["n_group"], w_regularizer=make(a["w_regularizer"]),
            b_regularizer=make(a["b_regularizer"]), with_bias=a["with_bias"],
            format=a["format"], device=at.device)

    def conv_src(m):
        """The float convolution a quantised one was made from, as the
        reference keeps it (``_src``): its geometry, no weights."""
        return _Rec("bigdl_tpu.nn.conv:SpatialConvolution", _module_attrs(
            "SpatialConvolution", propagate_back=True, w_regularizer=None,
            b_regularizer=None, with_bias=_with_bias(m),
            weight_init=_XAVIER_ZEROS["weight_init"](m),
            bias_init=_XAVIER_ZEROS["bias_init"](m),
            **{k: getattr(m, k) for k in (_CONV_GEOMETRY + " format "
                                          "dilation_w dilation_h").split()}))

    def quantized_conv(cls):
        def build(a, make, at):
            src = make(a["_src"])
            return cls(src.to(at.device))
        return NativeSpec(ref("nn.quantized", cls.__name__), cls,
                          _CONV_GEOMETRY + " with_bias format dilation_w "
                          "dilation_h _src",
                          get={"with_bias": _with_bias, "_src": conv_src},
                          build=build)

    conv_attrs = (_CONV_GEOMETRY + " propagate_back w_regularizer "
                  "b_regularizer with_bias format dilation_w dilation_h "
                  "weight_init bias_init")
    linear_attrs = ("input_size output_size with_bias w_regularizer "
                    "b_regularizer weight_init bias_init")
    linear_inits = {"weight_init": _init("RandomUniform", lower=None,
                                         upper=None),
                    "bias_init": _init("RandomUniform", lower=None,
                                       upper=None)}
    table = [
        *[NativeSpec(ref("nn.activation", c), getattr(nn, c), "")
          for c in ("ReLU", "Tanh", "Sigmoid", "LogSoftMax", "Identity",
                    "ReLU6", "Abs", "Exp", "Log", "Square", "Sqrt",
                    "Negative", "SoftSign")],
        NativeSpec(ref("nn.activation", "SoftMax"), nn.SoftMax, "pos"),
        NativeSpec(ref("nn.activation", "ELU"), nn.ELU, "alpha"),
        NativeSpec(ref("nn.activation", "SoftPlus"), nn.SoftPlus, "beta"),
        NativeSpec(ref("nn.activation", "PReLU"), nn.PReLU, "n_output_plane"),
        NativeSpec(ref("nn.activation", "Maxout"), nn.Maxout,
                   "maxout_number output_size linear",
                   get={"linear": lambda m: _linear_rec(
                       m.input_size, m.output_size * m.maxout_number,
                       _with_bias(m))},
                   build=lambda a, make, at: nn.Maxout(
                       a["linear"].attrs["input_size"], a["output_size"],
                       a["maxout_number"], a["linear"].attrs["with_bias"],
                       device=at.device)),
        NativeSpec(ref("nn.basic", "Dropout"), nn.Dropout, "p scale",
                   build=lambda a, make, at: nn.Dropout(a["p"],
                                                        scale=a["scale"])),
        NativeSpec(ref("nn.basic", "Reshape"), nn.Reshape, "size batch_mode"),
        NativeSpec(ref("nn.basic", "View"), nn.View, "sizes",
                   build=lambda a, make, at: nn.View(*a["sizes"])),
        NativeSpec(ref("nn.basic", "Flatten"), nn.Flatten, ""),
        NativeSpec(ref("nn.basic", "Input"), InputModule, ""),
        NativeSpec(ref("nn.basic", "CAdd"), nn.CAdd, "size"),
        NativeSpec(ref("nn.basic", "CMul"), nn.CMul, "size"),
        NativeSpec(ref("nn.basic", "Squeeze"), nn.Squeeze, "dim batch_mode"),
        NativeSpec(ref("nn.basic", "Narrow"), nn.Narrow, "dim offset length"),
        NativeSpec(ref("nn.basic", "AddConstant"), nn.AddConstant,
                   args={"constant_scalar": "constant"}),
        NativeSpec(ref("nn.basic", "SpatialZeroPadding"),
                   nn.SpatialZeroPadding,
                   args={"pad_left": "l", "pad_right": "r", "pad_top": "t",
                         "pad_bottom": "b"}),
        NativeSpec(ref("nn.containers", "Container"), nn.Container,
                   "modules", **container(nn.Container)),
        NativeSpec(ref("nn.containers", "Sequential"), nn.Sequential,
                   "modules", **container(nn.Sequential)),
        NativeSpec(ref("nn.containers", "Concat"), nn.Concat,
                   "modules dimension", **container(nn.Concat)),
        NativeSpec(ref("nn.containers", "ConcatTable"), nn.ConcatTable,
                   "modules", **container(nn.ConcatTable)),
        NativeSpec(ref("nn.containers", "ParallelTable"), nn.ParallelTable,
                   "modules", **container(nn.ParallelTable)),
        NativeSpec(ref("nn.containers", "MapTable"), nn.MapTable, "modules",
                   **container(nn.MapTable)),
        NativeSpec(ref("nn.containers", "Bottle"), nn.Bottle,
                   "modules n_input_dim n_output_dim",
                   get={"modules": children},
                   build=lambda a, make, at: nn.Bottle(
                       make(a["modules"][0]), a["n_input_dim"],
                       a["n_output_dim"])),
        NativeSpec(ref("nn.conv", "SpatialConvolution"),
                   nn.SpatialConvolution, conv_attrs,
                   extra={"propagate_back": lambda m: True, **_XAVIER_ZEROS},
                   get={"with_bias": _with_bias}),
        NativeSpec(ref("nn.conv", "SpatialDilatedConvolution"),
                   nn.SpatialDilatedConvolution, conv_attrs,
                   extra={"propagate_back": lambda m: True, **_XAVIER_ZEROS},
                   get={"with_bias": _with_bias},
                   build=dilated_conv),
        NativeSpec(ref("nn.conv", "SpatialFullConvolution"),
                   nn.SpatialFullConvolution,
                   _CONV_GEOMETRY.replace("n_group", "adj_w adj_h n_group")
                   + " with_bias format w_regularizer b_regularizer "
                   "weight_init bias_init",
                   extra=_XAVIER_ZEROS, get={"with_bias": _with_bias},
                   build=lambda a, make, at: nn.SpatialFullConvolution(
                       a["n_input_plane"], a["n_output_plane"],
                       a["kernel_w"], a["kernel_h"], a["stride_w"],
                       a["stride_h"], a["pad_w"], a["pad_h"], a["adj_w"],
                       a["adj_h"], a["n_group"], no_bias=not a["with_bias"],
                       w_regularizer=make(a["w_regularizer"]),
                       b_regularizer=make(a["b_regularizer"]),
                       format=a["format"], device=at.device)),
        NativeSpec(ref("nn.conv", "VolumetricConvolution"),
                   nn.VolumetricConvolution,
                   "n_input_plane n_output_plane k stride pad with_bias "
                   "format weight_init bias_init", extra=_XAVIER_ZEROS,
                   get={"with_bias": _with_bias},
                   build=lambda a, make, at: nn.VolumetricConvolution(
                       a["n_input_plane"], a["n_output_plane"], a["k"][0],
                       a["k"][2], a["k"][1], a["stride"][0],
                       a["stride"][2], a["stride"][1], a["pad"][0],
                       a["pad"][2], a["pad"][1], a["with_bias"],
                       a["format"], device=at.device)),
        NativeSpec(ref("nn.conv", "VolumetricFullConvolution"),
                   nn.VolumetricFullConvolution,
                   "n_input_plane n_output_plane k stride pad adj with_bias "
                   "w_regularizer b_regularizer weight_init bias_init",
                   extra=_XAVIER_ZEROS, get={"with_bias": _with_bias},
                   build=lambda a, make, at: nn.VolumetricFullConvolution(
                       a["n_input_plane"], a["n_output_plane"], a["k"][0],
                       a["k"][2], a["k"][1], a["stride"][0],
                       a["stride"][2], a["stride"][1], a["pad"][0],
                       a["pad"][2], a["pad"][1], a["adj"][0], a["adj"][2],
                       a["adj"][1], no_bias=not a["with_bias"],
                       w_regularizer=make(a["w_regularizer"]),
                       b_regularizer=make(a["b_regularizer"]),
                       device=at.device)),
        NativeSpec(ref("nn.conv", "TemporalConvolution"),
                   nn.TemporalConvolution,
                   "input_frame_size output_frame_size kernel_w stride_w "
                   "dilation with_bias weight_init bias_init w_regularizer "
                   "b_regularizer", extra=_XAVIER_ZEROS,
                   get={"with_bias": _with_bias}),
        NativeSpec(ref("nn.embedding", "LookupTable"), nn.LookupTable,
                   "n_index n_output padding_value max_norm norm_type "
                   "w_regularizer weight_init",
                   extra={"weight_init": _init("RandomNormal", mean=0.0,
                                               stdv=1.0)}),
        NativeSpec(ref("nn.linear", "Linear"), nn.Linear, linear_attrs,
                   extra=linear_inits, get={"with_bias": _with_bias}),
        # an int8 Linear is the reference's Linear with a quantised weight
        # leaf; only a model's own load_trees puts one back
        NativeSpec(ref("nn.linear", "Linear"), nn.Int8Linear, linear_attrs,
                   extra={"w_regularizer": lambda m: None,
                          "b_regularizer": lambda m: None, **linear_inits},
                   get={"with_bias": _with_bias}, write_only=True),
        NativeSpec(ref("nn.locally_connected", "LocallyConnected1D"),
                   nn.LocallyConnected1D,
                   "n_input_frame input_frame_size output_frame_size "
                   "kernel_w stride_w with_bias w_regularizer b_regularizer "
                   "weight_init bias_init", extra=_XAVIER_ZEROS,
                   get={"with_bias": _with_bias}),
        NativeSpec(ref("nn.locally_connected", "LocallyConnected2D"),
                   nn.LocallyConnected2D,
                   "n_input_plane input_height input_width n_output_plane "
                   "kernel_w kernel_h stride_w stride_h pad_w pad_h "
                   "with_bias w_regularizer b_regularizer weight_init "
                   "bias_init format", extra=_XAVIER_ZEROS,
                   get={"with_bias": _with_bias}),
        NativeSpec(ref("nn.normalization", "BatchNormalization"),
                   nn.BatchNormalization, "n_output eps momentum affine"),
        NativeSpec(ref("nn.normalization", "SpatialBatchNormalization"),
                   nn.SpatialBatchNormalization,
                   "n_output eps momentum affine _feature_axis",
                   get={"_feature_axis": bn_format},
                   build=lambda a, make, at: nn.SpatialBatchNormalization(
                       a["n_output"], a["eps"], a["momentum"], a["affine"],
                       format="NCHW" if a.get("_feature_axis", 1) == 1
                       else "NHWC", device=at.device)),
        NativeSpec(ref("nn.normalization", "VolumetricBatchNormalization"),
                   nn.VolumetricBatchNormalization,
                   "n_output eps momentum affine"),
        NativeSpec(ref("nn.normalization", "LayerNormalization"),
                   nn.LayerNormalization, "hidden_size eps"),
        NativeSpec(ref("nn.normalization", "SpatialCrossMapLRN"),
                   nn.SpatialCrossMapLRN, "size alpha beta k format"),
        NativeSpec(ref("nn.pooling", "SpatialMaxPooling"),
                   nn.SpatialMaxPooling,
                   "kw kh dw dh pad_w pad_h format ceil_mode global_pooling",
                   build=spatial_pool(nn.SpatialMaxPooling)),
        NativeSpec(ref("nn.pooling", "SpatialAveragePooling"),
                   nn.SpatialAveragePooling,
                   "kw kh dw dh pad_w pad_h format ceil_mode global_pooling "
                   "count_include_pad divide",
                   build=spatial_pool(nn.SpatialAveragePooling)),
        NativeSpec(ref("nn.pooling", "VolumetricMaxPooling"),
                   nn.VolumetricMaxPooling, "k s pad",
                   build=lambda a, make, at: nn.VolumetricMaxPooling(
                       a["k"][0], a["k"][2], a["k"][1], a["s"][0],
                       a["s"][2], a["s"][1], a["pad"][0], a["pad"][2],
                       a["pad"][1])),
        NativeSpec(ref("nn.pooling", "VolumetricAveragePooling"),
                   nn.VolumetricAveragePooling, "k s pad count_include_pad",
                   build=lambda a, make, at: nn.VolumetricAveragePooling(
                       a["k"][0], a["k"][2], a["k"][1], a["s"][0],
                       a["s"][2], a["s"][1], a["pad"][0], a["pad"][2],
                       a["pad"][1], a["count_include_pad"])),
        NativeSpec(ref("nn.pooling", "TemporalMaxPooling"),
                   nn.TemporalMaxPooling, "k_w d_w"),
        NativeSpec(ref("nn.quantized", "QuantizedLinear"),
                   nn.QuantizedLinear, "input_size output_size with_bias",
                   get={"with_bias": _with_bias}),
        quantized_conv(nn.QuantizedSpatialConvolution),
        quantized_conv(nn.QuantizedSpatialDilatedConvolution),
        NativeSpec(ref("nn.recurrent", "Recurrent"), nn.Recurrent, "cell",
                   build=lambda a, make, at: nn.Recurrent(make(a["cell"]))),
        NativeSpec(ref("nn.recurrent", "BiRecurrent"), nn.BiRecurrent,
                   get={"cell": lambda m: m.fwd.cell}),
        lstm_gru("LSTM"),
        lstm_gru("GRU"),
        NativeSpec(ref("nn.recurrent", "RnnCell"), nn.RnnCell,
                   "input_size hidden_size activation w_regularizer "
                   "u_regularizer b_regularizer"),
        NativeSpec(ref("nn.recurrent", "MultiRNNCell"), nn.MultiRNNCell,
                   "cells hidden_size"),
        NativeSpec(ref("nn.recurrent", "TimeDistributed"), nn.TimeDistributed,
                   "module"),
        *[NativeSpec(ref("nn.table_ops", c), getattr(nn, c), "")
          for c in ("CAddTable", "CMulTable", "CSubTable", "CDivTable",
                    "CMaxTable", "CMinTable")],
        NativeSpec(ref("nn.misc", "Highway"), nn.Highway,
                   "size with_bias activation",
                   get={"with_bias": lambda m: m.b_t is not None}),
        NativeSpec(ref("nn.graph", "Graph"), nn.Graph,
                   "input_nodes output_nodes exec_order",
                   optional="_native_form _tf_used_inputs",
                   build=_build_graph),
        NativeSpec(ref("nn.linear", "Cosine"), nn.Cosine,
                   "input_size output_size weight_init",
                   extra={"weight_init": _init("Xavier")}),
        NativeSpec(ref("nn.linear", "Euclidean"), nn.Euclidean,
                   "input_size output_size fast_backward weight_init",
                   extra={"weight_init": _init("Xavier")}),
        NativeSpec(ref("nn.linear", "Bilinear"), nn.Bilinear,
                   "input_size1 input_size2 output_size with_bias "
                   "weight_init bias_init w_regularizer b_regularizer",
                   extra=_XAVIER_ZEROS, get={"with_bias": _with_bias},
                   build=lambda a, make, at: nn.Bilinear(
                       a["input_size1"], a["input_size2"], a["output_size"],
                       a["with_bias"], make(a["w_regularizer"]),
                       make(a["b_regularizer"]), device=at.device)),
        # the expanded aspect ratios are kept: built back as they are, not
        # expanded (and flipped) again
        NativeSpec(ref("nn.detection", "PriorBox"), nn.PriorBox,
                   "min_sizes max_sizes aspect_ratios clip variances offset "
                   "img_h img_w step_h step_w num_priors",
                   build=_restored(lambda a: nn.PriorBox(a["min_sizes"]))),
        NativeSpec(ref("nn.detection", "Proposal"), nn.Proposal,
                   "pre_nms_topn post_nms_topn pre_nms_topn_train "
                   "post_nms_topn_train anchor min_size nms_thresh",
                   build=_restored(lambda a: nn.Proposal(
                       a["pre_nms_topn"], a["post_nms_topn"],
                       np.asarray(a["anchor"].attrs["ratios"]),
                       np.asarray(a["anchor"].attrs["scales"])))),
    ]
    return table


def _restored(make_default):
    """A ``build`` that makes the class from a few of the record's
    values (``make_default(a)``) and then sets every attribute the record
    holds, as the reference's loader does."""
    def build(a, make, at):
        m = make_default(a)
        for k, v in a.items():
            if k not in _MODULE_KEYS:
                setattr(m, k, make(v))
        return m
    return build


# port classes the reference has no class of: private bases and parts, and
# the tensor-parallel shards (save the model they shard)
_PORT_ONLY = frozenset({
    "nn.embedding:_Table", "nn.locally_connected:_Untied",
    "nn.pooling:_Pool3D", "nn.quantized:_Quantized", "ops.tf_ops:_Reduce",
    "parallel.tensor_parallel:TensorParallelCausalLM",
    "parallel.tensor_parallel:TensorParallelGPT"})

# the port modules whose classes the layer table holds, besides ``nn``'s
_MODULES = ("bigdl_tpu_torch.nn", "bigdl_tpu_torch.ops.tf_ops",
            "bigdl_tpu_torch.ops.control_ops", "bigdl_tpu_torch.models.gpt",
            "bigdl_tpu_torch.models.resnet",
            "bigdl_tpu_torch.models.transformer",
            "bigdl_tpu_torch.interop.tf_loader",
            "bigdl_tpu_torch.parallel.sequence")


def _port_classes():
    """Every port module class of :data:`_MODULES` (``nn``'s submodules
    included), in a fixed order."""
    import importlib
    mods = {importlib.import_module(m).__name__ for m in _MODULES}
    seen, todo = set(), [torch.nn.Module]
    while todo:
        for c in todo.pop().__subclasses__():
            if c not in seen:
                seen.add(c)
                todo.append(c)
    return sorted((c for c in seen if c.__module__ in mods
                   or c.__module__.startswith("bigdl_tpu_torch.nn.")),
                  key=lambda c: (c.__module__, c.__qualname__))


def _reference_name(cls):
    return (cls.__module__.replace("bigdl_tpu_torch.", "bigdl_tpu.", 1)
            + ":" + cls.__qualname__)


def _layer_specs():
    """Every entry: :func:`_nn_table`'s, each model class's own
    (``native_spec()``), and the generic one of every other class."""
    specs = {s.cls: s for s in _nn_table()}
    for cls in _port_classes():
        own = cls.__dict__.get("native_spec")
        if own is not None:
            specs[cls] = own.__get__(None, cls)()
        elif cls not in specs and _reference_name(cls).split(
                "bigdl_tpu.", 1)[1] not in _PORT_ONLY:
            specs[cls] = NativeSpec(_reference_name(cls), cls)
    return list(specs.values())


def _build_graph(a, make, at):
    from bigdl_tpu_torch.nn import Graph
    inputs = [make(n) for n in a["input_nodes"]]
    outputs = [make(n) for n in a["output_nodes"]]
    return Graph(inputs, outputs, device=at.device)


def _build_node(rec, make):
    """A ``Node`` record as the port's node, keeping the file's id (the
    graph's params are keyed by it); later nodes count on from it."""
    from bigdl_tpu_torch.nn.module import Node
    node = Node.__new__(Node)
    node.id = int(rec.attrs["id"])
    Node._counter[0] = max(Node._counter[0], node.id)
    node.module = make(rec.attrs["module"])
    node.prev_nodes = []
    return node, lambda: node.prev_nodes.extend(
        make(p) for p in rec.attrs["prev_nodes"])


_TABLES = None


def _tables():
    """The tables, built at the first save or load (a checkpoint writer's
    thread may be first: the whole dict is published at once)."""
    global _TABLES
    if _TABLES is None:
        specs = _layer_specs()
        plain, funcs = _plain_table(), _func_table()
        func_names = {}
        for name, fn in funcs.items():
            func_names.setdefault(id(fn), name)
        _TABLES = {"layers": {s.ref: s for s in specs if not s.write_only},
                   "by_class": {s.cls: s for s in specs},
                   "plain": plain,
                   "plain_names": {c: n for n, c in plain.items()},
                   "funcs": funcs, "func_names": func_names}
    return _TABLES


def _run(gen):
    """The value of generator ``gen``, whose ``x = yield g`` runs generator
    ``g`` and gets its value: recursion on a stack of our own, as deep as
    the data nests."""
    stack, sent = [gen], None
    while True:
        try:
            sub = stack[-1].send(sent)
        except StopIteration as stop:
            stack.pop()
            if not stack:
                return stop.value
            sent = stop.value
        else:
            stack.append(sub)
            sent = None


# ------------------------------------------------------------- encoding
class _Encoder:
    def __init__(self):
        self.obj_ids = {}     # id(obj) -> assigned id (back-references)
        self.tensor_ids = {}  # id(tensor) -> tensor id (shared storage)
        self.tensors = []     # TensorStorage dicts
        self._keepalive = []  # ensure id() keys stay unique while encoding

    def tensor(self, t):
        key = id(t)
        if key in self.tensor_ids:
            return self.tensor_ids[key]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        c = t.detach().cpu().contiguous()
        tid = len(self.tensors)
        self.tensors.append({
            "id": tid, "dtype": _DTYPE_NAMES[c.dtype],
            "shape": list(c.shape),
            "data": c.reshape(-1).view(torch.uint8).numpy().tobytes()})
        self.tensor_ids[key] = tid
        self._keepalive.append(t)
        return tid

    def encode(self, v):
        return _run(self.value(v))

    def value(self, v):
        from bigdl_tpu_torch.utils.table import Table, sorted_items
        if v is None:
            return {"kind": _NONE}
        if isinstance(v, (bool, np.bool_)):
            return {"kind": _BOOL, "i": int(v)}
        if isinstance(v, (int, np.integer)):
            return {"kind": _INT, "i": int(v)}
        if isinstance(v, (float, np.floating)):
            return {"kind": _FLOAT, "f": float(v)}
        if isinstance(v, str):
            return {"kind": _STRING, "s": v}
        if isinstance(v, (bytes, bytearray)):
            return {"kind": _BYTES, "raw": bytes(v)}
        if isinstance(v, (torch.Tensor, np.ndarray)):
            return {"kind": _TENSOR, "i": self.tensor(v)}
        if isinstance(v, np.dtype):
            return {"kind": _DTYPE, "s": v.name}
        if isinstance(v, torch.dtype):
            return {"kind": _DTYPE, "s": _DTYPE_NAMES[v]}
        if isinstance(v, (list, tuple, set, frozenset)):
            kind = (_LIST if isinstance(v, list) else
                    _TUPLE if isinstance(v, tuple) else _SET)
            items = []
            for x in (sorted(v, key=repr) if kind == _SET else v):
                items.append((yield self.value(x)))
            return {"kind": kind, "items": items}
        if isinstance(v, (Table, dict)):
            entries = []
            for k, x in (sorted_items(v) if isinstance(v, Table)
                         else v.items()):
                entries.append({"key": (yield self.value(k)),
                                "value": (yield self.value(x))})
            return {"kind": _TABLE if isinstance(v, Table) else _DICT,
                    "entries": entries}
        names = _tables()["func_names"]
        if id(v) in names:
            return {"kind": _FUNC, "s": names[id(v)]}
        return (yield self.obj(v))

    def obj(self, v):
        key = id(v)
        if key in self.obj_ids:
            return {"kind": _REF, "i": self.obj_ids[key]}
        name, attrs = _describe(v)
        oid = len(self.obj_ids)
        self.obj_ids[key] = oid
        self._keepalive.append(v)
        entries = []
        for k, x in attrs.items():
            entries.append({"key": (yield self.value(k)),
                            "value": (yield self.value(x))})
        return {"kind": _OBJ, "i": oid, "s": name, "entries": entries}


def _describe(v):
    """``(reference class name, attributes)`` of a value the encoder
    writes as an object record."""
    from bigdl_tpu_torch.nn.module import Node
    t = _tables()
    if isinstance(v, _Rec):
        return v.name, v.attrs
    if isinstance(v, Node):
        return "bigdl_tpu.nn.graph:Node", {
            "module": v.module, "prev_nodes": list(v.prev_nodes),
            "id": int(v.id)}
    spec = t["by_class"].get(type(v))
    if spec is not None and spec.form is None:
        attrs = spec.record(v)
        marker = getattr(v, "_sharded_weights_marker", None)
        if marker is not None:
            attrs["_sharded_weights_marker"] = marker
        return spec.ref, attrs
    if type(v) in t["plain_names"]:
        return t["plain_names"][type(v)], dict(v.__dict__)
    if isinstance(v, (types.FunctionType, types.BuiltinFunctionType)):
        raise TypeError(
            f"cannot serialize function {v!r} in the native model format: "
            "the port writes the functions its table names")
    raise TypeError(
        f"cannot serialize {type(v).__name__!r} value {v!r} in the native "
        "model format: the port writes the classes its tables cover")


# ---------------------------------------------------------------- trees
def _keyed_by_node(module, tree):
    """``convert``'s lists of a graph's params (one a node in execution
    order) keyed by node id, as the reference keys them, through nested
    containers."""
    from bigdl_tpu_torch.nn import Bottle, Container, Graph, MapTable
    if isinstance(module, Graph) and isinstance(tree, list):
        return {str(n.id): _keyed_by_node(n.module, p)
                for n, p in zip(module.exec_order, tree)}
    if isinstance(module, (MapTable, Bottle)):
        return _keyed_by_node(module[0], tree)
    if isinstance(module, Container) and isinstance(tree, list):
        return [_keyed_by_node(c, p) for c, p in zip(module, tree)]
    return tree


def _listed_by_node(module, tree):
    """The inverse of :func:`_keyed_by_node`."""
    from bigdl_tpu_torch.nn import Bottle, Container, Graph, MapTable
    if isinstance(module, Graph) and isinstance(tree, dict):
        return [_listed_by_node(n.module, tree[str(n.id)])
                for n in module.exec_order]
    if isinstance(module, (MapTable, Bottle)):
        return _listed_by_node(module[0], tree)
    if isinstance(module, Container) and isinstance(tree, (list, tuple)):
        return [_listed_by_node(c, p) for c, p in zip(module, tree)]
    return tree


def _count_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return 1
    if isinstance(tree, dict):
        return sum(_count_tensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_tensors(v) for v in tree)
    return 0


def _trees(module, state_dict=None):
    """The module's ``(params, state)`` in the reference's layout, from
    ``state_dict`` where given, else from its own tensors. Raises where
    the layout would leave a tensor out (a class whose weights neither
    ``convert``'s walk nor its entry lays out)."""
    from bigdl_tpu_torch import convert
    sd = module.state_dict() if state_dict is None else state_dict
    spec = _tables()["by_class"].get(type(module))
    if spec is not None and spec.trees is not None:
        return spec.trees(module, sd)
    for m in module.modules():
        inner = _tables()["by_class"].get(type(m))
        if inner is not None and inner.write_only:
            raise TypeError(f"cannot serialize {type(m).__name__} outside "
                            "the model that loads it back")
    params, state = convert.module_params_to_jax(module, sd, tensors=True)
    if _count_tensors(params) + _count_tensors(state) != len(sd):
        raise TypeError(f"cannot serialize {type(module).__name__}'s "
                        "weights: the reference's layout of them leaves "
                        "some out")
    return _keyed_by_node(module, params), _keyed_by_node(module, state)


def _load_trees(module, params, state):
    """Load the reference-layout ``params``/``state`` into ``module``,
    keeping each tensor's type."""
    from bigdl_tpu_torch import convert
    spec = _tables()["by_class"].get(type(module))
    if spec is not None and spec.load_trees is not None:
        sd = spec.load_trees(module, params, state)
    else:
        sd = convert.module_params_from_jax(
            module, _listed_by_node(module, params),
            _listed_by_node(module, state))
    assign(module, sd)


def assign(module, sd, strict=True):
    """Copy ``sd`` into ``module``'s tensors in place (their device and
    memory order kept); a tensor of another type replaces the data, so a
    bfloat16 file gives bfloat16 parameters. ``strict``: ``sd`` must hold
    every tensor of the module and no other."""
    own = module.state_dict(keep_vars=True)
    for k in set(sd) - set(own):
        # a buffer the module holds as None until set (a quantised
        # layer's calibrated ``in_scale``)
        owner, _, leaf = k.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        if sub._buffers.get(leaf, 0) is None:
            sub._buffers[leaf] = torch.empty_like(sd[k], device=next(
                (t.device for t in own.values()), sd[k].device))
            own[k] = sub._buffers[leaf]
    missing = sorted(set(own) - set(sd)) if strict else []
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(f"model file weights do not fit the module: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for k, t in sd.items():
            dst = own[k]
            if dst.shape != t.shape:
                raise ValueError(f"model file weight {k!r} is "
                                 f"{tuple(t.shape)}, the module's "
                                 f"{tuple(dst.shape)}")
            if dst.dtype == t.dtype:
                dst.copy_(t)
            else:
                dst.data = t.to(dst.device)


# ---------------------------------------------------------------- decoding
class _Decoder:
    def __init__(self, tensors):
        self.records = {}
        self.tensors = {t["id"]: t for t in tensors}
        self._tensor_cache = {}  # keep id-based sharing on load too

    def tensor(self, tid):
        if tid not in self._tensor_cache:
            t = self.tensors[tid]
            name = t["dtype"]
            if name not in _TORCH_DTYPES:
                raise ValueError(f"refusing tensor dtype {name!r} in model "
                                 "file")
            data = bytearray(t.get("data", b""))
            flat = (torch.frombuffer(data, dtype=_TORCH_DTYPES[name])
                    if data else torch.empty(0, dtype=_TORCH_DTYPES[name]))
            self._tensor_cache[tid] = flat.reshape(tuple(t.get("shape", [])))
        return self._tensor_cache[tid]

    def decode(self, av):
        return _run(self.value(av))

    def value(self, av):
        from bigdl_tpu_torch.utils.table import Table
        kind = av.get("kind", _NONE)
        if kind == _NONE:
            return None
        if kind == _BOOL:
            return bool(av.get("i", 0))
        if kind == _INT:
            return av.get("i", 0)
        if kind == _FLOAT:
            return av.get("f", 0.0)
        if kind == _STRING:
            return av.get("s", "")
        if kind == _BYTES:
            return av.get("raw", b"")
        if kind == _TENSOR:
            return self.tensor(av.get("i", 0))
        if kind == _DTYPE:
            return _dtype_value(av["s"])
        if kind in (_LIST, _TUPLE, _SET):
            items = []
            for x in av.get("items", []):
                items.append((yield self.value(x)))
            return (items if kind == _LIST else
                    tuple(items) if kind == _TUPLE else set(items))
        if kind in (_DICT, _TABLE):
            out = Table() if kind == _TABLE else {}
            for e in av.get("entries", []):
                k = yield self.value(e["key"])
                out[k] = yield self.value(e["value"])
            return out
        if kind in (_FUNC, _CLASS):
            return _resolve_func(av["s"])
        if kind == _REF:
            return self.records[av["i"]]
        if kind == _OBJ:
            name = av["s"]
            t = _tables()
            if name not in t["layers"] and name not in t["plain"] \
                    and name != "bigdl_tpu.nn.graph:Node":
                raise ValueError(f"refusing to load {name!r} from model "
                                 "file: not a class the port maps")
            rec = _Rec(name, {})
            self.records[av["i"]] = rec  # register before attrs: cycles
            for e in av.get("entries", []):
                k = yield self.value(e["key"])
                rec.attrs[k] = yield self.value(e["value"])
            return rec
        raise ValueError(f"unknown attr kind {kind}")


class _Builder:
    """Port objects from decoded records, each record built once (shared
    submodules stay shared; graph nodes link after they all exist), on
    ``at.device`` and in ``at.dtype``."""

    def __init__(self, at):
        self.at = at
        self.built = {}
        self.links = []

    def make(self, v):
        if isinstance(v, list):
            return [self.make(x) for x in v]
        if isinstance(v, tuple):
            return tuple(self.make(x) for x in v)
        if not isinstance(v, _Rec):
            return v
        if id(v) in self.built:
            return self.built[id(v)]
        t = _tables()
        if v.name == "bigdl_tpu.nn.graph:Node":
            node, link = _build_node(v, self.make)
            self.built[id(v)] = node
            self.links.append(link)
            return node
        if v.name in t["plain"]:
            cls = t["plain"][v.name]
            obj = cls.__new__(cls)
            obj.__dict__.update({k: self.make(x) for k, x in v.attrs.items()})
            self.built[id(v)] = obj
            return obj
        spec = t["layers"][v.name]
        if spec.ref.endswith(":Graph"):
            self._link_nodes(v)
        m = spec.build(v.attrs, self.make, self.at)
        self._restore_module_attrs(m, spec, v.attrs)
        self.built[id(v)] = m
        return m

    def _link_nodes(self, graph_rec):
        """Build every node of a graph record and wire them before the
        graph sorts them."""
        for n in graph_rec.attrs.get("exec_order", []):
            self.make(n)
        while self.links:
            self.links.pop()()

    def _restore_module_attrs(self, m, spec, a):
        if hasattr(m, "set_name") and a.get("name") not in (
                None, type(m).__name__):
            m.set_name(a["name"])
        m.training = bool(a.get("train_mode", True))
        if hasattr(m, "freeze"):
            m._frozen = bool(a.get("_frozen", False))
            m._scale_w = a.get("_scale_w", 1.0)
            m._scale_b = a.get("_scale_b", 1.0)
        native = {k: a[k] for k in spec.extra if k in a}
        if native:
            m._native_attrs = native
        for k in spec.optional + ("_sharded_weights_marker",):
            if k in a:
                setattr(m, k, self.make(a[k]))


class _At:
    """Where a load builds: ``device``, and ``dtype`` (None: each
    constructor's default)."""

    def __init__(self, device, dtype=None):
        self.device = device
        self.dtype = dtype


def _file_dtype(tensors):
    """The floating type of a file's tensors where all share one other
    than float32, else None."""
    kinds = {t["dtype"] for t in tensors
             if t["dtype"] in ("float16", "bfloat16", "float32",
                               "float64")}
    return _TORCH_DTYPES[kinds.pop()] if kinds in (
        {"float16"}, {"bfloat16"}, {"float64"}) else None


# ------------------------------------------------------------- the API
def save_module(module, path, weight_path=None, overwrite=False,
                state_dict=None):
    """Write ``module`` (architecture and weights) to ``path`` in the
    native format, the tensor table to ``weight_path`` when given
    (reference ``Module.saveModule(path, weightPath)``). ``state_dict``:
    the weights to write in place of the module's own, keyed as its
    ``state_dict`` (a checkpoint's host snapshot, written while the
    module trains on)."""
    from bigdl_tpu_torch.utils.fileio import file_exists, file_open
    import os
    for p in (path, weight_path):
        if p and file_exists(p) and not overwrite:
            raise FileExistsError(f"{p} exists; pass overwrite=True")
    spec = _tables()["by_class"].get(type(module))
    if spec is not None and spec.form is not None:
        written, state_dict = spec.form(module, state_dict)
        marker = getattr(module, "_sharded_weights_marker", None)
        if marker is not None:
            written._sharded_weights_marker = marker
        module = written
    enc = _Encoder()
    msg = {"magic": MAGIC, "module": enc.encode(module)}
    params, state = _trees(module, state_dict)
    msg["params"] = enc.encode(params)
    msg["state"] = enc.encode(state)
    if weight_path:
        msg["weights_file"] = os.path.basename(str(weight_path))
        blob = protowire.encode({"magic": WEIGHTS_MAGIC,
                                 "tensors": enc.tensors}, WEIGHTS_FILE)
        with file_open(weight_path, "wb") as f:
            f.write(blob)
    else:
        msg["tensors"] = enc.tensors
    data = protowire.encode(msg, MODEL_FILE)
    with file_open(path, "wb") as f:
        f.write(data)


def _read(path, weight_path=None):
    """``(message, tensors)`` of a model file, its sidecar read where the
    file names one."""
    from bigdl_tpu_torch.utils.fileio import file_open, path_join, \
        path_dirname
    with file_open(path, "rb") as f:
        blob = f.read()
    if blob[:2] == b"PK":
        raise ValueError(
            f"{path} is a v1 (zip/pickle) bigdl_tpu model file; load it with "
            "a pre-v2 release and re-save in the current format")
    try:
        msg = protowire.decode(blob, MODEL_FILE)
    except (IndexError, ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"{path} is not a bigdl_tpu model file") from e
    if msg.get("magic") != MAGIC:
        raise ValueError(f"{path} is not a bigdl_tpu model file")
    tensors = msg.get("tensors", [])
    if not tensors and msg.get("weights_file"):
        wp = weight_path or path_join(path_dirname(path),
                                      msg["weights_file"])
        with file_open(wp, "rb") as f:
            wmsg = protowire.decode(f.read(), WEIGHTS_FILE)
        if wmsg.get("magic") != WEIGHTS_MAGIC:
            raise ValueError(f"{wp} is not a bigdl_tpu weights file")
        tensors = wmsg.get("tensors", [])
    return msg, tensors


def load_module(path, weight_path=None, device=None):
    """The module a native model file holds, its weights loaded, on
    ``device`` (default the card; ``"cpu"`` for the CPU). Reference
    ``Module.loadModule``."""
    from bigdl_tpu_torch.utils.device import resolve_device
    at = _At(resolve_device(device))
    msg, tensors = _read(path, weight_path)
    at.dtype = _file_dtype(tensors)
    dec = _Decoder(tensors)
    rec = dec.decode(msg["module"])
    if not isinstance(rec, _Rec) or rec.name not in _tables()["layers"]:
        raise ValueError(f"{path} holds no module the port maps")
    module = _Builder(at).make(rec)
    params = dec.decode(msg["params"]) if "params" in msg else ()
    state = dec.decode(msg["state"]) if "state" in msg else ()
    _load_trees(module, params, state)
    _check_sharded_marker(module, path)
    form = getattr(module, "_native_form", None)
    if isinstance(form, dict):
        owner = _tables()["layers"].get(form.get("class"))
        if owner is None or owner.from_form is None:
            raise ValueError(f"refusing to load {form.get('class')!r} from "
                             "model file: not a class the port maps")
        marker = getattr(module, "_sharded_weights_marker", None)
        module = owner.from_form(module, form, at)
        if marker is not None:
            module._sharded_weights_marker = marker
    return module


def copy_weights(model, loaded, buffers_only=False):
    """Copy ``loaded``'s weights (a module :func:`load_module` built) into
    ``model`` of the same architecture, in place; with ``buffers_only``
    the buffers alone (a sharded checkpoint's model file: its weights
    come from the shards). Returns ``model``."""
    sd = loaded.state_dict()
    if buffers_only:
        names = {k for k, _ in model.named_buffers()}
        sd = {k: t for k, t in sd.items() if k in names}
    assign(model, sd, strict=not buffers_only)
    return model


def _check_sharded_marker(module, path):
    """A ``model.N`` written by a sharded checkpoint carries the model's
    topology and buffers; its weights live in the ``shard.N.p*`` siblings.
    Refuse such a file once its shard set is gone (the params inside are
    stale), and warn when the shards are still there (resume through
    ``DistriOptimizer`` to restore them)."""
    from bigdl_tpu_torch.utils.fileio import file_listdir, path_dirname
    marker = getattr(module, "_sharded_weights_marker", None)
    if not isinstance(marker, dict):
        return
    neval, nprocs = marker.get("neval"), marker.get("nprocs")
    try:
        siblings = [f for f in file_listdir(path_dirname(path))
                    if f.startswith(f"shard.{neval}.p")
                    and not f.endswith(".tmp")]
    except OSError:
        siblings = None
    log = logging.getLogger(__name__)
    if siblings is None:
        log.warning(
            "%s was written by a sharded checkpoint (neval=%s) and its "
            "params are placeholders; could not verify the shard set",
            path, neval)
    elif not siblings:
        raise ValueError(
            f"{path} was written by a sharded checkpoint (neval={neval}, "
            f"{nprocs} process(es)) and holds STALE placeholder params — "
            f"the shard.{neval}.p* files that carry the real weights are "
            "missing. Restore from a gathered checkpoint, or restore the "
            "shard files and resume through DistriOptimizer.")
    else:
        log.warning(
            "%s is the topology file of a sharded checkpoint "
            "(neval=%s); its params are placeholders — resume through "
            "DistriOptimizer to restore the real weights from "
            "shard.%s.p*", path, neval, neval)


__all__ = ["MAGIC", "WEIGHTS_MAGIC", "NativeSpec", "assign", "built_inside",
           "copy_weights", "load_module", "save_module"]
