"""TensorFlow GraphDef importer (the port of
``bigdl_tpu/interop/tf_loader.py``: reference
``utils/tf/TensorflowLoader.scala:43``, ``parse:88`` GraphDef pb ->
``buildTFGraph:162`` -> per-op loaders -> ``buildBigDLModel:279``).

The GraphDef schemas, :func:`_tensor_value`, :func:`parse_graphdef`, the
constant folding (``Identity``/``ReadVariableOp``/``Enter``, ``Range``,
``Fill``, ``Pack``, ``Shape``, ``BroadcastGradientArgs``,
``ConcatOffset``, ``InvertPermutation`` over constants) and the
conversion of each ``Enter``..``Exit`` frame into one ``_While`` node and
one ``_WhileOut`` per ``Exit`` are the reference's, copied. Each op
becomes one port ``Graph`` node with the reference's layer, its name the
TF node's (a multi-output op's port ``k`` a ``SelectTable`` named
``"<name>:<k>"``), so the port's ``Graph`` orders its nodes as the
reference's does.

A ``Const`` or variable that feeds ``MatMul``, ``Conv2D``, ``BiasAdd``,
``Gather``, ``Mul``, ``Add``, ``FusedBatchNorm`` or ``Conv3D`` becomes
that layer's trainable weight; the layer holds it in TF's layout as
``_tf_weight`` (one copy per consuming layer: a variable read by two ops
is two independent weights, as in the reference), and
:func:`apply_tf_weights` copies it in through ``nn.module.jax_layout``,
the rule ``convert`` uses (``MatMul``'s ``(in, out)`` into ``Linear``'s
``(out, in)``, HWIO into OIHW, a depthwise weight as the grouped
``(kh, kw, 1, cin * mult)``, ``FusedBatchNorm``'s ``(scale, offset, mean,
var)`` into the BN's weight, bias and running statistics). Variables come
from the ``.npy`` directory ``scripts/export_tf_checkpoint.py`` writes (a
name's ``/`` as ``__``), as the reference's ``loadBinFiles`` reads them.

The graph's layers are made on ``device`` (default the card) with seeded
weights (``Module.reset(0)``) until the imported ones are applied:
:func:`load_tf` applies them when given ``sample_input``, after which a
CPU copy of the graph runs one forward on the sample (its own values, or
zeros for a shape) to check that it fits, as the reference's build does.

Control flow: a ``Switch``/``Merge`` pair becomes a ``Select`` over both
branches, as in the reference. A loop frame runs as a Python loop
(:class:`_TFWhileModule`): a counter loop (``i < N`` on a constant, ``i +
1``) a fixed ``N`` times, differentiable; any other loop reads its
condition on the host each iteration (``host_syncs`` counts the reads),
where the reference compiles ``lax.while_loop``.

A training graph's gradient ops (``ReluGrad`` ... ``MaxPoolGrad``,
``Conv2DBackpropInput``/``Filter`` and their depthwise and 3-D forms,
``ResizeBilinearGrad``, ``LRNGrad``, ``Dilation2DBackprop*``) become the
``ops.tf_ops`` layers of the same names; their ``input_sizes``,
``filter_sizes`` and filters must fold to constants, as in the
reference, and a ``Conv2DBackpropInput`` or ``Dilation2DBackprop*``
holds the filter read at load. ``BroadcastGradientArgs`` folds into a
``ConstSource``. The input pipeline's queue and reader ops become graph
inputs (dequeue, read) or pass their components through (enqueue), and
``ParseExample``, ``DecodeRaw``, ``Decode{Jpeg,Png,Gif}`` and ``Substr``
run on the host (``nn/graph.py`` hands their numeric outputs on to the
graph's device, which the loader records).
"""

from __future__ import annotations

import contextlib
import os
import sys
import zlib

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module, call_with_generator
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.protowire import decode
from bigdl_tpu_torch.utils.table import Table, sorted_items

# -------------------------------------------------------------- pb schemas --

TENSOR_SHAPE = {2: ("dim[]", ("msg", {1: ("size", "int")}))}
TENSOR = {1: ("dtype", "int"), 2: ("tensor_shape", ("msg", TENSOR_SHAPE)),
          4: ("tensor_content", "bytes"), 5: ("half_val[]", "int"),
          6: ("float_val[]", "floats_packed"),
          7: ("double_val[]", "doubles_packed"), 8: ("int_val[]", "int"),
          9: ("string_val[]", "bytes"), 10: ("int64_val[]", "int")}
ATTR_VALUE = {2: ("s", "bytes"), 3: ("i", "int"), 4: ("f", "float"),
              5: ("b", "bool"), 6: ("type", "int"),
              7: ("shape", ("msg", TENSOR_SHAPE)),
              8: ("tensor", ("msg", TENSOR)),
              1: ("list", ("msg", {3: ("i[]", "int"),
                                   4: ("f[]", "floats_packed"),
                                   2: ("s[]", "bytes"),
                                   6: ("type[]", "int"),
                                   7: ("shape[]", ("msg", TENSOR_SHAPE))}))}
ATTR_ENTRY = {1: ("key", "string"), 2: ("value", ("msg", ATTR_VALUE))}
NODE_DEF = {1: ("name", "string"), 2: ("op", "string"),
            3: ("input[]", "string"), 4: ("device", "string"),
            5: ("attr[]", ("msg", ATTR_ENTRY))}
GRAPH_DEF = {1: ("node[]", ("msg", NODE_DEF))}

_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           6: np.int8, 9: np.int64, 10: np.bool_}
# TF DataType codes that are integer kinds (int32/uint8/int16/int8/int64/
# uint16/uint32/uint64) — used to detect integer Div semantics
_INT_TYPE_CODES = {3, 4, 5, 6, 9, 17, 22, 23}


def _tensor_value(t):
    dtype = _DTYPES.get(t.get("dtype", 1), np.float32)
    dims = [int(d.get("size", 0)) for d in
            t.get("tensor_shape", {}).get("dim", [])]
    if t.get("dtype") == 7:  # DT_STRING: bytes in string_val (field 9)
        vals = t.get("string_val", [])
        if not dims and len(vals) == 1:
            return vals[0]
        return np.asarray(vals, dtype=object).reshape(dims or [len(vals)])
    if t.get("tensor_content"):
        arr = np.frombuffer(t["tensor_content"], dtype=dtype)
        if dims:
            return arr.reshape(dims)
        # no dims recorded: a single element is a true scalar
        return arr.reshape(()) if arr.size == 1 else arr
    for key in ("float_val", "double_val", "int_val", "int64_val"):
        if t.get(key):
            vals = np.asarray(t[key], dtype=dtype)
            if dims:
                if vals.size == 1:
                    return np.full(dims, vals[0], dtype=dtype)
                return vals.reshape(dims)
            return vals if vals.size > 1 else dtype(vals[0])
    return np.zeros(dims, dtype=dtype)


def parse_graphdef(path_or_bytes):
    data = (path_or_bytes if isinstance(path_or_bytes, bytes)
            else open(path_or_bytes, "rb").read())
    g = decode(data, GRAPH_DEF)
    nodes = []
    for n in g.get("node", []):
        attrs = {a["key"]: a.get("value", {}) for a in n.get("attr", [])}
        nodes.append({"name": n.get("name"), "op": n.get("op"),
                      "inputs": [i for i in n.get("input", [])
                                 if not i.startswith("^")],
                      "attrs": attrs})
    return nodes


class TensorflowLoader:
    """(reference ``TensorflowLoader.scala:43``)"""

    def __init__(self, graph_path, inputs, outputs, bin_dir=None,
                 nodes=None, extra_consts=None):
        self.graph_path = graph_path
        self.input_names = list(inputs)
        self.output_names = list(outputs)
        self.bin_dir = bin_dir  # export_tf_checkpoint.py dump directory
        self._nodes = nodes            # pre-parsed node list (sub-loaders)
        self._extra_consts = extra_consts or {}

    def _variables(self):
        """Variables dumped by scripts/export_tf_checkpoint.py (.npy per
        variable) — the reference's ``loadBinFiles`` route."""
        out = {}
        if self.bin_dir and os.path.isdir(self.bin_dir):
            for f in os.listdir(self.bin_dir):
                if f.endswith(".npy"):
                    out[f[:-4].replace("__", "/")] = np.load(
                        os.path.join(self.bin_dir, f))
        return out

    def load(self, device=None):
        """The port ``Graph`` of the GraphDef's ``outputs``, its layers on
        ``device`` (default the card) with seeded weights (module
        docstring)."""
        nodes = (self._nodes if self._nodes is not None
                 else parse_graphdef(self.graph_path))
        with _recursion_for(len(nodes)):
            graph = self._build(resolve_device(device), nodes)
        graph.reset(0)
        return graph

    def _build(self, device, nodes=None):
        from bigdl_tpu_torch import nn, ops
        from bigdl_tpu_torch.nn.graph import Input
        from bigdl_tpu_torch.nn.module import Node
        from bigdl_tpu_torch.ops import tf_ops as _t

        if nodes is None:
            nodes = (self._nodes if self._nodes is not None
                     else parse_graphdef(self.graph_path))
        by_name = {n["name"]: n for n in nodes}
        variables = self._variables()
        unary_ops = _unary_ops()

        consts = dict(self._extra_consts)
        for n in nodes:
            if n["op"] == "Const":
                consts[n["name"]] = _tensor_value(
                    n["attrs"].get("value", {}).get("tensor", {}))
            elif n["op"] in ("Variable", "VariableV2", "VarHandleOp"):
                if n["name"] in variables:
                    consts[n["name"]] = variables[n["name"]]

        def const_of(name):
            name, _, port_s = name.partition(":")
            port = int(port_s or 0)
            n = by_name.get(name)
            if n is None:
                return None
            if name in consts:
                return consts[name]
            if n["op"] in ("Identity", "ReadVariableOp", "Enter",
                           "RefEnter") and n["inputs"]:
                return const_of(n["inputs"][0])
            if n["op"] == "TensorArraySizeV3" and n["inputs"]:
                # TA size is the (const) size input of the TensorArrayV3
                ta = by_name.get(n["inputs"][0].split(":")[0])
                if ta is not None and ta["inputs"]:
                    return const_of(ta["inputs"][0])
            # fold shape-producing ops over const inputs (Range/Fill feed
            # Reshape/Tile in real graphs; reference folds these in
            # TensorflowToBigDL pattern matching)
            if n["op"] == "Range":
                vals = [const_of(i) for i in n["inputs"][:3]]
                if all(v is not None for v in vals):
                    return np.arange(int(vals[0]), int(vals[1]), int(vals[2]))
            if n["op"] == "Fill":
                dims, value = (const_of(n["inputs"][0]),
                               const_of(n["inputs"][1]))
                if dims is not None and value is not None:
                    return np.full([int(d) for d in np.ravel(dims)], value)
            if n["op"] == "Pack":
                vals = [const_of(i) for i in n["inputs"]]
                if vals and all(v is not None for v in vals):
                    axis = n["attrs"].get("axis", {}).get("i", 0)
                    return np.stack([np.asarray(v) for v in vals], axis=axis)
            if n["op"] == "Shape":
                # fold Shape over a const, or over a Placeholder carrying a
                # fully-defined shape attr — covers the Shape ->
                # BroadcastGradientArgs -> Sum chains TF grad graphs emit
                c = const_of(n["inputs"][0])
                if c is not None:
                    return np.asarray(np.shape(c), np.int32)
                src = by_name.get(n["inputs"][0].partition(":")[0])
                if src is not None and src["op"].startswith("Placeholder"):
                    dims = [d.get("size", -1) for d in
                            src["attrs"].get("shape", {}).get("shape", {})
                            .get("dim", [])]
                    if dims and all(d >= 0 for d in dims):
                        return np.asarray(dims, np.int32)
            if n["op"] == "BroadcastGradientArgs":
                s0, s1 = const_of(n["inputs"][0]), const_of(n["inputs"][1])
                if s0 is not None and s1 is not None:
                    return _broadcast_gradient_args(s0, s1)[port]
            if n["op"] == "ConcatOffset":
                # concat gradient helper (reference utils/tf/loaders/
                # ArrayOps.scala:36): output k is a zero vector with the
                # running concat_dim offset of shape k — feeds the Slice
                # begins of ConcatV2's grad, which read via const_of
                cd = const_of(n["inputs"][0])
                shapes = [const_of(i) for i in n["inputs"][1:]]
                if cd is not None and all(s is not None for s in shapes):
                    cd = int(np.ravel(cd)[0])
                    acc, offs = 0, []
                    for s in shapes:
                        vec = np.zeros(np.ravel(s).size, np.int32)
                        vec[cd] = acc
                        acc += int(np.ravel(s)[cd])
                        offs.append(vec)
                    return offs[port]
            if n["op"] == "InvertPermutation":
                p = const_of(n["inputs"][0])
                if p is not None:
                    return np.argsort(np.ravel(p)).astype(np.int32)
            return None

        # ------------------------------------------- while-loop frames --
        # Enter..Exit frame groups (the reference executes these with an
        # interpreted Scheduler + FrameManager, ``nn/Scheduler.scala:36-79``,
        # ``nn/FrameManager.scala``) are converted mechanically to one
        # structured loop each: a synthetic "_While" node (a fixed count of
        # iterations when the trip count is static, which keeps the loop
        # differentiable, else a loop that reads its condition) and every
        # Exit a "_WhileOut" port selector.
        def base_of(ref):
            return ref.partition(":")[0]

        def convert_frame(fname, enters):
            members = {e["name"] for e in enters}
            changed = True
            while changed:
                changed = False
                for n in nodes:
                    if n["name"] in members or n["op"] in ("Exit", "RefExit"):
                        continue
                    if any(base_of(i) in members for i in n["inputs"]):
                        if n["op"] in ("Enter", "RefEnter"):
                            raise ValueError(
                                f"nested while-loop frame at {n['name']} — "
                                "only single-level TF loops import")
                        members.add(n["name"])
                        changed = True
            exits = [n for n in nodes if n["op"] in ("Exit", "RefExit")
                     and base_of(n["inputs"][0]) in members]
            merges = [n for n in nodes
                      if n["name"] in members and n["op"] == "Merge"]
            switches = [n for n in nodes
                        if n["name"] in members and n["op"] == "Switch"]
            loopconds = [n for n in nodes
                         if n["name"] in members and n["op"] == "LoopCond"]
            if not loopconds:
                raise ValueError(f"frame {fname}: no LoopCond found")

            var_enters = [e for e in enters if not e["attrs"]
                          .get("is_constant", {}).get("b", False)]
            const_enters = [e for e in enters if e["attrs"]
                            .get("is_constant", {}).get("b", False)]
            vars_ = []
            for e in var_enters:
                merge = next((m for m in merges if any(
                    base_of(i) == e["name"] for i in m["inputs"])), None)
                if merge is None:
                    # a value entering the frame but never looped: treat as
                    # a constant capture
                    const_enters.append(e)
                    continue
                switch = next((s for s in switches
                               if base_of(s["inputs"][0]) == merge["name"]),
                              None)
                nextit_ref = next(i for i in merge["inputs"]
                                  if base_of(i) != e["name"])
                nextit = by_name[base_of(nextit_ref)]
                exit_node = None
                if switch is not None:
                    exit_node = next(
                        (x for x in exits
                         if base_of(x["inputs"][0]) == switch["name"]), None)
                vars_.append({"enter": e, "merge": merge, "switch": switch,
                              "nextit": nextit, "exit": exit_node})

            # rewritten node set shared by the cond and body sub-graphs:
            # Merge and Switch both stand for "the current carry value"
            redefs = {}
            for i, v in enumerate(vars_):
                alias = {"op": "Identity", "inputs": [f"__loopvar{i}"],
                         "attrs": {}}
                redefs[v["merge"]["name"]] = dict(
                    alias, name=v["merge"]["name"])
                if v["switch"] is not None:
                    redefs[v["switch"]["name"]] = dict(
                        alias, name=v["switch"]["name"])
            for lc in loopconds:
                redefs[lc["name"]] = {"name": lc["name"], "op": "Identity",
                                      "inputs": [lc["inputs"][0]],
                                      "attrs": {}}
            captures = []
            for e in const_enters:
                src = e["inputs"][0]
                ta = by_name.get(base_of(src))
                if const_of(src) is not None or (
                        ta is not None and ta["op"] == "TensorArrayV3"):
                    tgt = src       # folds as const / TA handle (metadata)
                else:
                    captures.append(src)
                    tgt = f"__loopcap{len(captures) - 1}"
                redefs[e["name"]] = {"name": e["name"], "op": "Identity",
                                     "inputs": [tgt], "attrs": {}}

            n_vars = len(vars_)
            ph = [{"name": f"__loopvar{i}", "op": "Placeholder",
                   "inputs": [], "attrs": {}} for i in range(n_vars)]
            ph += [{"name": f"__loopcap{j}", "op": "Placeholder",
                    "inputs": [], "attrs": {}}
                   for j in range(len(captures))]
            # var Enters are replaced by the carry placeholders (nothing in
            # the subgraph references them once Merge/Switch are aliased),
            # and Exits live outside the loop — drop both so the sub-loader
            # doesn't re-detect a frame
            sub_nodes = ph + [
                redefs.get(n["name"], n) for n in nodes
                if n["op"] not in ("Exit", "RefExit")
                and not (n["op"] in ("Enter", "RefEnter")
                         and n["name"] not in redefs)]
            sub_inputs = [p["name"] for p in ph]
            cond_out = loopconds[0]["name"]
            body_outs = [v["nextit"]["inputs"][0] for v in vars_]

            # initial carry values
            inits = []
            for v in vars_:
                src = v["enter"]["inputs"][0]
                c = const_of(src)
                ta = by_name.get(base_of(src))
                if ta is not None and ta["op"] == "TensorArrayV3":
                    size = const_of(ta["inputs"][0])
                    if size is None:
                        raise ValueError(
                            f"TensorArray {ta['name']}: dynamic size")
                    eshape = [int(d.get("size", -1)) for d in
                              ta["attrs"].get("element_shape", {})
                              .get("shape", {}).get("dim", [])]
                    if any(s < 0 for s in eshape):
                        raise ValueError(
                            f"TensorArray {ta['name']}: element_shape must "
                            "be fully defined for a loop accumulator")
                    dt = _DTYPES.get(
                        ta["attrs"].get("dtype", {}).get("type", 1),
                        np.float32)
                    inits.append(("zeros",
                                  (int(np.ravel(size)[0]), tuple(eshape),
                                   dt)))
                elif c is not None:
                    inits.append(("const", c))
                else:
                    inits.append(("node", src))

            trip = _static_trip_count(vars_, by_name, const_of,
                                      loopconds[0], inits)
            return {"vars": vars_, "sub_nodes": sub_nodes,
                    "sub_inputs": sub_inputs, "cond_out": cond_out,
                    "body_outs": body_outs, "inits": inits,
                    "captures": captures, "trip": trip}

        frames = {}
        for n in nodes:
            if n["op"] in ("Enter", "RefEnter"):
                key = n["attrs"].get("frame_name", {}).get("s", b"")
                key = key.decode() if isinstance(key, bytes) else str(key)
                frames.setdefault(key or "frame", []).append(n)
        loop_defs = {}
        for fname, enters in frames.items():
            payload = convert_frame(fname, enters)
            wname = f"__while_{fname}"
            loop_defs[wname] = payload
            by_name[wname] = {"name": wname, "op": "_While", "inputs": [],
                              "attrs": {}}
            for i, v in enumerate(payload["vars"]):
                if v["exit"] is not None:
                    by_name[v["exit"]["name"]] = {
                        "name": v["exit"]["name"], "op": "_WhileOut",
                        "inputs": [], "attrs": {},
                        "_while": wname, "_index": i}

        graph_nodes = {}
        input_nodes = []

        def trace_switch(raw):
            """Walk the raw graph upward to the Switch feeding this value.
            Returns (switch_base_name, port) or None."""
            seen, stack = set(), [raw]
            while stack:
                r = stack.pop()
                base, _, port = r.partition(":")
                src = by_name.get(base)
                if src is None or base in seen:
                    continue
                if src["op"] == "Switch":
                    return base, int(port or 0)
                seen.add(base)
                stack.extend(src["inputs"])
            return None

        MULTI_OUTPUT = ("Unpack", "Unstack", "Split", "SplitV", "TopK",
                        "TopKV2", "SoftmaxCrossEntropyWithLogits",
                        "FusedBatchNormGrad", "FusedBatchNormGradV2",
                        "BroadcastGradientArgs", "ParseExample")
        port_nodes = {}

        def emit(ref):
            name, _, port_s = ref.partition(":")
            port = int(port_s or 0)
            base = _emit_base(name)
            if by_name.get(name, {}).get("op") in MULTI_OUTPUT:
                # the base node yields a table: select this output port
                key = (name, port)
                if key not in port_nodes:
                    port_nodes[key] = Node(
                        nn.SelectTable(port + 1).set_name(f"{name}:{port}")
                    ).inputs(base)
                return port_nodes[key]
            return base

        def _emit_base(name):
            if name in graph_nodes:
                return graph_nodes[name]
            n = by_name[name]
            op = n["op"]
            attrs = n["attrs"]
            ins = n["inputs"]

            def dep(i):
                return emit(ins[i])

            if op in ("Placeholder", "PlaceholderV2"):
                node = Input()
                input_nodes.append((name, node))
            elif op == "Const":
                raise ValueError(f"const {name} used as activation")
            elif op in ("Identity", "StopGradient", "PreventGradient",
                        "CheckNumerics", "NoOp", "Assert"):
                node = dep(0)
            elif op == "MatMul":
                w = const_of(ins[1])
                ta = attrs.get("transpose_a", {}).get("b", False)
                tb = attrs.get("transpose_b", {}).get("b", False)
                if w is not None and ta:
                    raise ValueError(
                        f"MatMul {name}: transpose_a=true with a const "
                        "weight is not supported")
                if w is not None:
                    if tb:
                        w = np.ascontiguousarray(w.T)
                    m = nn.Linear(w.shape[0], w.shape[1], with_bias=False,
                                  device=device)
                    m.set_name(name)
                    m._tf_weight = w
                    node = Node(m).inputs(dep(0))
                else:
                    # activation x activation (attention scores etc.)
                    m = nn.MM(trans_a=ta, trans_b=tb)
                    node = Node(m.set_name(name)).inputs(dep(0), dep(1))
            elif op in ("BatchMatMul", "BatchMatMulV2"):
                m = nn.MM(trans_a=attrs.get("adj_x", {}).get("b", False),
                          trans_b=attrs.get("adj_y", {}).get("b", False))
                node = Node(m.set_name(name)).inputs(dep(0), dep(1))
            elif op == "Einsum":
                eq = attrs.get("equation", {}).get("s", b"").decode()
                m = _EinsumModule(eq)
                node = Node(m.set_name(name)).inputs(
                    *[emit(i) for i in ins])
            elif op == "Conv2D" or op == "DepthwiseConv2dNative":
                w = const_of(ins[1])  # HWIO
                strides = attrs.get("strides", {}).get("list", {}) \
                    .get("i", [1, 1, 1, 1])
                pad = attrs.get("padding", {}).get("s", b"SAME").decode()
                kh, kw, cin, cout = w.shape
                depthwise = op == "DepthwiseConv2dNative"
                groups = cin if depthwise else 1
                n_out = cin * cout if depthwise else cout
                m = nn.SpatialConvolution(
                    cin, n_out, kw, kh, int(strides[2]), int(strides[1]),
                    -1 if pad == "SAME" else 0, -1 if pad == "SAME" else 0,
                    n_group=groups, with_bias=False, format="NHWC",
                    device=device)
                m.set_name(name)
                m._tf_weight = (w.reshape(kh, kw, 1, cin * cout)
                                if depthwise else w)
                node = Node(m).inputs(dep(0))
            elif op in ("BiasAdd", "BiasAddV1"):
                b = const_of(ins[1])
                m = nn.CAdd(b.shape, device=device)
                m.set_name(name)
                m._tf_weight = b
                node = Node(m).inputs(dep(0))
            elif op in ("Add", "AddV2", "Sub", "Mul", "Maximum", "Minimum",
                        "RealDiv", "Div", "SquaredDifference"):
                # a scalar Const may sit on either side (graph rewrites
                # commonly emit Mul(scale_const, x))
                c1, c0 = const_of(ins[1]), const_of(ins[0])
                int_t = attrs.get("T", {}).get("type") in _INT_TYPE_CODES
                if op == "Div" and (int_t or any(
                        c is not None and np.issubdtype(
                            np.asarray(c).dtype, np.integer)
                        for c in (c0, c1))):
                    # TF Div on integers is C-style truncated division
                    # (RealDiv is the float-only form); detected from the
                    # T attr or an integer const operand
                    if c0 is not None and c1 is not None:
                        res = np.trunc(np.true_divide(c0, c1)) \
                            .astype(np.asarray(c0).dtype)
                        node = Node(_t.ConstSource(res, device=device)
                                    .set_name(name))
                    elif c0 is not None or c1 is not None:
                        node = Node(_ConstBinary(_t.TruncateDiv.fn, c0, c1)
                                    .set_name(name)).inputs(
                            dep(1 if c0 is not None else 0))
                    else:
                        node = Node(_t.TruncateDiv().set_name(name)) \
                            .inputs(dep(0), dep(1))
                    graph_nodes[name] = node
                    return node
                scalar1 = c1 is not None and np.ndim(c1) == 0
                scalar0 = c0 is not None and np.ndim(c0) == 0
                vec1 = c1 is not None and np.ndim(c1) >= 1
                vec0 = c0 is not None and np.ndim(c0) >= 1
                if op in ("Mul", "Add", "AddV2") and (vec1 or vec0) \
                        and not (scalar1 or scalar0):
                    # broadcast with a variable/const vector (LayerNorm
                    # gamma/beta etc.): a CMul/CAdd layer weight, which
                    # trains, as the reference's loadTF layers do
                    c = c1 if vec1 else c0
                    act = 0 if vec1 else 1
                    m = (nn.CMul(c.shape, device=device) if op == "Mul"
                         else nn.CAdd(c.shape, device=device))
                    m._tf_weight = c
                    node = Node(m.set_name(name)).inputs(dep(act))
                elif scalar1 or scalar0:
                    c = float(c1 if scalar1 else c0)
                    act = 0 if scalar1 else 1
                    if op in ("Add", "AddV2"):
                        m = nn.AddConstant(c)
                    elif op == "Mul":
                        m = nn.MulConstant(c)
                    elif op in ("RealDiv", "Div") and scalar1:  # x / c
                        m = nn.MulConstant(1.0 / c)
                    elif op == "Sub" and scalar1:      # x - c
                        m = nn.AddConstant(-c)
                    elif op == "Sub":                  # c - x
                        m = nn.Sequential(nn.Negative(), nn.AddConstant(c))
                    elif op == "SquaredDifference":
                        m = nn.Sequential(nn.AddConstant(-c), nn.Square())
                    else:
                        raise ValueError(f"{op} with scalar const")
                    node = Node(m.set_name(name)).inputs(dep(act))
                else:
                    table = {"Add": nn.CAddTable, "AddV2": nn.CAddTable,
                             "Sub": nn.CSubTable, "Mul": nn.CMulTable,
                             "Maximum": nn.CMaxTable,
                             "Minimum": nn.CMinTable,
                             "RealDiv": nn.CDivTable,
                             "Div": nn.CDivTable,
                             "SquaredDifference": _SquaredDiffTable}[op]()
                    node = Node(table.set_name(name)).inputs(dep(0), dep(1))
            elif op == "Relu":
                node = Node(nn.ReLU().set_name(name)).inputs(dep(0))
            elif op == "Relu6":
                node = Node(nn.ReLU6().set_name(name)).inputs(dep(0))
            elif op == "Sigmoid":
                node = Node(nn.Sigmoid().set_name(name)).inputs(dep(0))
            elif op == "Tanh":
                node = Node(nn.Tanh().set_name(name)).inputs(dep(0))
            elif op == "Softmax":
                node = Node(nn.SoftMax().set_name(name)).inputs(dep(0))
            elif op in ("MaxPool", "AvgPool"):
                ks = attrs.get("ksize", {}).get("list", {}).get(
                    "i", [1, 2, 2, 1])
                st = attrs.get("strides", {}).get("list", {}).get(
                    "i", [1, 2, 2, 1])
                pad = attrs.get("padding", {}).get("s", b"VALID").decode()
                p = -1 if pad == "SAME" else 0
                ctor = (nn.SpatialMaxPooling if op == "MaxPool"
                        else nn.SpatialAveragePooling)
                m = ctor(int(ks[2]), int(ks[1]), int(st[2]), int(st[1]),
                         p, p, format="NHWC")
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op == "Mean":
                axes = const_of(ins[1])
                keep = attrs.get("keep_dims", {}).get("b", False)
                m = nn.Mean(dimension=tuple(int(a) for a in np.ravel(axes)),
                            squeeze=not keep)
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op == "Reshape":
                shape = const_of(ins[1])
                dims = tuple(int(s) for s in np.ravel(shape))
                # -1 inference keeps the batch flexible and handles the
                # (B,T,H)->(B*T,H) flattening BERT graphs do
                m = nn.Reshape(dims, batch_mode=False)
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op == "Squeeze":
                # the reference squeezes the first of squeeze_dims only
                dims = attrs.get("squeeze_dims", attrs.get("axis", {}))
                axes = dims.get("list", {}).get("i") if dims else None
                m = nn.Squeeze(int(axes[0])) if axes else nn.Squeeze()
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op in ("ConcatV2", "Concat"):
                axis_in = ins[-1] if op == "ConcatV2" else ins[0]
                data_ins = ins[:-1] if op == "ConcatV2" else ins[1:]
                axis = int(np.ravel(const_of(axis_in))[0])
                m = nn.JoinTable(axis)
                node = Node(m.set_name(name)).inputs(
                    *[emit(i) for i in data_ins])
            elif op in ("FusedBatchNorm", "FusedBatchNormV2",
                        "FusedBatchNormV3"):
                scale, offset = const_of(ins[1]), const_of(ins[2])
                mean, var = const_of(ins[3]), const_of(ins[4])
                eps = attrs.get("epsilon", {}).get("f", 1e-3)
                m = nn.SpatialBatchNormalization(len(scale), eps=eps,
                                                 format="NHWC",
                                                 device=device)
                m.set_name(name)
                m._tf_weight = (scale, offset, mean, var)
                node = Node(m).inputs(dep(0))
            elif op == "Pad":
                pads = const_of(ins[1])
                m = _PadModule(np.asarray(pads))
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op in unary_ops:
                node = Node(unary_ops[op]().set_name(name)).inputs(dep(0))
            elif op == "Pow":
                e = const_of(ins[1])
                if e is not None and np.ndim(e) == 0:
                    node = Node(ops.Pow(float(e)).set_name(name)).inputs(
                        dep(0))
                else:
                    node = Node(ops.Pow().set_name(name)).inputs(dep(0),
                                                                dep(1))
            elif op == "Transpose":
                perm = [int(p) for p in np.ravel(const_of(ins[1]))]
                node = Node(_TransposeModule(perm).set_name(name)) \
                    .inputs(dep(0))
            elif op in ("Gather", "GatherV2"):
                table = const_of(ins[0])
                axis = 0
                if op == "GatherV2" and len(ins) > 2:
                    axis = int(np.ravel(const_of(ins[2]))[0])
                if table is not None and axis == 0:
                    # const/variable table -> embedding layer weight
                    m = _GatherWeight(table.shape, device=device)
                    m._tf_weight = table
                    node = Node(m.set_name(name)).inputs(dep(1))
                else:
                    m = ops.Gather(axis=axis)
                    node = Node(m.set_name(name)).inputs(dep(0), dep(1))
            elif op == "OneHot":
                depth = int(np.ravel(const_of(ins[1]))[0])
                on = float(np.ravel(const_of(ins[2]))[0]) if len(ins) > 2 \
                    else 1.0
                off = float(np.ravel(const_of(ins[3]))[0]) if len(ins) > 3 \
                    else 0.0
                m = ops.OneHot(depth, on, off,
                               axis=attrs.get("axis", {}).get("i", -1))
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op == "ArgMax":
                axis = int(np.ravel(const_of(ins[1]))[0]) if len(ins) > 1 \
                    else -1
                node = Node(ops.ArgMax(axis).set_name(name)).inputs(dep(0))
            elif op == "Cast":
                dst = _DTYPES.get(attrs.get("DstT", {}).get("type", 1),
                                  np.float32)
                node = Node(ops.Cast(dst).set_name(name)).inputs(dep(0))
            elif op == "Tile":
                mult = [int(v) for v in np.ravel(const_of(ins[1]))]
                node = Node(ops.Tile(mult).set_name(name)).inputs(dep(0))
            elif op == "ExpandDims":
                axis = int(np.ravel(const_of(ins[1]))[0])
                node = Node(ops.ExpandDims(axis).set_name(name)).inputs(
                    dep(0))
            elif op == "Slice":
                begin = [int(v) for v in np.ravel(const_of(ins[1]))]
                size = [int(v) for v in np.ravel(const_of(ins[2]))]
                node = Node(ops.Slice(begin, size).set_name(name)).inputs(
                    dep(0))
            elif op == "StridedSlice":
                begin = [int(v) for v in np.ravel(const_of(ins[1]))]
                end = [int(v) for v in np.ravel(const_of(ins[2]))]
                strides = [int(v) for v in np.ravel(const_of(ins[3]))] \
                    if len(ins) > 3 else None
                m = ops.StridedSlice(
                    begin, end, strides,
                    begin_mask=attrs.get("begin_mask", {}).get("i", 0),
                    end_mask=attrs.get("end_mask", {}).get("i", 0),
                    shrink_axis_mask=attrs.get(
                        "shrink_axis_mask", {}).get("i", 0),
                    new_axis_mask=attrs.get(
                        "new_axis_mask", {}).get("i", 0),
                    ellipsis_mask=attrs.get(
                        "ellipsis_mask", {}).get("i", 0))
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op == "Sum":
                axes = const_of(ins[1])
                keep = attrs.get("keep_dims", {}).get("b", False)
                m = nn.Sum(dimension=tuple(int(a) for a in np.ravel(axes)),
                           squeeze=not keep)
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op == "Switch":
                # both ports forward the data; the Merge downstream selects
                # (both branches run, as the reference's select does)
                node = dep(0)
            elif op == "Merge":
                traces = [trace_switch(i) for i in ins[:2]]
                if any(t is None for t in traces) \
                        or traces[0][0] != traces[1][0]:
                    raise ValueError(
                        f"Merge {name}: branches do not share one Switch — "
                        "only tf.cond-style Switch/Merge graphs import; "
                        "loops (Enter/Exit/NextIteration) should be "
                        "re-expressed with bigdl_tpu.ops.WhileLoop")
                sw = by_name[traces[0][0]]
                pred_node = emit(sw["inputs"][1])
                true_i = 0 if traces[0][1] == 1 else 1
                node = Node(ops.Select().set_name(name)).inputs(
                    pred_node, emit(ins[true_i]), emit(ins[1 - true_i]))
            elif op == "_While":
                payload = loop_defs[name]
                sub_in = payload["sub_inputs"]
                cond_graph = TensorflowLoader(
                    None, sub_in, [payload["cond_out"]],
                    nodes=payload["sub_nodes"],
                    extra_consts=consts)._build(device)
                body_graph = TensorflowLoader(
                    None, sub_in, payload["body_outs"],
                    nodes=payload["sub_nodes"],
                    extra_consts=consts)._build(device)
                m = _TFWhileModule(cond_graph, body_graph, payload["inits"],
                                   len(payload["captures"]), payload["trip"])
                wired = [emit(ref) for kind, ref in payload["inits"]
                         if kind == "node"]
                wired += [emit(c) for c in payload["captures"]]
                if not wired:
                    raise ValueError(
                        f"while frame {name}: loop consumes no graph "
                        "tensors — unsupported")
                node = Node(m.set_name(name)).inputs(*wired)
            elif op == "_WhileOut":
                wnode = emit(n["_while"])
                node = Node(nn.SelectTable(n["_index"] + 1)
                            .set_name(name)).inputs(wnode)
            elif op == "TensorArrayV3":
                raise ValueError(
                    f"TensorArray {name}: flow used outside a supported "
                    "pattern (scatter feed / loop write-accumulate)")
            elif op == "TensorArrayScatterV3":
                node = Node(_t.TensorArrayScatter(const_of(ins[1]))
                            .set_name(name)).inputs(emit(ins[2]))
            elif op == "TensorArrayGatherV3":
                node = Node(_t.TensorArrayGather(const_of(ins[1]))
                            .set_name(name)).inputs(emit(ins[2]))
            elif op == "TensorArrayReadV3":
                ci = const_of(ins[1])
                if ci is not None:
                    node = Node(_t.TensorArrayRead(int(np.ravel(ci)[0]))
                                .set_name(name)).inputs(emit(ins[2]))
                else:
                    node = Node(_t.TensorArrayRead().set_name(name)).inputs(
                        emit(ins[1]), emit(ins[2]))
            elif op == "TensorArrayWriteV3":
                node = Node(_t.TensorArrayWrite().set_name(name)).inputs(
                    emit(ins[1]), emit(ins[2]), emit(ins[3]))
            elif op == "TensorArrayConcatV3":
                node = Node(_t.TensorArrayConcat().set_name(name)).inputs(
                    emit(ins[1]))
            elif op == "TensorArraySplitV3":
                # inputs: handle, value, lengths, flow
                lengths = const_of(ins[2])
                if lengths is None:
                    raise ValueError(
                        f"TensorArraySplit {name}: lengths must be "
                        "const-foldable (XLA static shapes)")
                node = Node(_t.TensorArraySplit(lengths)
                            .set_name(name)).inputs(emit(ins[1]))
            elif op == "InvertPermutation":
                node = Node(_t.InvertPermutation().set_name(name)).inputs(
                    dep(0))
            elif op == "TensorArraySizeV3":
                raise ValueError(
                    f"TensorArraySize {name}: size must be const-foldable")
            elif op in ("Enter", "Exit", "NextIteration", "LoopCond",
                        "RefEnter", "RefExit"):
                raise ValueError(
                    f"TF while-loop op {op} ({name}) outside a recognized "
                    "Enter..Exit frame — malformed loop graph")
            elif op in ("Log1p", "Lgamma", "Digamma"):
                node = Node(getattr(_t, op)().set_name(name)).inputs(dep(0))
            elif op == "InTopK":
                node = Node(_t.InTopK(int(attrs.get("k", {}).get("i", 1)))
                            .set_name(name)).inputs(dep(0), dep(1))
            elif op == "SegmentSum":
                ids = const_of(ins[1])
                if ids is None:
                    raise ValueError(
                        f"SegmentSum {name}: segment_ids must be const "
                        "(dynamic ids make the output shape data-dependent)")
                node = Node(_t.SegmentSumConst(ids).set_name(name)).inputs(
                    dep(0))
            elif op == "SoftmaxCrossEntropyWithLogits":
                node = Node(_t.SoftmaxCrossEntropyWithLogits()
                            .set_name(name)).inputs(dep(0), dep(1))
            elif op == "Dilation2D":
                w = const_of(ins[1])
                strides = attrs.get("strides", {}).get("list", {}) \
                    .get("i", [1, 1, 1, 1])
                rates = attrs.get("rates", {}).get("list", {}) \
                    .get("i", [1, 1, 1, 1])
                pad = attrs.get("padding", {}).get("s", b"SAME").decode()
                node = Node(_t.Dilation2D(
                    w, (int(strides[1]), int(strides[2])),
                    (int(rates[1]), int(rates[2])), pad)
                    .set_name(name)).inputs(dep(0))
            elif op == "Conv3D":
                w = const_of(ins[1])
                st = attrs.get("strides", {}).get("list", {}) \
                    .get("i", [1, 1, 1, 1, 1])
                pad = attrs.get("padding", {}).get("s", b"SAME").decode()
                m = _t.TFConv3D(w.shape,
                                (int(st[1]), int(st[2]), int(st[3])), pad,
                                device=device)
                m.set_name(name)
                m._tf_weight = w
                node = Node(m).inputs(dep(0))
            elif op in ("Greater", "GreaterEqual", "Less", "LessEqual",
                        "Equal", "NotEqual", "LogicalAnd", "LogicalOr",
                        "FloorDiv", "FloorMod", "Mod", "TruncateDiv",
                        "TruncateMod", "ApproximateEqual"):
                # TF Mod is C-style truncated remainder, NOT floored
                cls = (_t.TruncateMod if op in ("Mod", "TruncateMod")
                       else getattr(_t, op))
                c0, c1 = const_of(ins[0]), const_of(ins[1])
                if c0 is not None or c1 is not None:
                    # const operand: close over it instead of making the
                    # Const a graph node
                    node = Node(_ConstBinary(cls.fn, c0, c1)
                                .set_name(name)).inputs(
                        dep(1 if c0 is not None else 0))
                else:
                    node = Node(cls().set_name(name)).inputs(dep(0), dep(1))
            elif op == "LogicalNot":
                node = Node(ops.LogicalNot().set_name(name)).inputs(dep(0))
            elif op in ("Max", "Min", "Prod", "All", "Any"):
                axes = const_of(ins[1])
                keep = attrs.get("keep_dims", {}).get("b", False)
                axis = tuple(int(a) for a in np.ravel(axes))
                cls = {"Max": _t.ReduceMax, "Min": _t.ReduceMin,
                       "Prod": _t.Prod, "All": _t.All, "Any": _t.Any}[op]
                m = cls(axis=axis, keep_dims=keep)
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op in ("Select", "SelectV2"):
                node = Node(ops.Select().set_name(name)).inputs(
                    dep(0), dep(1), dep(2))
            elif op in ("AddN",):
                node = Node(nn.CAddTable().set_name(name)).inputs(
                    *[emit(i) for i in ins])
            elif op in ("Pack", "Stack"):
                axis = attrs.get("axis", {}).get("i", 0)
                node = Node(_t.Pack(axis=axis).set_name(name)).inputs(
                    *[emit(i) for i in ins])
            elif op in ("Unpack", "Unstack"):
                axis = attrs.get("axis", {}).get("i", 0)
                num = attrs.get("num", {}).get("i")
                node = Node(_t.Unpack(axis=axis, num=num)
                            .set_name(name)).inputs(dep(0))
            elif op in ("Split", "SplitV"):
                if op == "Split":  # inputs: axis, value
                    axis = int(np.ravel(const_of(ins[0]))[0])
                    act = 1
                else:              # SplitV: value, size_splits, axis
                    sizes = np.ravel(const_of(ins[1]))
                    if len(set(sizes.tolist())) != 1:
                        raise ValueError(
                            f"SplitV {name}: uneven splits unsupported")
                    axis = int(np.ravel(const_of(ins[2]))[0])
                    act = 0
                num = attrs.get("num_split", {}).get("i") \
                    or attrs.get("num", {}).get("i")
                node = Node(_t.SplitTF(int(num), axis=axis)
                            .set_name(name)).inputs(dep(act))
            elif op in ("TopK", "TopKV2"):
                k = (attrs.get("k", {}).get("i")
                     or int(np.ravel(const_of(ins[1]))[0]))
                node = Node(_t.TopK(int(k)).set_name(name)).inputs(dep(0))
            elif op == "LeakyRelu":
                alpha = attrs.get("alpha", {}).get("f", 0.2)
                node = Node(_t.LeakyRelu(alpha).set_name(name)).inputs(
                    dep(0))
            elif op in ("Elu",):
                node = Node(nn.ELU().set_name(name)).inputs(dep(0))
            elif op in ("Softplus",):
                node = Node(nn.SoftPlus().set_name(name)).inputs(dep(0))
            elif op in ("Softsign",):
                node = Node(nn.SoftSign().set_name(name)).inputs(dep(0))
            elif op == "L2Loss":
                node = Node(_t.L2Loss().set_name(name)).inputs(dep(0))
            elif op == "LRN":
                # TF: (bias + alpha*sum)^-beta over 2r+1 channels, NHWC;
                # our LRN multiplies alpha/size -> rescale alpha by size
                r = attrs.get("depth_radius", {}).get("i", 5)
                size = 2 * int(r) + 1
                alpha = attrs.get("alpha", {}).get("f", 1.0) * size
                beta = attrs.get("beta", {}).get("f", 0.5)
                bias = attrs.get("bias", {}).get("f", 1.0)
                m = nn.SpatialCrossMapLRN(size, alpha, beta, bias,
                                          format="NHWC")
                node = Node(m.set_name(name)).inputs(dep(0))
            elif op == "ResizeBilinear":
                size = np.ravel(const_of(ins[1]))
                ac = attrs.get("align_corners", {}).get("b", False)
                node = Node(_t.ResizeBilinear((int(size[0]), int(size[1])),
                                              ac)
                            .set_name(name)).inputs(dep(0))
            elif op in ("Shape", "Rank", "ZerosLike", "OnesLike",
                        "Reciprocal", "Inv", "Expm1", "Erfc", "IsFinite",
                        "IsInf", "IsNan", "Round", "Rint"):
                cls = {"Inv": _t.Reciprocal, "Rint": _t.Round,
                       "Rank": _t.Rank}.get(op) or getattr(_t, op)
                node = Node(cls().set_name(name)).inputs(dep(0))
            elif op == "RandomUniform":
                shape = const_of(ins[0])
                if shape is None:
                    raise ValueError(
                        f"RandomUniform {name}: shape must be const")
                dt = _DTYPES.get(attrs.get("dtype", {}).get("type", 1),
                                 np.float32)
                # TF draws independently per op: the graph seed and the
                # op seed2 combine; fully unseeded nodes get a per-node
                # seed from the node name
                s1 = attrs.get("seed", {}).get("i", 0)
                s2 = attrs.get("seed2", {}).get("i", 0)
                if s1 or s2:
                    seed = ((s1 * 1000003) ^ s2) & 0x7FFFFFFF
                else:
                    seed = zlib.crc32(name.encode()) & 0x7FFFFFFF
                node = Node(_t.RandomUniform(
                    [int(s) for s in np.ravel(shape)], seed=seed, dtype=dt,
                    device=device).set_name(name))
            # ------------------------------------- gradient ops (training
            # graphs: the backward nodes tf.gradients writes)
            elif op in ("ReluGrad", "Relu6Grad", "EluGrad", "SoftplusGrad",
                        "SoftsignGrad", "SigmoidGrad", "TanhGrad",
                        "SqrtGrad", "RsqrtGrad", "ReciprocalGrad",
                        "InvGrad"):
                cls = (_t.ReciprocalGrad if op == "InvGrad"
                       else getattr(_t, op))
                node = Node(cls().set_name(name)).inputs(dep(0), dep(1))
            elif op == "BiasAddGrad":
                node = Node(_t.BiasAddGrad().set_name(name)).inputs(dep(0))
            elif op in ("FusedBatchNormGrad", "FusedBatchNormGradV2"):
                eps = attrs.get("epsilon", {}).get("f", 1e-4)
                node = Node(_t.FusedBatchNormGrad(eps).set_name(name)) \
                    .inputs(*[emit(i) for i in ins[:5]])
            elif op in ("AvgPoolGrad", "MaxPoolGrad"):
                ks = attrs.get("ksize", {}).get("list", {}).get("i")
                st = attrs.get("strides", {}).get("list", {}).get("i")
                pad = attrs.get("padding", {}).get("s", b"SAME").decode()
                window = ((int(ks[1]), int(ks[2])), (int(st[1]), int(st[2])),
                          pad)
                if op == "AvgPoolGrad":
                    sizes = [int(s) for s in np.ravel(const_of(ins[0]))]
                    node = Node(_t.AvgPoolGrad(sizes, *window)
                                .set_name(name)).inputs(dep(1))
                else:
                    node = Node(_t.MaxPoolGrad(*window).set_name(name)) \
                        .inputs(dep(0), dep(1), dep(2))
            elif op in ("Conv2DBackpropInput",
                        "DepthwiseConv2dNativeBackpropInput",
                        "Conv3DBackpropInput", "Conv3DBackpropInputV2"):
                sizes, w = const_of(ins[0]), const_of(ins[1])
                if sizes is None or w is None:
                    raise ValueError(f"{op} {name}: input_sizes and filter "
                                     "must be const")
                nd = 3 if op.startswith("Conv3D") else 2
                st = attrs.get("strides", {}).get("list", {}) \
                    .get("i", [1] * (nd + 2))
                pad = attrs.get("padding", {}).get("s", b"SAME").decode()
                node = Node(_t.ConvBackpropInput(
                    [int(s) for s in np.ravel(sizes)], w,
                    tuple(int(s) for s in st[1:nd + 1]), pad,
                    depthwise=op.startswith("Depthwise"), spatial_dims=nd,
                    device=device).set_name(name)).inputs(dep(2))
            elif op in ("Conv2DBackpropFilter",
                        "DepthwiseConv2dNativeBackpropFilter",
                        "Conv3DBackpropFilter", "Conv3DBackpropFilterV2"):
                fsizes = const_of(ins[1])
                if fsizes is None:
                    raise ValueError(f"{op} {name}: filter_sizes must be "
                                     "const")
                nd = 3 if op.startswith("Conv3D") else 2
                st = attrs.get("strides", {}).get("list", {}) \
                    .get("i", [1] * (nd + 2))
                pad = attrs.get("padding", {}).get("s", b"SAME").decode()
                node = Node(_t.ConvBackpropFilter(
                    [int(s) for s in np.ravel(fsizes)],
                    tuple(int(s) for s in st[1:nd + 1]), pad,
                    depthwise=op.startswith("Depthwise"), spatial_dims=nd)
                    .set_name(name)).inputs(dep(0), dep(2))
            elif op == "RandomShuffle":
                node = Node(_t.RandomShuffle().set_name(name)).inputs(dep(0))
            elif op == "ResizeBilinearGrad":
                ac = attrs.get("align_corners", {}).get("b", False)
                node = Node(_t.ResizeBilinearGrad(ac).set_name(name)) \
                    .inputs(dep(0), dep(1))
            elif op == "LRNGrad":
                node = Node(_t.LRNGrad(
                    attrs.get("depth_radius", {}).get("i", 5),
                    attrs.get("bias", {}).get("f", 1.0),
                    attrs.get("alpha", {}).get("f", 1.0),
                    attrs.get("beta", {}).get("f", 0.5))
                    .set_name(name)).inputs(dep(0), dep(1))
            elif op in ("Dilation2DBackpropInput",
                        "Dilation2DBackpropFilter"):
                st = attrs.get("strides", {}).get("list", {}) \
                    .get("i", [1, 1, 1, 1])
                rt = attrs.get("rates", {}).get("list", {}) \
                    .get("i", [1, 1, 1, 1])
                pad = attrs.get("padding", {}).get("s", b"SAME").decode()
                w = const_of(ins[1])
                if w is None:
                    raise ValueError(f"{op} {name}: filter must be const")
                node = Node(_t.Dilation2DBackprop(
                    w, (int(st[1]), int(st[2])), (int(rt[1]), int(rt[2])),
                    pad, wrt="input" if op.endswith("Input") else "filter",
                    device=device).set_name(name)).inputs(dep(0), dep(2))
            elif op == "BroadcastGradientArgs":
                r0 = const_of(name + ":0")
                if r0 is None:
                    raise ValueError(
                        f"BroadcastGradientArgs {name}: input shapes must "
                        "be const-foldable (Shape over const/Placeholder)")
                node = Node(_t.ConstSource(r0, const_of(name + ":1"),
                                           device=device).set_name(name))
            # ----------------------- the input pipeline and host data ops
            elif op in ("QueueDequeueV2", "QueueDequeueManyV2",
                        "ReaderReadV2"):
                # the pipeline's boundary: a graph input, as the
                # reference's adapted dequeue nodes (list the op's name in
                # ``inputs`` and feed batches from the data API)
                node = Input()
                input_nodes.append((name, node))
            elif op in ("QueueEnqueueV2", "QueueEnqueueManyV2"):
                # enqueue(queue_handle, components...): the components
                # pass through; the handle is never emitted
                comps = ins[1:] if len(ins) > 1 else ins
                if len(comps) == 1:
                    node = emit(comps[0])
                else:
                    node = Node(nn.Identity().set_name(name)).inputs(
                        *[emit(i) for i in comps])
            elif op == "Substr":
                pos, ln = const_of(ins[1]), const_of(ins[2])
                if pos is None or ln is None:
                    raise ValueError(f"Substr {name}: pos/len must be const")
                node = Node(_t.Substr(int(np.ravel(pos)[0]),
                                      int(np.ravel(ln)[0]))
                            .set_name(name)).inputs(dep(0))
            elif op == "DecodeRaw":
                dt = _DTYPES.get(attrs.get("out_type", {}).get("type", 1),
                                 np.float32)
                le = attrs.get("little_endian", {}).get("b", True)
                node = Node(_t.DecodeRaw(dt, little_endian=le)
                            .set_name(name)).inputs(dep(0))
            elif op in ("DecodeJpeg", "DecodePng", "DecodeGif"):
                node = Node(_t.DecodeImage(
                    attrs.get("channels", {}).get("i", 0),
                    all_frames=op == "DecodeGif").set_name(name)) \
                    .inputs(dep(0))
            elif op == "ParseExample":
                node = Node(_parse_example(name, ins, attrs, const_of)
                            .set_name(name)).inputs(dep(0))
            else:
                raise ValueError(f"unsupported TF op {op} ({name})")
            graph_nodes[name] = node
            return node

        outputs = [emit(o) for o in self.output_names]
        ordered_inputs = []
        used = []
        for wi, want in enumerate(self.input_names):
            found = [nd for nm, nd in input_nodes if nm == want.split(":")[0]]
            if found:
                ordered_inputs.append(found[0])
                used.append(wi)
            elif self._nodes is None and input_nodes:
                # top-level legacy fallback; sub-loaders (while frames) skip
                # placeholders the subgraph doesn't reach
                ordered_inputs.append(input_nodes[0][1])
                used.append(wi)
        graph = nn.Graph(ordered_inputs,
                         outputs if len(outputs) > 1 else outputs[0],
                         device=device)
        graph._tf_import = True
        graph._tf_used_inputs = used
        return graph


@contextlib.contextmanager
def _recursion_for(n_nodes):
    """A recursion limit deep enough for a graph of ``n_nodes`` nodes: the
    loader's emit, the ``Graph``'s topological sort and a deep copy of the
    graph each recurse along its longest path (BERT-base's 12 layers are
    ~500 nodes deep, past Python's default limit of 1000 frames)."""
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * n_nodes + 1000))
    try:
        yield
    finally:
        sys.setrecursionlimit(old)


def _broadcast_gradient_args(s0, s1):
    """TF BroadcastGradientArgs: two shapes -> (r0, r1) reduction axes for
    each operand's gradient (reference ``utils/tf/loaders/
    BroadcastGradientArgs.scala``). Right-aligned broadcast; an axis where
    one operand is 1 and the other is not reduces for the size-1 side."""
    s0 = [int(v) for v in np.ravel(s0)]
    s1 = [int(v) for v in np.ravel(s1)]
    n = max(len(s0), len(s1))
    p0 = [1] * (n - len(s0)) + s0
    p1 = [1] * (n - len(s1)) + s1
    r0, r1 = [], []
    for i, (a, b) in enumerate(zip(p0, p1)):
        if a == b == 1:
            # TF (and reference nn/tf/ArrayOps.scala:238-242) reduce a
            # both-sides-1 axis for BOTH operands
            r0.append(i)
            r1.append(i)
            continue
        if a == b:
            continue
        if a == 1:
            r0.append(i)
        if b == 1:
            r1.append(i)
    return (np.asarray(r0, np.int32), np.asarray(r1, np.int32))


def _parse_example(name, ins, attrs, const_of):
    """The ``ParseExampleOp`` of a dense-only ``ParseExample`` node
    (inputs: serialized, names, sparse_keys[Nsparse], dense_keys[Ndense],
    dense_defaults[Ndense]); sparse features are refused, as in the
    reference (their 3 x Nsparse ports would precede the dense ones)."""
    from bigdl_tpu_torch.ops.tf_ops import ParseExampleOp
    nd = int(attrs.get("Ndense", {}).get("i", 0))
    ns = int(attrs.get("Nsparse", {}).get("i", 0))
    if ns:
        raise ValueError(
            f"ParseExample {name}: sparse features unsupported (dense-only, "
            "like the loader corpus the reference exercises)")
    keys = [const_of(i) for i in ins[2 + ns:2 + ns + nd]] if nd else []
    if nd and any(k is None for k in keys):
        raise ValueError(f"ParseExample {name}: dense_keys must be const")
    shp_list = attrs.get("dense_shapes", {}).get("list", {}).get("shape", [])
    shapes = [[d.get("size", -1) for d in s.get("dim", [])]
              for s in shp_list] or [[] for _ in range(nd)]
    types = [_DTYPES.get(t, np.float32) for t in
             attrs.get("Tdense", {}).get("list", {}).get("type", [])] \
        or [np.float32] * nd
    # TF writes "required, no default" as an empty tensor
    dflts = [const_of(i) for i in ins[2 + ns + nd:2 + ns + 2 * nd]]
    dflts = [None if d is None or np.size(d) == 0 else d
             for d in dflts] + [None] * (nd - len(dflts))
    return ParseExampleOp([np.ravel(k)[0] if np.ndim(k) else k
                           for k in keys], shapes, types,
                          dense_defaults=dflts)


def _static_trip_count(vars_, by_name, const_of, loopcond, inits):
    """Detect the tf.while_loop counter pattern — cond = Less(var_i, N
    const), body var_i' = var_i + 1, const init — so the loop runs a fixed
    number of times (differentiable) instead of reading its condition."""
    cnode = by_name.get(loopcond["inputs"][0].partition(":")[0])
    if cnode is None or cnode["op"] != "Less":
        return None
    a_base = cnode["inputs"][0].partition(":")[0]
    idx = next((i for i, v in enumerate(vars_)
                if v["merge"]["name"] == a_base), None)
    if idx is None:
        return None
    limit = const_of(cnode["inputs"][1])
    if limit is None:
        return None
    kind, init = inits[idx]
    if kind != "const":
        return None
    b = by_name.get(vars_[idx]["nextit"]["inputs"][0].partition(":")[0])
    if b is None or b["op"] not in ("Add", "AddV2"):
        return None
    var_names = {vars_[idx]["merge"]["name"]}
    if vars_[idx]["switch"] is not None:
        var_names.add(vars_[idx]["switch"]["name"])
    incr, from_var = None, False
    for ref in b["inputs"]:
        if ref.partition(":")[0] in var_names:
            from_var = True
        else:
            incr = const_of(ref)
    if not from_var or incr is None or int(np.ravel(incr)[0]) != 1:
        return None
    return max(int(np.ravel(limit)[0]) - int(np.ravel(init)[0]), 0)


def _items(x):
    if isinstance(x, Table):
        return [v for _, v in sorted_items(x)]
    return list(x)


class _TFWhileModule(Module):
    """A converted Enter..Exit frame: the carry is the frame's loop
    variables (module docstring). A static trip count runs the body that
    many times; otherwise the condition graph is read on the host before
    each iteration (``host_syncs`` counts the reads). The reference
    compiles these frames to ``lax.scan``/``lax.while_loop``.

    Wired inputs (a list in order): the non-const Enter initials, then the
    captured is_constant Enter values. Const initials are closed over;
    TensorArray accumulators start as zero stacks. The output is the list
    of the final loop variables.
    """

    # the reference's params and state: {"cond": ..., "body": ...}
    param_children = (("cond_graph", "cond"), ("body_graph", "body"))

    def __init__(self, cond_graph, body_graph, inits, n_caps, trip=None):
        super().__init__()
        self.cond_graph = cond_graph
        self.body_graph = body_graph
        self.inits = inits
        self.n_caps = n_caps
        self.trip = trip
        self.n_vars = len(inits)
        self.host_syncs = 0

    def _wired_list(self, x):
        n_wired = sum(1 for k, _ in self.inits if k == "node") + self.n_caps
        if n_wired == 0:
            return []
        if n_wired == 1:
            return [x]
        return _items(x)

    def _assemble(self, wired):
        from bigdl_tpu_torch.ops.tf_ops import as_tensor, jax_dtype
        device = wired[0].device
        vals, w = [], list(wired)
        for kind, payload in self.inits:
            if kind == "const":
                vals.append(as_tensor(payload, device))
            elif kind == "zeros":
                size, shape, dt = payload
                vals.append(torch.zeros((size,) + tuple(shape),
                                        dtype=jax_dtype(dt), device=device))
            else:
                vals.append(w.pop(0))
        return vals, w  # remaining wired values are the captures

    def _feed(self, graph, vals, caps):
        full = list(vals) + list(caps)
        used = getattr(graph, "_tf_used_inputs", list(range(len(full))))
        sel = [full[i] for i in used]
        return sel[0] if len(sel) == 1 else sel

    def forward(self, x, generator=None):
        vals, caps = self._assemble(self._wired_list(x))

        def run(graph, carry):
            return call_with_generator(graph, self._feed(graph, carry, caps),
                                       generator)

        def body(carry):
            y = run(self.body_graph, carry)
            outs = y if isinstance(y, list) else [y]
            return [o.to(c.dtype).reshape(c.shape)
                    for o, c in zip(outs, carry)]

        carry = list(vals)
        if self.trip is not None:
            for _ in range(self.trip):
                carry = body(carry)
            return carry
        while True:
            self.host_syncs += 1
            if not bool(run(self.cond_graph, carry).reshape(()).item()):
                return carry
            carry = body(carry)


class _PadModule(Module):
    """Constant Pad with a TF paddings matrix."""

    def __init__(self, pads):
        super().__init__()
        self.pads = [tuple(int(v) for v in p) for p in np.asarray(pads)]

    def output_hw(self, h, w):
        (t, b), (l, r) = self.pads[1], self.pads[2]
        return h + t + b, w + l + r

    def forward(self, x):
        flat = [v for lo, hi in reversed(self.pads) for v in (lo, hi)]
        return torch.nn.functional.pad(x, flat)


class _ConstBinary(Module):
    """Binary elementwise op with one constant side closed over."""

    def __init__(self, fn, c0, c1):
        super().__init__()
        self.fn = fn
        self.c0, self.c1 = c0, c1
        self._on = {}    # the constant as a tensor, by device

    def forward(self, x):
        from bigdl_tpu_torch.ops.tf_ops import as_tensor
        c = self.c0 if self.c0 is not None else self.c1
        if x.device not in self._on:
            self._on[x.device] = as_tensor(c, x.device)
        if self.c0 is not None:
            return self.fn(self._on[x.device], x)
        return self.fn(x, self._on[x.device])


class _Rsqrt(Module):
    def forward(self, x):
        return torch.rsqrt(x)


def _unary_ops():
    """TF unary op -> existing module classes (no duplicate math)."""
    from bigdl_tpu_torch import nn, ops
    return {"Sqrt": nn.Sqrt, "Rsqrt": _Rsqrt, "Square": nn.Square,
            "Neg": nn.Negative, "Exp": nn.Exp, "Log": nn.Log,
            "Erf": ops.Erf, "Abs": nn.Abs, "Floor": ops.Floor,
            "Ceil": ops.Ceil, "Sign": ops.Sign, "LogSoftmax": nn.LogSoftMax}


class _TransposeModule(Module):
    def __init__(self, perm):
        super().__init__()
        self.perm = tuple(perm)

    def forward(self, x):
        return x.permute(*self.perm)


class _EinsumModule(Module):
    def __init__(self, equation):
        super().__init__()
        self.equation = equation

    def forward(self, *xs):
        from bigdl_tpu_torch.ops.tf_ops import _elems
        return torch.einsum(self.equation, *_elems(xs))


class _SquaredDiffTable(Module):
    def forward(self, *xs):
        from bigdl_tpu_torch.ops.tf_ops import _elems
        a, b = _elems(xs)
        return torch.square(a - b)


class _GatherWeight(Module):
    """Trainable embedding table fed by a Gather op."""

    jax_perms = {"weight": None}    # the same (rows, ...) table in both

    def __init__(self, shape, device=None, dtype=torch.float32):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.weight = torch.nn.Parameter(torch.zeros(
            self.shape, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        from bigdl_tpu_torch.ops.tf_ops import _take
        return _take(self.weight, x, 0)

    def init_arrays(self, rng):
        return {"weight": np.zeros(self.shape)}


def apply_tf_weights(graph):
    """Copy the imported tensors into the graph's layers (recursing into
    converted while-loop sub-graphs), each through
    ``nn.module.jax_layout`` (module docstring)."""
    _apply_tf_weights_into(graph.exec_order)
    graph._tf_weights_applied = True
    return graph


def _apply_tf_weights_into(exec_order):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.convert import _leaf_from_jax
    from bigdl_tpu_torch.ops.tf_ops import TFConv3D

    def put(m, leaf, a):
        t = getattr(m, leaf)
        v = _leaf_from_jax(m, leaf, np.asarray(a, np.float32))
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{m.get_name()}: a tensor of shape "
                             f"{tuple(np.shape(a))} does not fit {leaf} "
                             f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(v)

    for node in exec_order:
        m = node.module
        if isinstance(m, _TFWhileModule):
            _apply_tf_weights_into(m.cond_graph.exec_order)
            _apply_tf_weights_into(m.body_graph.exec_order)
            continue
        w = getattr(m, "_tf_weight", None)
        if w is None:
            continue
        if isinstance(m, (nn.Linear, nn.SpatialConvolution, nn.CMul,
                          _GatherWeight, TFConv3D)):
            put(m, "weight", w)
        elif isinstance(m, nn.CAdd):
            put(m, "bias", w)
        elif isinstance(m, nn.SpatialBatchNormalization):
            scale, offset, mean, var = w
            put(m, "weight", scale)
            put(m, "bias", offset)
            put(m, "running_mean", mean)
            put(m, "running_var", var)


def _sample_values(sample, device="cpu"):
    """A forward's input from ``sample_input``: a tensor or an array as
    it is (an array's 64-bit types as the reference's 32-bit ones; one of
    strings or bytes on the host), zeros for a shape, a list of them for
    several inputs."""
    from bigdl_tpu_torch.ops.tf_ops import as_tensor
    from bigdl_tpu_torch.utils.shape import _is_shape_tuple
    if isinstance(sample, torch.Tensor):
        return sample.to(device)
    if isinstance(sample, np.ndarray) and sample.dtype == object:
        return sample
    if _is_shape_tuple(sample):
        return torch.zeros(tuple(int(d) for d in sample), device=device)
    if isinstance(sample, (list, tuple)):
        return [_sample_values(s, device) for s in sample]
    return as_tensor(sample, device)


def load_tf(graph_path, inputs, outputs, bin_dir=None, sample_input=None,
            device=None):
    """(reference ``Module.loadTF:93``) The imported graph on ``device``
    (default the card). With ``sample_input`` (a shape, an array or
    tensor, or a list of them for several inputs) the imported weights are
    applied, a CPU copy runs one forward on the sample to check that it
    fits, as the reference's build does, and the graph is put in
    evaluation mode."""
    from bigdl_tpu_torch.utils.shape import _cpu_copy
    graph = TensorflowLoader(graph_path, inputs, outputs,
                             bin_dir).load(device=device)
    if sample_input is not None:
        apply_tf_weights(graph)
        with torch.no_grad(), _recursion_for(len(graph.exec_order)):
            _cpu_copy(graph).eval()(_sample_values(sample_input))
        graph.evaluate()
    return graph
