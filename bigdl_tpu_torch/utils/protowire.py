"""Minimal protobuf wire-format decoder and encoder driven by schema dicts
(the port of ``bigdl_tpu/utils/protowire.py``, copied: it needs neither
protobuf nor torch).

One generic decoder walks the wire format and a per-format schema dict
(``interop/caffe.py``) names the fields that matter; unknown fields are
skipped, as protobuf's own unknown-field rule does, so loaders stay robust
across producer versions. :func:`encode` is its inverse and fixes the
field order (the data dict's), so both packages write the same bytes for
the same dict.

Schema entry: field_number -> (name, kind) where kind is
  "int" | "sint" | "float" | "double" | "bytes" | "string" | "floats_packed"
  | "ints_packed" | ("msg", subschema) — and name endswith "[]" for repeated.
"""

from __future__ import annotations

import struct


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(n):
    return (n >> 1) ^ -(n & 1)


def _sign_extend(n):
    """Varint int32/int64 fields carry negatives as 64-bit two's complement
    (protobuf encoding rule): re-interpret bit 63 as the sign."""
    n &= (1 << 64) - 1
    return n - (1 << 64) if n & (1 << 63) else n


def decode(buf, schema):
    """Decode ``buf`` into a dict according to ``schema``. Nested messages
    are walked with a stack of their own, not by recursion, so a message
    nests as deep as the data does (a graph's chain of nodes)."""
    root = {}
    stack = [(buf, 0, schema, root)]
    while stack:
        buf, pos, schema, out = stack.pop()
        end = len(buf)
        while pos < end:
            key, pos = _read_varint(buf, pos)
            field, wire = key >> 3, key & 7
            spec = schema.get(field)
            if wire == 0:
                value, pos = _read_varint(buf, pos)
            elif wire == 1:
                value = buf[pos:pos + 8]
                pos += 8
            elif wire == 5:
                value = buf[pos:pos + 4]
                pos += 4
            elif wire == 2:
                ln, pos = _read_varint(buf, pos)
                value = buf[pos:pos + ln]
                pos += ln
            elif wire in (3, 4):  # group (obsolete) — skip silently
                continue
            else:
                raise ValueError(f"bad wire type {wire} at {pos}")
            if spec is None:
                continue
            name, kind = spec
            repeated = name.endswith("[]")
            if repeated:
                name = name[:-2]
            nested = isinstance(kind, tuple) and kind[0] == "msg"
            # a message's dict takes its place now, its fields after the
            # rest of this one's are read
            data = {} if nested else _convert(value, kind, wire)
            if not repeated:
                out[name] = data
            elif isinstance(data, list):
                out.setdefault(name, []).extend(data)
            else:
                out.setdefault(name, []).append(data)
            if nested:
                stack.append((buf, pos, schema, out))
                stack.append((value, 0, kind[1], data))
                break
    return root


def encode(data, schema):
    """Inverse of :func:`decode`: build wire bytes from a dict + schema.
    Used by the model savers (CaffePersister / TensorflowSaver parity).
    Like :func:`decode` it keeps a stack of its own for nested messages."""
    stack = [(None, bytearray(), _pieces(data, schema))]
    while True:
        field, out, pieces = stack[-1]
        for piece in pieces:
            if isinstance(piece, tuple):      # a message: encode it first
                stack.append((piece[0], bytearray(),
                              _pieces(piece[1], piece[2])))
                break
            out += piece
        else:
            stack.pop()
            if not stack:
                return bytes(out)
            parent = stack[-1][1]
            parent += _encode_key(field, 2)
            parent += _encode_varint(len(out))
            parent += out


def _pieces(data, schema):
    """The encoding of ``data``'s fields in order: bytes, or ``(field,
    message, subschema)`` for a nested message to encode in its place."""
    by_name = {}
    for field, (name, kind) in schema.items():
        by_name[name[:-2] if name.endswith("[]") else name] = (field, name, kind)
    for key, value in data.items():
        if key not in by_name:
            continue
        field, name, kind = by_name[key]
        if kind in ("floats_packed", "doubles_packed") \
                and (isinstance(value, (list, tuple))
                     or hasattr(value, "tobytes")):
            if hasattr(value, "tobytes"):  # numpy fast path for weight blobs
                import numpy as _np
                dt = "<f4" if kind == "floats_packed" else "<f8"
                payload = _np.ascontiguousarray(value, dtype=dt).ravel().tobytes()
            else:
                fmt = "<f" if kind == "floats_packed" else "<d"
                payload = b"".join(struct.pack(fmt, float(v)) for v in value)
            yield _encode_key(field, 2) + _encode_varint(len(payload)) + payload
            continue
        values = value if name.endswith("[]") and isinstance(value, list) \
            else [value]
        for v in values:
            if isinstance(kind, tuple) and kind[0] == "msg":
                yield field, v, kind[1]
            else:
                yield _encode_field(field, kind, v)


def _encode_varint(n):
    n &= (1 << 64) - 1  # negatives ride as 64-bit two's complement
    b = bytearray()
    while True:
        piece = n & 0x7F
        n >>= 7
        if n:
            b.append(piece | 0x80)
        else:
            b.append(piece)
            return bytes(b)


def _encode_key(field, wire):
    return _encode_varint((field << 3) | wire)


def _encode_field(field, kind, v):
    if kind in ("int", "bool"):
        return _encode_key(field, 0) + _encode_varint(int(v))
    if kind == "float":
        return _encode_key(field, 5) + struct.pack("<f", float(v))
    if kind == "double":
        return _encode_key(field, 1) + struct.pack("<d", float(v))
    if kind == "floats_packed":
        return _encode_key(field, 5) + struct.pack("<f", float(v))
    if kind == "doubles_packed":
        return _encode_key(field, 1) + struct.pack("<d", float(v))
    if kind == "string":
        data = v.encode("utf-8")
        return _encode_key(field, 2) + _encode_varint(len(data)) + data
    if kind == "bytes":
        return _encode_key(field, 2) + _encode_varint(len(v)) + v
    raise ValueError(f"cannot encode kind {kind}")


def _convert(value, kind, wire):
    if kind == "int":
        if wire == 2:  # packed repeated varints
            vals, pos = [], 0
            while pos < len(value):
                v, pos = _read_varint(value, pos)
                vals.append(_sign_extend(v))
            return vals
        return _sign_extend(value)
    if kind == "sint":
        return _zigzag(value)
    if kind == "float":
        return struct.unpack("<f", value)[0]
    if kind == "double":
        return struct.unpack("<d", value)[0]
    if kind == "floats_packed":
        if wire == 5:
            return [struct.unpack("<f", value)[0]]
        return list(struct.unpack(f"<{len(value) // 4}f", value))
    if kind == "doubles_packed":
        if wire == 1:
            return [struct.unpack("<d", value)[0]]
        return list(struct.unpack(f"<{len(value) // 8}d", value))
    if kind == "string":
        if isinstance(value, memoryview):  # zero-copy record-shard path
            value = value.tobytes()
        return value.decode("utf-8", errors="replace")
    if kind == "bytes":
        return value
    if kind == "bool":
        return bool(value)
    raise ValueError(f"unknown kind {kind}")
