"""Minimal ONNX protobuf wire-format writer/reader (counterpart:
``paddle_tpu/onnx/_proto.py``, copied: it is backend-neutral, and
``graph_proto`` joins its parts once, linear in the file's size). No `onnx`
package is needed.

Implements exactly the message subset `export` emits, with the field
numbers of the public onnx.proto3 schema (ModelProto, GraphProto,
NodeProto, AttributeProto, TensorProto, ValueInfoProto, TypeProto,
TensorShapeProto, OperatorSetIdProto). Files written here load in any
standard ONNX tooling; the bundled reader exists so tests can verify the
artifact without the package.
"""
import struct

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL, FLOAT16, DOUBLE = \
    1, 2, 3, 6, 7, 9, 10, 11

# AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR, A_FLOATS, A_INTS, A_STRINGS = \
    1, 2, 3, 4, 6, 7, 8


def _varint(n):
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _len_field(field, payload):
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field, value):
    return _tag(field, 0) + _varint(value)


def _float_field(field, value):
    return _tag(field, 5) + struct.pack("<f", value)


def _str_field(field, s):
    return _len_field(field, s.encode() if isinstance(s, str) else s)


def tensor_proto(name, dims, data_type, raw):
    out = b""
    for d in dims:
        out += _int_field(1, int(d))
    out += _int_field(2, data_type)
    out += _str_field(8, name)
    out += _len_field(9, raw)
    return out


def attr_f(name, v):
    return _str_field(1, name) + _float_field(2, v) + _int_field(20, A_FLOAT)


def attr_i(name, v):
    return _str_field(1, name) + _int_field(3, int(v)) + _int_field(20, A_INT)


def attr_s(name, v):
    return _str_field(1, name) + _str_field(4, v) + _int_field(20, A_STRING)


def attr_ints(name, vals):
    out = _str_field(1, name)
    for v in vals:
        out += _int_field(8, int(v))
    return out + _int_field(20, A_INTS)


def attr_floats(name, vals):
    out = _str_field(1, name)
    for v in vals:
        out += _tag(7, 5) + struct.pack("<f", v)
    return out + _int_field(20, A_FLOATS)


def attr_t(name, tensor):
    return _str_field(1, name) + _len_field(5, tensor) + \
        _int_field(20, A_TENSOR)


def node_proto(op_type, inputs, outputs, name="", attrs=()):
    out = b""
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    for a in attrs:
        out += _len_field(5, a)
    return out


def _shape_proto(dims):
    out = b""
    for d in dims:
        if d is None or (isinstance(d, int) and d < 0):
            dim = _str_field(2, "batch")
        else:
            dim = _int_field(1, int(d))
        out += _len_field(1, dim)
    return out


def value_info(name, elem_type, dims):
    tens = _int_field(1, elem_type) + _len_field(2, _shape_proto(dims))
    ty = _len_field(1, tens)
    return _str_field(1, name) + _len_field(2, ty)


def graph_proto(nodes, name, initializers, inputs, outputs):
    # one join: a loop of += over ResNet-50's 100 MB of initializers
    # copies the growing message at every step
    parts = [_len_field(1, n) for n in nodes]
    parts.append(_str_field(2, name))
    parts += [_len_field(5, t) for t in initializers]
    parts += [_len_field(11, i) for i in inputs]
    parts += [_len_field(12, o) for o in outputs]
    return b"".join(parts)


def model_proto(graph, opset=13, producer="paddle_tpu"):
    out = _int_field(1, 8)  # ir_version
    out += _str_field(2, producer)
    out += _len_field(7, graph)
    opset_id = _int_field(2, opset)  # default domain ""
    out += _len_field(8, opset_id)
    return out


# ---------------------------------------------------------------------------
# reader (verification only: field walk, no full schema)
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def parse_fields(buf):
    """[(field, wire, value)] — length-delimited values come back as bytes."""
    out = []
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
        out.append((field, wire, v))
    return out


def read_model(path):
    """Decode enough of a .onnx file to verify it: returns
    {"producer", "opset", "nodes": [(op_type, inputs, outputs)],
    "initializers": [(name, dims)], "inputs": [...], "outputs": [...]}."""
    with open(path, "rb") as f:
        buf = f.read()
    model = {"nodes": [], "initializers": [], "inputs": [], "outputs": []}
    for field, _, v in parse_fields(buf):
        if field == 2:
            model["producer"] = v.decode()
        elif field == 8:
            for f2, _, v2 in parse_fields(v):
                if f2 == 2:
                    model["opset"] = v2
        elif field == 7:
            for f2, _, v2 in parse_fields(v):
                if f2 == 1:  # node
                    ins, outs, op = [], [], ""
                    for f3, _, v3 in parse_fields(v2):
                        if f3 == 1:
                            ins.append(v3.decode())
                        elif f3 == 2:
                            outs.append(v3.decode())
                        elif f3 == 4:
                            op = v3.decode()
                    model["nodes"].append((op, ins, outs))
                elif f2 == 5:  # initializer
                    dims, name = [], ""
                    for f3, _, v3 in parse_fields(v2):
                        if f3 == 1:
                            dims.append(v3)
                        elif f3 == 8:
                            name = v3.decode()
                    model["initializers"].append((name, dims))
                elif f2 == 11:
                    model["inputs"].append(parse_fields(v2)[0][2].decode())
                elif f2 == 12:
                    model["outputs"].append(parse_fields(v2)[0][2].decode())
    return model
