"""Minimal ONNX reader: pure-Python protobuf wire-format parsing.

The ``onnx`` package is not available in this image, but ONNX files are
plain protobuf, and extracting initializers (weights) plus the node graph
needs only the wire format: varint-keyed fields, length-delimited messages,
and packed repeated ints. This module implements exactly that subset.

Field numbers (onnx.proto3):
  ModelProto:  graph = 7
  GraphProto:  node = 1, initializer = 5, input = 11, output = 12
  NodeProto:   input = 1, output = 2, name = 3, op_type = 4
  TensorProto: dims = 1, data_type = 2, float_data = 4, int64_data = 7,
               name = 8, raw_data = 9
  ValueInfoProto: name = 1

A copy of the JAX package's module (numpy only). ``utils/spm_lite`` reads
sentencepiece models with its wire parser (``_fields``, ``_read_varint``);
the rest is the reader the PaddleOCR detector (``detection/paddle.py``,
through ``detection/paddle_onnx.py``) loads its ONNX weights with (the
reference runs them via the ``rusty-manga-image-translator`` ORT wheel —
detection/common_rust.py:14-63).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

# TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    Length-delimited values come back as memoryview slices."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                    # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                    # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f'unsupported wire type {wire}')
        yield field, wire, val


def _packed_varints(buf: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag_to_int(v: int) -> int:
    # dims are plain int64 varints (not zigzag) in onnx; keep as-is but
    # interpret two's complement for negatives
    return v - (1 << 64) if v >= (1 << 63) else v


class OnnxNode(NamedTuple):
    op_type: str
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    attrs: Dict[str, object] = {}


class OnnxGraph(NamedTuple):
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]
    outputs: List[str]


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ''
    raw = None
    floats = None
    int64s: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 2:
                dims.extend(_zigzag_to_int(v) for v in _packed_varints(val))
            else:
                dims.append(_zigzag_to_int(val))
        elif field == 2:
            dtype = val
        elif field == 4:
            floats = np.frombuffer(bytes(val), np.float32) if wire == 2 \
                else None
        elif field == 7:
            if wire == 2:
                int64s.extend(_packed_varints(val))
            else:
                int64s.append(val)
        elif field == 8:
            name = bytes(val).decode('utf-8')
        elif field == 9:
            raw = bytes(val)
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f'tensor {name}: unsupported data_type {dtype}')
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats is not None:
        arr = floats
    elif int64s:
        arr = np.array([_zigzag_to_int(v) for v in int64s], np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    # dims == [] is a true 0-d scalar tensor (e.g. Gather indices) — keep
    # it 0-d; rank-1 weights always carry explicit dims
    return name, arr.reshape(dims)


def _parse_attribute(buf: bytes):
    """AttributeProto → (name, python value).

    Fields (onnx.proto3): name=1, f=2 (float32), i=3 (int64), s=4 (bytes),
    t=5 (TensorProto), floats=7, ints=8, strings=9. The graph/sparse
    variants are not needed by any model this framework reads.
    """
    name = ''
    value = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[str] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            name = bytes(val).decode('utf-8')
        elif field == 2:
            value = float(np.frombuffer(bytes(val), np.float32)[0])
        elif field == 3:
            value = _zigzag_to_int(val)
        elif field == 4:
            value = bytes(val).decode('utf-8', errors='replace')
        elif field == 5:
            value = _parse_tensor(bytes(val))[1]
        elif field == 7:
            if wire == 2:
                floats.extend(np.frombuffer(bytes(val), np.float32)
                              .tolist())
            else:
                floats.append(float(np.frombuffer(bytes(val),
                                                  np.float32)[0]))
        elif field == 8:
            if wire == 2:
                ints.extend(_zigzag_to_int(v)
                            for v in _packed_varints(val))
            else:
                ints.append(_zigzag_to_int(val))
        elif field == 9:
            strings.append(bytes(val).decode('utf-8', errors='replace'))
    if floats:
        value = floats
    elif ints:
        value = ints
    elif strings:
        value = strings
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ''
    op_type = ''
    attrs: Dict[str, object] = {}
    for field, wire, val in _fields(buf):
        if field == 1:
            inputs.append(bytes(val).decode('utf-8'))
        elif field == 2:
            outputs.append(bytes(val).decode('utf-8'))
        elif field == 3:
            name = bytes(val).decode('utf-8')
        elif field == 4:
            op_type = bytes(val).decode('utf-8')
        elif field == 5:
            aname, avalue = _parse_attribute(bytes(val))
            attrs[aname] = avalue
    return OnnxNode(op_type, name, tuple(inputs), tuple(outputs), attrs)


def _value_info_name(buf: bytes) -> str:
    for field, wire, val in _fields(buf):
        if field == 1:
            return bytes(val).decode('utf-8')
    return ''


def parse_graph(buf: bytes) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    g_in: List[str] = []
    g_out: List[str] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            nodes.append(_parse_node(bytes(val)))
        elif field == 5:
            name, arr = _parse_tensor(bytes(val))
            inits[name] = arr
        elif field == 11:
            g_in.append(_value_info_name(bytes(val)))
        elif field == 12:
            g_out.append(_value_info_name(bytes(val)))
    return OnnxGraph(nodes, inits, g_in, g_out)


def parse_model(data: bytes) -> OnnxGraph:
    """Parse an ONNX ModelProto blob into its graph."""
    for field, wire, val in _fields(data):
        if field == 7:
            return parse_graph(bytes(val))
    raise ValueError('no GraphProto found in model')


def load(path) -> OnnxGraph:
    with open(path, 'rb') as f:
        return parse_model(f.read())
