"""Dependency-free ONNX (protobuf wire format) reader/writer: the port's
copy of the JAX package's ``io/onnx_lite.py``, byte for byte in what it
reads and writes.

No ``onnx`` package is needed; this module speaks the wire format directly
for the subset the weight pipeline needs:

- read: ModelProto -> graph name, initializers (name, dims, dtype,
  ndarray), input/output names; external-data tensors resolved relative to
  the model file (the reference's exports used external blobs — its build
  tooling regression-tested blob staging, tools/build_trt/
  test_stage_external_data.py).
- write: weight-carrying ModelProto (initializers + graph IO value infos),
  optionally spilling large tensors to an external data file.

Field numbers per onnx.proto3 (stable public schema):
  ModelProto: ir_version=1, opset_import=8(OperatorSetIdProto: version=2),
              producer_name=2, graph=7
  GraphProto: node=1, name=2, initializer=5, input=11, output=12
  TensorProto: dims=1, data_type=2, float_data=4, int32_data=5, name=8,
               int64_data=7, raw_data=9, external_data=13, data_location=14
  NodeProto: input=1, output=2, name=3, op_type=4, attribute=5
  AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20
  ValueInfoProto: name=1, type=2; TypeProto: tensor_type=1;
  TypeProto.Tensor: elem_type=1, shape=2; TensorShapeProto: dim=1;
  Dimension: dim_value=1, dim_param=2
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# ONNX TensorProto.DataType
DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}
BFLOAT16_CODE = 16


# ---------------- wire primitives ----------------

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


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes):
    """Yields (field_no, wire_type, value, start, end) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
            yield fno, wt, v
        elif wt == 1:
            yield fno, wt, buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            yield fno, wt, buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            yield fno, wt, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _field(out: bytearray, fno: int, wt: int) -> None:
    _write_varint(out, (fno << 3) | wt)


def _put_bytes(out: bytearray, fno: int, data: bytes) -> None:
    _field(out, fno, 2)
    _write_varint(out, len(data))
    out.extend(data)


def _put_varint_field(out: bytearray, fno: int, v: int) -> None:
    _field(out, fno, 0)
    _write_varint(out, v)


# ---------------- reading ----------------

@dataclass
class OnnxTensor:
    name: str
    dims: Tuple[int, ...]
    dtype_code: int
    array: Optional[np.ndarray] = None


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class OnnxModel:
    graph_name: str = ""
    producer: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    initializers: Dict[str, OnnxTensor] = field(default_factory=dict)
    node_ops: List[str] = field(default_factory=list)
    nodes: List[OnnxNode] = field(default_factory=list)


def _parse_packed_varints(data: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(v)
    return out


def _parse_tensor(buf: bytes, base_dir: str) -> OnnxTensor:
    name = ""
    dims: List[int] = []
    dtype_code = 0
    raw: Optional[bytes] = None
    floats: List[bytes] = []
    int64s: List[bytes] = []
    external: Dict[str, str] = {}
    data_location = 0
    for fno, wt, v in _iter_fields(buf):
        if fno == 1:
            if wt == 0:
                dims.append(v)
            else:
                dims.extend(_parse_packed_varints(v))
        elif fno == 2 and wt == 0:
            dtype_code = v
        elif fno == 4:
            floats.append(v if wt == 2 else bytes(v))
        elif fno == 7:
            int64s.append(v if wt == 2 else None)
            if wt == 0:
                int64s[-1] = struct.pack("<q", v)
        elif fno == 8 and wt == 2:
            name = v.decode("utf-8")
        elif fno == 9 and wt == 2:
            raw = bytes(v)
        elif fno == 13 and wt == 2:
            kk, vv = "", ""
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1 and w2 == 2:
                    kk = v2.decode()
                elif f2 == 2 and w2 == 2:
                    vv = v2.decode()
            external[kk] = vv
        elif fno == 14 and wt == 0:
            data_location = v

    t = OnnxTensor(name, tuple(dims), dtype_code)
    np_dtype = DTYPES.get(dtype_code)
    if data_location == 1 and external:  # EXTERNAL
        loc = external.get("location", "")
        off = int(external.get("offset", "0") or 0)
        length = int(external.get("length", "0") or 0)
        path = os.path.join(base_dir, loc)
        with open(path, "rb") as f:
            f.seek(off)
            blob = f.read(length) if length else f.read()
        raw = blob
    if raw is not None and np_dtype is not None:
        t.array = np.frombuffer(raw, dtype=np_dtype).reshape(t.dims).copy()
    elif raw is not None and dtype_code == BFLOAT16_CODE:
        u32 = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        t.array = u32.view(np.float32).reshape(t.dims).copy()
    elif floats:
        data = b"".join(floats)
        t.array = np.frombuffer(data, dtype="<f4").reshape(t.dims).copy()
    elif int64s and all(x is not None for x in int64s):
        data = b"".join(int64s)
        t.array = np.frombuffer(data, dtype="<i8").reshape(t.dims).copy()
    return t


def _value_info_name(buf: bytes) -> str:
    for fno, wt, v in _iter_fields(buf):
        if fno == 1 and wt == 2:
            return v.decode("utf-8")
    return ""


def _zigzag_to_int(v: int) -> int:
    """Protobuf int64 varints are two's-complement encoded (not zigzag for
    non-sint fields): values >= 2^63 are negative."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attribute(buf: bytes, base_dir: str) -> Tuple[str, object]:
    name = ""
    val: object = None
    atype = 0
    floats: List[float] = []
    ints: List[int] = []
    for fno, wt, v in _iter_fields(buf):
        if fno == 1 and wt == 2:
            name = v.decode("utf-8")
        elif fno == 2 and wt == 5:
            val = struct.unpack("<f", v)[0]
        elif fno == 3 and wt == 0:
            val = _zigzag_to_int(v)
        elif fno == 4 and wt == 2:
            val = v.decode("utf-8", "replace")
        elif fno == 5 and wt == 2:
            val = _parse_tensor(v, base_dir)
        elif fno == 7:
            if wt == 5:
                floats.append(struct.unpack("<f", v)[0])
            elif wt == 2:
                floats.extend(struct.unpack(f"<{len(v)//4}f", v))
        elif fno == 8:
            if wt == 0:
                ints.append(_zigzag_to_int(v))
            elif wt == 2:
                ints.extend(_zigzag_to_int(x) for x in _parse_packed_varints(v))
        elif fno == 20 and wt == 0:
            atype = v
    if floats:
        val = floats
    if ints:
        val = ints
    if val is None and not floats and not ints:
        # proto3 serializers (onnx, torch.onnx) OMIT scalar fields equal to
        # the default — an attribute like Gather(axis=0) arrives as name +
        # type only. Materialize the typed default so consumers don't see
        # None for a key that exists (AttributeProto.type: 1=FLOAT 2=INT
        # 3=STRING 6=FLOATS 7=INTS).
        val = {1: 0.0, 2: 0, 3: "", 6: [], 7: []}.get(atype)
    return name, val


def _parse_node(buf: bytes, base_dir: str) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fno, wt, v in _iter_fields(buf):
        if fno == 1 and wt == 2:
            node.inputs.append(v.decode("utf-8"))
        elif fno == 2 and wt == 2:
            node.outputs.append(v.decode("utf-8"))
        elif fno == 3 and wt == 2:
            node.name = v.decode("utf-8", "replace")
        elif fno == 4 and wt == 2:
            node.op_type = v.decode("utf-8")
        elif fno == 5 and wt == 2:
            k, val = _parse_attribute(v, base_dir)
            node.attrs[k] = val
    return node


def read_onnx(path: str) -> OnnxModel:
    with open(path, "rb") as f:
        buf = f.read()
    base_dir = os.path.dirname(os.path.abspath(path))
    model = OnnxModel()
    graph = None
    for fno, wt, v in _iter_fields(buf):
        if fno == 2 and wt == 2:
            model.producer = v.decode("utf-8", "replace")
        elif fno == 7 and wt == 2:
            graph = v
    if graph is None:
        raise ValueError(f"{path}: no GraphProto found")
    for fno, wt, v in _iter_fields(graph):
        if fno == 2 and wt == 2:
            model.graph_name = v.decode("utf-8", "replace")
        elif fno == 5 and wt == 2:
            t = _parse_tensor(v, base_dir)
            model.initializers[t.name] = t
        elif fno == 11 and wt == 2:
            model.inputs.append(_value_info_name(v))
        elif fno == 12 and wt == 2:
            model.outputs.append(_value_info_name(v))
        elif fno == 1 and wt == 2:
            node = _parse_node(v, base_dir)
            model.nodes.append(node)
            model.node_ops.append(node.op_type)
    return model


# ---------------- writing ----------------

def _tensor_bytes(name: str, arr: np.ndarray, external: Optional[Tuple[str, int]] = None) -> bytes:
    out = bytearray()
    for d in arr.shape:
        _put_varint_field(out, 1, int(d))
    code = DTYPE_CODES.get(np.dtype(arr.dtype))
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
    _put_varint_field(out, 2, code)
    _put_bytes(out, 8, name.encode("utf-8"))
    if external is None:
        _put_bytes(out, 9, np.ascontiguousarray(arr).tobytes())
    else:
        loc, off = external
        for k, v in (("location", loc), ("offset", str(off)),
                     ("length", str(arr.nbytes))):
            entry = bytearray()
            _put_bytes(entry, 1, k.encode())
            _put_bytes(entry, 2, v.encode())
            _put_bytes(out, 13, bytes(entry))
        _put_varint_field(out, 14, 1)  # data_location = EXTERNAL
    return bytes(out)


def _value_info_bytes(name: str, spec: Optional[Tuple[int, Tuple]] = None) -> bytes:
    """spec = (elem_type_code, dims) where each dim is an int (fixed) or a
    str (dynamic dim_param). Typed value infos make the graph consumable by
    real runtimes (ORT requires elem_type+shape on graph inputs)."""
    out = bytearray()
    _put_bytes(out, 1, name.encode("utf-8"))
    if spec is not None:
        elem, dims = spec
        shape = bytearray()
        for d in dims:
            dim = bytearray()
            if isinstance(d, str):
                _put_bytes(dim, 2, d.encode("utf-8"))
            else:
                _put_varint_field(dim, 1, int(d))
            _put_bytes(shape, 1, bytes(dim))
        tensor_type = bytearray()
        _put_varint_field(tensor_type, 1, elem)
        _put_bytes(tensor_type, 2, bytes(shape))
        type_proto = bytearray()
        _put_bytes(type_proto, 1, bytes(tensor_type))
        _put_bytes(out, 2, bytes(type_proto))
    return bytes(out)


# AttributeProto.AttributeType codes
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS = 6, 7


def _int64_varint(out: bytearray, fno: int, v: int) -> None:
    _field(out, fno, 0)
    _write_varint(out, v & ((1 << 64) - 1))


def _attr_bytes(name: str, val) -> bytes:
    out = bytearray()
    _put_bytes(out, 1, name.encode("utf-8"))
    if isinstance(val, bool):
        raise ValueError("use int for attribute values")
    if isinstance(val, float):
        _field(out, 2, 5)
        out.extend(struct.pack("<f", val))
        _put_varint_field(out, 20, _ATTR_FLOAT)
    elif isinstance(val, int):
        _int64_varint(out, 3, val)
        _put_varint_field(out, 20, _ATTR_INT)
    elif isinstance(val, str):
        _put_bytes(out, 4, val.encode("utf-8"))
        _put_varint_field(out, 20, _ATTR_STRING)
    elif isinstance(val, (list, tuple)):
        if val and isinstance(val[0], float):
            for x in val:
                _field(out, 7, 5)
                out.extend(struct.pack("<f", x))
            _put_varint_field(out, 20, _ATTR_FLOATS)
        else:
            for x in val:
                _int64_varint(out, 8, int(x))
            _put_varint_field(out, 20, _ATTR_INTS)
    else:
        raise ValueError(f"unsupported attribute value {val!r} for {name}")
    return bytes(out)


def _node_bytes(op_type: str, inputs, outputs, name: str = "",
                attrs: Optional[Dict[str, object]] = None) -> bytes:
    out = bytearray()
    for i in inputs:
        _put_bytes(out, 1, i.encode("utf-8"))
    for o in outputs:
        _put_bytes(out, 2, o.encode("utf-8"))
    if name:
        _put_bytes(out, 3, name.encode("utf-8"))
    _put_bytes(out, 4, op_type.encode("utf-8"))
    for k, v in (attrs or {}).items():
        _put_bytes(out, 5, _attr_bytes(k, v))
    return bytes(out)


def write_onnx(path: str, graph_name: str, initializers: Dict[str, np.ndarray],
               inputs: List[str] = (), outputs: List[str] = (),
               external_threshold: Optional[int] = None,
               producer: str = "trt-asr-tpu",
               nodes: List[OnnxNode] = (),
               io_types: Optional[Dict[str, Tuple[int, Tuple]]] = None) -> None:
    """Write a ModelProto. Tensors >= external_threshold bytes (if set) go
    to ``<path>.data`` as external data. ``nodes`` turns the file into an
    executable compute graph (vs a weight-interchange initializer bag);
    ``io_types`` maps input/output names to (elem_type_code, dims) so real
    runtimes can bind them (dims entries may be str dim_params)."""
    ext_path = path + ".data"
    ext_name = os.path.basename(ext_path)
    ext_blob = bytearray()
    io_types = io_types or {}

    graph = bytearray()
    for nd in nodes:
        _put_bytes(graph, 1, _node_bytes(nd.op_type, nd.inputs, nd.outputs,
                                         nd.name, nd.attrs))
    _put_bytes(graph, 2, graph_name.encode("utf-8"))
    for name, arr in initializers.items():
        arr = np.asarray(arr)
        ext = None
        if external_threshold is not None and arr.nbytes >= external_threshold:
            off = len(ext_blob)
            # 64-byte alignment like the onnx external-data convention
            pad = (-off) % 64
            ext_blob.extend(b"\x00" * pad)
            off += pad
            ext_blob.extend(np.ascontiguousarray(arr).tobytes())
            ext = (ext_name, off)
        _put_bytes(graph, 5, _tensor_bytes(name, arr, ext))
    for n in inputs:
        _put_bytes(graph, 11, _value_info_bytes(n, io_types.get(n)))
    for n in outputs:
        _put_bytes(graph, 12, _value_info_bytes(n, io_types.get(n)))

    model = bytearray()
    _put_varint_field(model, 1, 8)  # ir_version
    _put_bytes(model, 2, producer.encode())
    opset = bytearray()
    _put_varint_field(opset, 2, 18)
    _put_bytes(model, 8, bytes(opset))
    _put_bytes(model, 7, bytes(graph))

    with open(path, "wb") as f:
        f.write(bytes(model))
    if ext_blob:
        with open(ext_path, "wb") as f:
            f.write(bytes(ext_blob))
    elif os.path.exists(ext_path):
        os.remove(ext_path)
