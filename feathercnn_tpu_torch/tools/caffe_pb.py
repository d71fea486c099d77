"""Minimal protobuf wire-format codec + the Caffe schema field maps — the
port's own copy of ``tools/caffe_pb.py`` (it imports nothing of the JAX
package or of the top-level ``tools``), byte for byte the same codec.

The reference bundles caffe.proto and links libprotobuf in its converter
([pub] tools/feather_convert_caffe.cpp, [pub] tools/caffe.proto).  Here the
.caffemodel is decoded with a ~200-line generic wire-format reader plus the
field-number tables below (transcribed from the public BVLC caffe.proto) —
no protoc, no generated code.  An encoder is included so tests can
synthesize .caffemodel files without network access.

Wire format: each field is (tag = field_number << 3 | wire_type) varint,
then: 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

# ----------------------------------------------------------------------
# Generic wire codec
# ----------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value)."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = bytes(buf[pos:pos + 8]); pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]; pos += ln
        elif wtype == 5:
            val = bytes(buf[pos:pos + 4]); pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def decode(buf, schema: Dict[int, Tuple[str, str]]) -> Dict[str, Any]:
    """Decode one message given {field_num: (name, kind)}.

    kind: 'varint' 'bool' 'float' 'double' 'string' 'bytes'
          'packed_float' 'packed_varint'
          ('msg', subschema) as tuple -> nested message
          prefix 'rep_' for repeated fields.
    Unknown fields are skipped.
    """
    out: Dict[str, Any] = {}
    for fnum, wtype, val in iter_fields(memoryview(buf)):
        spec = schema.get(fnum)
        if spec is None:
            continue
        name, kind = spec
        if isinstance(kind, tuple):
            rep = kind[0] == "rep_msg"
            base = ("msg", kind[1])
        else:
            rep = kind.startswith("rep_")
            base = kind[4:] if rep else kind
        if isinstance(base, tuple) and base[0] == "msg":
            item = decode(val, base[1])
        elif base == "varint":
            item = int(val)
        elif base == "bool":
            item = bool(val)
        elif base == "float":
            item = (struct.unpack("<f", val)[0] if wtype == 5
                    else np.frombuffer(val, "<f4").tolist())
        elif base == "double":
            item = struct.unpack("<d", val)[0]
        elif base == "string":
            item = bytes(val).decode("utf-8")
        elif base == "bytes":
            item = bytes(val)
        elif base == "packed_float":
            if wtype == 2:
                item = np.frombuffer(bytes(val), "<f4")
            else:  # unpacked repeated float arrives one fixed32 at a time
                item = np.asarray([struct.unpack("<f", val)[0]], "<f4")
            prev = out.get(name)
            out[name] = item if prev is None else np.concatenate([prev, item])
            continue
        elif base == "packed_varint":
            items: List[int] = []
            if wtype == 2:
                p = 0
                mv = memoryview(val)
                while p < len(mv):
                    v, p = _read_varint(mv, p)
                    items.append(v)
            else:
                items.append(int(val))
            out.setdefault(name, []).extend(items)
            continue
        else:
            raise ValueError(f"bad kind {kind}")
        if rep:
            out.setdefault(name, []).append(item)
        else:
            out[name] = item
    return out


# -- encoder (for tests) ------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:            # proto2 negative int: 64-bit two's complement
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint(fnum << 3 | wtype)


def encode(msg: Dict[str, Any], schema: Dict[int, Tuple[str, str]]) -> bytes:
    """Inverse of decode for the same schema (repeated via lists)."""
    by_name = {}
    for fnum, (name, kind) in schema.items():
        by_name[name] = (fnum, kind)
    out = bytearray()
    for name, value in msg.items():
        if name not in by_name:
            raise KeyError(name)
        fnum, kind = by_name[name]
        if isinstance(kind, tuple):
            rep = kind[0] == "rep_msg"
            base = ("msg", kind[1])
        else:
            rep = kind.startswith("rep_")
            base = kind[4:] if rep else kind
        values = value if rep else [value]
        if base == "packed_float":
            out += _tag(fnum, 2)
            data = np.asarray(value, "<f4").tobytes()
            out += _varint(len(data)) + data
            continue
        if base == "packed_varint":
            data = b"".join(_varint(int(v)) for v in value)
            out += _tag(fnum, 2) + _varint(len(data)) + data
            continue
        for v in values:
            if isinstance(base, tuple) and base[0] == "msg":
                sub = encode(v, base[1])
                out += _tag(fnum, 2) + _varint(len(sub)) + sub
            elif base in ("varint", "bool"):
                out += _tag(fnum, 0) + _varint(int(v))
            elif base == "float":
                out += _tag(fnum, 5) + struct.pack("<f", v)
            elif base == "string":
                data = v.encode("utf-8")
                out += _tag(fnum, 2) + _varint(len(data)) + data
            else:
                raise ValueError(f"encode: bad kind {base}")
    return bytes(out)


# ----------------------------------------------------------------------
# Caffe schema (field numbers from the public BVLC caffe.proto)
# ----------------------------------------------------------------------

BLOB_SHAPE = {1: ("dim", "packed_varint")}

BLOB_PROTO = {
    7: ("shape", ("msg", BLOB_SHAPE)),
    5: ("data", "packed_float"),
    1: ("num", "varint"),
    2: ("channels", "varint"),
    3: ("height", "varint"),
    4: ("width", "varint"),
}

CONVOLUTION_PARAM = {
    1: ("num_output", "varint"),
    2: ("bias_term", "bool"),
    3: ("pad", "packed_varint"),
    4: ("kernel_size", "packed_varint"),
    5: ("group", "varint"),
    6: ("stride", "packed_varint"),
    9: ("pad_h", "varint"),
    10: ("pad_w", "varint"),
    11: ("kernel_h", "varint"),
    12: ("kernel_w", "varint"),
    13: ("stride_h", "varint"),
    14: ("stride_w", "varint"),
    18: ("dilation", "packed_varint"),
}

POOLING_PARAM = {
    1: ("pool", "varint"),          # MAX=0 AVE=1 STOCHASTIC=2
    2: ("kernel_size", "varint"),
    3: ("stride", "varint"),
    4: ("pad", "varint"),
    5: ("kernel_h", "varint"),
    6: ("kernel_w", "varint"),
    7: ("stride_h", "varint"),
    8: ("stride_w", "varint"),
    9: ("pad_h", "varint"),
    10: ("pad_w", "varint"),
    12: ("global_pooling", "bool"),
    13: ("round_mode", "varint"),   # CEIL=0 FLOOR=1
}

INNER_PRODUCT_PARAM = {
    1: ("num_output", "varint"),
    2: ("bias_term", "bool"),
    5: ("axis", "varint"),
    6: ("transpose", "bool"),
}

LRN_PARAM = {
    1: ("local_size", "varint"),
    2: ("alpha", "float"),
    3: ("beta", "float"),
    4: ("norm_region", "varint"),
    5: ("k", "float"),
}

BATCH_NORM_PARAM = {
    1: ("use_global_stats", "bool"),
    2: ("moving_average_fraction", "float"),
    3: ("eps", "float"),
}

SCALE_PARAM = {
    1: ("axis", "varint"),
    2: ("num_axes", "varint"),
    4: ("bias_term", "bool"),
}

ELTWISE_PARAM = {
    1: ("operation", "varint"),     # PROD=0 SUM=1 MAX=2
    2: ("coeff", "packed_float"),
}

RELU_PARAM = {1: ("negative_slope", "float")}
DROPOUT_PARAM = {1: ("dropout_ratio", "float")}
CONCAT_PARAM = {1: ("concat_dim", "varint"), 2: ("axis", "varint")}
SLICE_PARAM = {1: ("slice_dim", "varint"), 2: ("slice_point", "packed_varint"),
               3: ("axis", "varint")}
SOFTMAX_PARAM = {2: ("axis", "varint")}
PRELU_PARAM = {2: ("channel_shared", "bool")}
RESHAPE_PARAM = {1: ("shape", ("msg", BLOB_SHAPE)), 2: ("axis", "varint"),
                 3: ("num_axes", "varint")}
FLATTEN_PARAM = {1: ("axis", "varint"), 2: ("end_axis", "varint")}
POWER_PARAM = {1: ("power", "float"), 2: ("scale", "float"),
               3: ("shift", "float")}
INPUT_PARAM = {1: ("shape", ("rep_msg", BLOB_SHAPE))}
TILE_PARAM = {1: ("axis", "varint"), 2: ("tiles", "varint")}
ELU_PARAM = {1: ("alpha", "float")}
CROP_PARAM = {1: ("axis", "varint"), 2: ("offset", "packed_varint")}
ARGMAX_PARAM = {1: ("out_max_val", "bool"), 2: ("top_k", "varint"),
                3: ("axis", "varint")}
# Wei Liu's ssd fork layers.  LayerParameter slots 202/203/204/206 are the
# fork's; inner field numbers are stable.  Deploys convert via the TEXT
# parser, so the slots only matter for synthetic binary round-trips.
PERMUTE_PARAM = {1: ("order", "packed_varint")}
NORMALIZE_PARAM = {1: ("across_spatial", "bool"),
                   3: ("channel_shared", "bool"), 4: ("eps", "float")}
PRIOR_BOX_PARAM = {1: ("min_size", "packed_float"),
                   2: ("max_size", "packed_float"),
                   3: ("aspect_ratio", "packed_float"),
                   4: ("flip", "bool"), 5: ("clip", "bool"),
                   6: ("variance", "packed_float"),
                   10: ("step", "float"), 13: ("offset", "float")}
NMS_PARAM = {1: ("nms_threshold", "float"), 2: ("top_k", "varint"),
             3: ("eta", "float")}
DETECTION_OUTPUT_PARAM = {
    1: ("num_classes", "varint"), 2: ("share_location", "bool"),
    3: ("background_label_id", "varint"),
    4: ("nms_param", ("msg", NMS_PARAM)),
    6: ("code_type", "varint"),        # CORNER=1 CENTER_SIZE=2
    7: ("keep_top_k", "varint"),
    9: ("confidence_threshold", "float"),
}
# DeepLab/PSPNet fork's InterpLayer. Inner field numbers are stable across
# the forks; the LayerParameter slot varies by fork (166 = PSPNet's) —
# deploy prototxts go through the TEXT parser, so the slot only matters
# for synthetic binary round-trips.
INTERP_PARAM = {1: ("height", "varint"), 2: ("width", "varint"),
                3: ("zoom_factor", "varint"),
                4: ("shrink_factor", "varint"),
                5: ("pad_beg", "varint"), 6: ("pad_end", "varint")}

LAYER_PARAMETER = {
    1: ("name", "string"),
    2: ("type", "string"),
    3: ("bottom", "rep_string"),
    4: ("top", "rep_string"),
    7: ("blobs", ("rep_msg", BLOB_PROTO)),
    104: ("concat_param", ("msg", CONCAT_PARAM)),
    106: ("convolution_param", ("msg", CONVOLUTION_PARAM)),
    108: ("dropout_param", ("msg", DROPOUT_PARAM)),
    110: ("eltwise_param", ("msg", ELTWISE_PARAM)),
    117: ("inner_product_param", ("msg", INNER_PRODUCT_PARAM)),
    118: ("lrn_param", ("msg", LRN_PARAM)),
    121: ("pooling_param", ("msg", POOLING_PARAM)),
    122: ("power_param", ("msg", POWER_PARAM)),
    123: ("relu_param", ("msg", RELU_PARAM)),
    125: ("softmax_param", ("msg", SOFTMAX_PARAM)),
    126: ("slice_param", ("msg", SLICE_PARAM)),
    131: ("prelu_param", ("msg", PRELU_PARAM)),
    133: ("reshape_param", ("msg", RESHAPE_PARAM)),
    135: ("flatten_param", ("msg", FLATTEN_PARAM)),
    138: ("tile_param", ("msg", TILE_PARAM)),
    139: ("batch_norm_param", ("msg", BATCH_NORM_PARAM)),
    140: ("elu_param", ("msg", ELU_PARAM)),
    142: ("scale_param", ("msg", SCALE_PARAM)),
    143: ("input_param", ("msg", INPUT_PARAM)),
    103: ("argmax_param", ("msg", ARGMAX_PARAM)),
    144: ("crop_param", ("msg", CROP_PARAM)),
    166: ("interp_param", ("msg", INTERP_PARAM)),
    202: ("permute_param", ("msg", PERMUTE_PARAM)),
    203: ("prior_box_param", ("msg", PRIOR_BOX_PARAM)),
    204: ("detection_output_param", ("msg", DETECTION_OUTPUT_PARAM)),
    206: ("norm_param", ("msg", NORMALIZE_PARAM)),
}

# Old-style (V1) layers: type is an enum, params use small field numbers.
V1_TYPE_ENUM = {
    35: "AbsVal", 2: "BNLL", 3: "Concat", 4: "Convolution", 6: "Dropout",
    25: "Eltwise", 38: "Exp", 8: "Flatten", 14: "InnerProduct", 15: "LRN",
    17: "Pooling", 26: "Power", 18: "ReLU", 19: "Sigmoid", 20: "Softmax",
    21: "Softmax", 22: "Split", 33: "Slice", 23: "TanH",
}

V1_LAYER_PARAMETER = {
    4: ("name", "string"),
    5: ("type", "varint"),
    2: ("bottom", "rep_string"),
    3: ("top", "rep_string"),
    6: ("blobs", ("rep_msg", BLOB_PROTO)),
    9: ("concat_param", ("msg", CONCAT_PARAM)),
    10: ("convolution_param", ("msg", CONVOLUTION_PARAM)),
    12: ("dropout_param", ("msg", DROPOUT_PARAM)),
    24: ("eltwise_param", ("msg", ELTWISE_PARAM)),
    17: ("inner_product_param", ("msg", INNER_PRODUCT_PARAM)),
    18: ("lrn_param", ("msg", LRN_PARAM)),
    19: ("pooling_param", ("msg", POOLING_PARAM)),
    21: ("power_param", ("msg", POWER_PARAM)),
    30: ("relu_param", ("msg", RELU_PARAM)),
    39: ("softmax_param", ("msg", SOFTMAX_PARAM)),
    31: ("slice_param", ("msg", SLICE_PARAM)),
}

NET_PARAMETER = {
    1: ("name", "string"),
    3: ("input", "rep_string"),
    4: ("input_dim", "packed_varint"),
    8: ("input_shape", ("rep_msg", BLOB_SHAPE)),
    100: ("layer", ("rep_msg", LAYER_PARAMETER)),
    2: ("layers", ("rep_msg", V1_LAYER_PARAMETER)),
}


def parse_net(buf: bytes) -> Dict[str, Any]:
    """Decode a serialized caffe NetParameter (.caffemodel)."""
    net = decode(buf, NET_PARAMETER)
    # Normalize V1 layers into new-style dicts.
    for v1 in net.get("layers", []):
        v1 = dict(v1)
        v1["type"] = V1_TYPE_ENUM.get(v1.get("type"), f"V1_{v1.get('type')}")
        net.setdefault("layer", []).append(v1)
    net.pop("layers", None)
    return net
