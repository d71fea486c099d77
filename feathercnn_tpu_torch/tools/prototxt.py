"""Protobuf text-format parser for Caffe deploy.prototxt files — the
port's own copy of ``tools/prototxt.py``.

The reference parses these with libprotobuf's TextFormat
([pub] tools/feather_convert_caffe.cpp: ReadProtoFromTextFile); this is a
dependency-free equivalent producing plain dicts with list values for
repeated fields.  Enum identifiers (MAX, AVE, SUM, ...) stay as strings.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple, Union

__all__ = ["parse_prototxt", "REPEATED_KEYS"]

_TOKEN = re.compile(r"""
    "(?:[^"\\]|\\.)*"          |   # quoted string
    '(?:[^'\\]|\\.)*'          |
    [{}:]                      |
    [^\s{}:\#]+                    # bare token
""", re.VERBOSE)

# Keys that are `repeated` in caffe.proto and must always be lists.
REPEATED_KEYS = {
    "layer", "layers", "bottom", "top", "input", "input_dim", "dim",
    "input_shape", "kernel_size", "stride", "pad", "dilation",
    "slice_point", "coeff", "loss_weight", "param", "blobs", "shape",
    "include", "exclude",
    # ssd fork (PermuteParameter.order, PriorBoxParameter fields)
    "order", "min_size", "max_size", "aspect_ratio", "variance",
}


def _tokens(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        out.extend(_TOKEN.findall(line))
    return out


def _convert(tok: str) -> Any:
    if tok[0] in "\"'":
        return tok[1:-1]
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum identifier


def _parse_block(toks: List[str], pos: int) -> Tuple[Dict[str, Any], int]:
    msg: Dict[str, Any] = {}

    def put(key, value):
        if key in REPEATED_KEYS:
            msg.setdefault(key, []).append(value)
        elif key in msg:
            # repeated field we didn't list — promote to list
            if not isinstance(msg[key], list):
                msg[key] = [msg[key]]
            msg[key].append(value)
        else:
            msg[key] = value

    while pos < len(toks):
        tok = toks[pos]
        if tok == "}":
            return msg, pos + 1
        key = tok
        pos += 1
        if pos < len(toks) and toks[pos] == ":":
            pos += 1
            if toks[pos] == "{":
                sub, pos = _parse_block(toks, pos + 1)
                put(key, sub)
            else:
                put(key, _convert(toks[pos]))
                pos += 1
        elif pos < len(toks) and toks[pos] == "{":
            sub, pos = _parse_block(toks, pos + 1)
            put(key, sub)
        else:
            raise ValueError(f"parse error near token {pos}: {key!r}")
    return msg, pos


def parse_prototxt(text: str) -> Dict[str, Any]:
    toks = _tokens(text)
    msg, pos = _parse_block(toks, 0)
    if pos < len(toks):
        raise ValueError("trailing tokens in prototxt")
    return msg
