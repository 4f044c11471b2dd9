"""vlint pass 1 — ABI parity between native/vtl.cpp and net/vtl.py
(the port's copies: vproxy_tpu_torch/native/vtl.cpp and
vproxy_tpu_torch/net/vtl.py).

The C structs shared across the ctypes boundary (#pragma pack(push, 1)
blocks in vtl.cpp) are mirrored byte-for-byte by struct.Struct format
strings in net/vtl.py. Until this pass, the only guards were total-size
asserts (`static_assert(sizeof(...))` in C, `vtl_*_rec_size()` at load
time) — which let two compensating field errors through: swap a u32
with a 4-byte array, or reorder two u16s, and every size check still
passes while C and Python silently read each other's fields.

This module extracts BOTH sides into one field-level model:

* C side: a small parser over the packed regions of vtl.cpp — struct
  defs, per-field type/name/array-length, nested packed structs
  flattened (FlowRec embeds FlowKey), offsets/sizes computed from the
  pack(1) rule (no padding, declaration order).
* Python side: the struct.Struct("<...>") format strings plus the
  *_FIELDS name tuples in net/vtl.py, parsed from the AST (never
  imported — the analyzer must run on a tree that does not build).

check_abi() compares the mapped records field-by-field — name, offset,
size and type kind must all agree — and is also the single source of
truth for tests/test_native_build.py's generated assertions (the
runtime vtl_*_rec_size guards stay as the load-time backstop).
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import PKG, Finding, trees

# the shared-record map: python struct.Struct name -> C struct name.
# Everything else inside pack(1) regions (the self-defined io_uring
# ABI) is kernel-facing, not python-facing, and is not mirrored.
SHARED_RECORDS = {
    "FLOW_REC": "FlowRec",
    "LANE_REC": "LaneRec",
    "LANE_PUNT": "LanePunt",
    "MAGLEV_REC": "MaglevRec",
    "TRACE_REC": "TraceRec",
    "HH_REC": "HHRec",
    "POLICE_REC": "PoliceRec",
}

# scalar C types we allow in shared records: name -> (size, kind)
C_SCALARS = {
    "uint8_t": (1, "uint"), "int8_t": (1, "int"),
    "uint16_t": (2, "uint"), "int16_t": (2, "int"),
    "uint32_t": (4, "uint"), "int32_t": (4, "int"),
    "uint64_t": (8, "uint"), "int64_t": (8, "int"),
    "char": (1, "bytes"), "int": (4, "int"),
}

# python struct codes we allow: code -> (size, kind)
PY_CODES = {
    "B": (1, "uint"), "b": (1, "int"),
    "H": (2, "uint"), "h": (2, "int"),
    "I": (4, "uint"), "i": (4, "int"),
    "Q": (8, "uint"), "q": (8, "int"),
    "s": (1, "bytes"),
}


@dataclass
class Field:
    name: str
    offset: int
    size: int
    kind: str  # "uint" | "int" | "bytes"


@dataclass
class Record:
    name: str
    fields: List[Field]

    @property
    def size(self) -> int:
        return sum(f.size for f in self.fields)


# --------------------------------------------------------------- C side

_C_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_C_STRUCT = re.compile(r"struct\s+(\w+)\s*\{([^{}]*)\}\s*;", re.S)
_C_FIELD = re.compile(
    r"^\s*(struct\s+)?([A-Za-z_]\w*)\s+([^;]+)$")
_C_DECL = re.compile(r"([A-Za-z_]\w*)\s*(?:\[\s*(\d+)\s*\])?\s*$")


def parse_c_structs(cpp_path: str) -> Dict[str, List[Tuple[str, str, int]]]:
    """-> {struct name: [(type, field name, array_len or 0), ...]} for
    every struct inside a #pragma pack(push, 1) ... pack(pop) region.
    Structs with members this parser cannot model (unions, bitfields,
    anonymous members) parse as None-typed fields and fail loudly only
    if they are in SHARED_RECORDS."""
    with open(cpp_path) as f:
        text = f.read()
    out: Dict[str, List[Tuple[str, str, int]]] = {}
    pos = 0
    while True:
        start = text.find("#pragma pack(push, 1)", pos)
        if start < 0:
            break
        end = text.find("#pragma pack(pop)", start)
        if end < 0:
            break
        region = _C_COMMENT.sub("", text[start:end])
        for m in _C_STRUCT.finditer(region):
            name, body = m.group(1), m.group(2)
            fields: List[Tuple[str, str, int]] = []
            for stmt in body.split(";"):
                stmt = stmt.strip()
                if not stmt:
                    continue
                fm = _C_FIELD.match(stmt)
                if fm is None:
                    fields.append(("?", stmt, 0))
                    continue
                ctype = fm.group(2)
                for decl in fm.group(3).split(","):
                    dm = _C_DECL.match(decl.strip())
                    if dm is None:
                        fields.append(("?", decl.strip(), 0))
                        continue
                    fields.append((ctype, dm.group(1),
                                   int(dm.group(2) or 0)))
            out[name] = fields
        pos = end + 1
    return out


def c_record(raw: Dict[str, List[Tuple[str, str, int]]],
             name: str) -> Record:
    """Flatten one parsed struct into an offset/size/kind Record;
    nested packed structs (FlowRec's FlowKey) inline their fields.
    Raises ValueError on anything the model cannot express."""
    fields: List[Field] = []
    off = 0
    for ctype, fname, arr in raw.get(name, ()):
        if ctype in raw:  # nested packed struct: flatten
            if arr:
                raise ValueError(f"{name}.{fname}: struct arrays "
                                 "unsupported")
            inner = c_record(raw, ctype)
            for f in inner.fields:
                fields.append(Field(f.name, off + f.offset, f.size,
                                    f.kind))
            off += inner.size
            continue
        if ctype not in C_SCALARS:
            raise ValueError(f"{name}.{fname}: unmodelled C type "
                             f"{ctype!r}")
        size, kind = C_SCALARS[ctype]
        if arr:
            size, kind = size * arr, "bytes"
        fields.append(Field(fname, off, size, kind))
        off += size
    if not fields:
        raise ValueError(f"struct {name} not found in any packed region")
    return Record(name, fields)


# ---------------------------------------------------------- python side

_FMT = re.compile(r"(\d*)([a-zA-Z])")


def parse_py_format(fmt: str) -> List[Tuple[int, int, str]]:
    """-> [(offset, size, kind), ...] for a '<'-prefixed struct format."""
    if not fmt.startswith("<"):
        raise ValueError(f"format {fmt!r} must pin little-endian ('<') "
                         "— native byte order would unpack padding")
    out: List[Tuple[int, int, str]] = []
    off = 0
    for count, code in _FMT.findall(fmt[1:]):
        if code not in PY_CODES:
            raise ValueError(f"format {fmt!r}: unmodelled code {code!r}")
        size, kind = PY_CODES[code]
        n = int(count) if count else 1
        if code == "s":
            out.append((off, n, "bytes"))
            off += n
        else:
            for _ in range(n):
                out.append((off, size, kind))
                off += size
    return out


def parse_py_structs(py_path: str):
    """-> ({NAME: fmt}, {NAME_FIELDS: (names...)}) from net/vtl.py's
    AST: `X = struct.Struct("<fmt>")` and `X_FIELDS = ("a", ...)`."""
    tree = trees().parse(py_path)
    fmts: Dict[str, str] = {}
    names: Dict[str, Tuple[str, ...]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        tgt = node.targets[0].id
        v = node.value
        if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr == "Struct" and v.args
                and isinstance(v.args[0], ast.Constant)
                and isinstance(v.args[0].value, str)):
            fmts[tgt] = v.args[0].value
        elif (tgt.endswith("_FIELDS") and isinstance(v, ast.Tuple)
              and all(isinstance(e, ast.Constant) for e in v.elts)):
            names[tgt] = tuple(e.value for e in v.elts)
    return fmts, names


def py_record(fmts: Dict[str, str], names: Dict[str, Tuple[str, ...]],
              name: str) -> Record:
    if name not in fmts:
        raise ValueError(f"{name}: no struct.Struct definition found")
    elems = parse_py_format(fmts[name])
    fnames = names.get(name + "_FIELDS")
    if fnames is None:
        raise ValueError(f"{name}_FIELDS: missing field-name tuple "
                         "(the name half of the ABI contract)")
    if len(fnames) != len(elems):
        raise ValueError(
            f"{name}_FIELDS has {len(fnames)} names for "
            f"{len(elems)} format elements")
    return Record(name, [Field(n, o, s, k)
                         for n, (o, s, k) in zip(fnames, elems)])


# -------------------------------------------------------------- the pass

def shared_model(root: str):
    """-> {py_name: (py Record, c Record)} for every SHARED_RECORDS
    entry, raising on unparseable definitions (a parse failure on a
    shared record is itself an ABI-guard failure)."""
    cpp = os.path.join(root, PKG, "native", "vtl.cpp")
    pyf = os.path.join(root, PKG, "net", "vtl.py")
    raw = parse_c_structs(cpp)
    fmts, fnames = parse_py_structs(pyf)
    out = {}
    for py_name, c_name in SHARED_RECORDS.items():
        out[py_name] = (py_record(fmts, fnames, py_name),
                        c_record(raw, c_name))
    return out


def check_abi(root: str,
              records: Optional[Dict[str, str]] = None,
              cpp_path: Optional[str] = None,
              py_path: Optional[str] = None) -> List[Finding]:
    """Field-by-field parity over the shared records. `records` /
    `cpp_path` / `py_path` override the defaults for fixture runs."""
    findings: List[Finding] = []
    cpp = cpp_path or os.path.join(root, PKG, "native", "vtl.cpp")
    pyf = py_path or os.path.join(root, PKG, "net", "vtl.py")
    try:
        raw = parse_c_structs(cpp)
        fmts, fnames = parse_py_structs(pyf)
    except (OSError, ValueError, SyntaxError) as e:
        return [Finding("abi", "abi:parse", cpp, 0,
                        f"cannot extract struct model: {e}")]
    for py_name, c_name in (records or SHARED_RECORDS).items():
        try:
            py = py_record(fmts, fnames, py_name)
        except ValueError as e:
            findings.append(Finding("abi", f"abi:{py_name}:py", pyf, 0,
                                    str(e)))
            continue
        try:
            c = c_record(raw, c_name)
        except ValueError as e:
            findings.append(Finding("abi", f"abi:{py_name}:c", cpp, 0,
                                    str(e)))
            continue
        if len(py.fields) != len(c.fields):
            findings.append(Finding(
                "abi", f"abi:{py_name}:count", cpp, 0,
                f"{py_name} has {len(py.fields)} fields, C {c_name} "
                f"has {len(c.fields)}"))
            continue
        for pf, cf in zip(py.fields, c.fields):
            mismatches = []
            if pf.name != cf.name:
                mismatches.append(f"name {pf.name!r} vs C {cf.name!r}")
            if pf.offset != cf.offset:
                mismatches.append(
                    f"offset {pf.offset} vs C {cf.offset}")
            if pf.size != cf.size:
                mismatches.append(f"size {pf.size} vs C {cf.size}")
            if pf.kind != cf.kind:
                mismatches.append(f"type {pf.kind} vs C {cf.kind}")
            if mismatches:
                findings.append(Finding(
                    "abi", f"abi:{py_name}:{cf.name}", cpp, 0,
                    f"{py_name}.{pf.name} / {c_name}.{cf.name}: "
                    + "; ".join(mismatches)))
        if py.size != c.size:
            findings.append(Finding(
                "abi", f"abi:{py_name}:size", cpp, 0,
                f"{py_name} totals {py.size}B, C {c_name} {c.size}B"))
    return findings
