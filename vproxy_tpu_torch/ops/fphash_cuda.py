"""The hand-written CUDA kernels of the packed-fingerprint backend.

B6 (csrc/fp_hint.cu) replaces `vproxy_tpu/ops/fphash.py`
`hint_fp_match`: a compiled FpHintTable's arrays + an encoded batch
(ops/fphash.py encode_hint_queries_fp) -> (rule index, level) per query.
B7 (csrc/fp_cidr.cu) replaces `cidr_fp_match`: an FpCidrTable's arrays
+ an address batch (+ ports, for an ACL) -> the first matching rule.
Their notes give the bound and the design. This module builds each with
nvcc (fused_cuda.build_library: sm_90a, content-keyed into _build/),
loads it with ctypes and launches it on PyTorch's current stream, as
ops/cidr_cuda.py does B4.

* `hint_fp`, `cidr_fp`, `classify_fp_all` and `hint_fp_pick` are the
  entries the engine serves with: CPU tensors take the plain torch tier
  (ops/fphash.py; `hint_fp_pick_plain` for the Maglev column),
  everything else the kernels. There is no fallback: every failure to
  serve CUDA tensors raises KernelError (fused_cuda.card_entry).
  `classify_fp_all` on the card launches B6 once and B7 twice (routes,
  then ACL), each into its column of one int32 [B, 3] output, with no
  host round trip between them.
* `prepare_hint_table` / `prepare_cidr_table` check a table once and
  cache its half of the launch arguments; a CUDA "torch-fp" matcher
  calls them when it publishes, which also builds the library, so a
  build failure stops the publish.
* `hint_fp_cuda` and `cidr_fp_cuda` are the kernel wrappers; each
  counts the launches it made in its `launches` attribute. With a
  Maglev column (`mtab`, `slots`) B6 is one launch answering a
  classify+pick batch's (verdict, pick) rows: B5's take folded in
  (`hint_fp_cuda.pick_launches` counts those launches among the rest).
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import fphash as F
from . import fused_cuda as FC
from . import take_cuda as TC
from .fused_cuda import KernelError, card_entry

_CSRC = os.path.dirname(FC.SOURCE)
SOURCE_HINT = os.path.join(_CSRC, "fp_hint.cu")
SOURCE_CIDR = os.path.join(_CSRC, "fp_cidr.cu")
HEADER_HINT = os.path.join(_CSRC, "fp_hint.cuh")  # the routines B8 shares
HEADER_CIDR = os.path.join(_CSRC, "fp_cidr.cuh")

# B6's arguments: name -> dtype of each pointer, in the order of
# `struct FpHintArgs` (csrc/fp_hint.cu); table arrays, then the batch
HINT_TABLE = {"rec": torch.int32, "wh_rec": torch.int32,
              "wu_rec": torch.int32}
HINT_QUERY = {
    "hp_slot": torch.int32, "hp_fp1": torch.int32, "hp_fp2": torch.int32,
    "hp_level": torch.int32, "up_slot": torch.int32, "up_fp1": torch.int32,
    "up_fp2": torch.int32, "up_score": torch.int32, "um_fp1": torch.int32,
    "um_fp2": torch.int32, "um_score": torch.int32, "q_hmeta": torch.int32,
    "hlen": torch.int32, "port": torch.int32, "has_host": torch.bool,
    "has_uri": torch.bool}
_UM = ("um_fp1", "um_fp2", "um_score")  # present iff the uri probes trimmed
_HINT_PTRS = (*HINT_TABLE, *HINT_QUERY, "out_idx", "out_level")
_HINT_INTS = ("b", "p", "u", "l", "w", "rows", "rw", "he", "hm", "ue", "um",
              "whc", "wuc", "r_cap", "out_stride")

# B7's: the batch, then the table (`struct FpCidrArgs`, csrc/fp_cidr.cu)
CIDR_TABLE = {
    "g_mask4": torch.uint32, "g_fam": torch.int32,
    "g_salt_s": torch.uint32, "g_salt_f1": torch.uint32,
    "g_salt_f2": torch.uint32, "g_off": torch.int32,
    "g_capmask": torch.int32, "rec": torch.int32, "mrows": torch.int32,
    "t_l0": torch.int32, "t_l1": torch.int32, "t_l2": torch.int32}
_CIDR_OPTIONAL = ("mrows", "t_l0", "t_l1", "t_l2")  # ACL / trie only
_CIDR_PTRS = ("a16", "fam", "port", *CIDR_TABLE, "out")
_CIDR_INTS = ("b", "g", "ct", "e", "nm", "mk", "s1", "s2", "r_cap",
              "out_stride")


class _FpHintArgs(ctypes.Structure):
    """Mirror of `struct FpHintArgs` (pointers, then ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in _HINT_PTRS] + \
        [(n, ctypes.c_int) for n in _HINT_INTS]


class _FpPickArgs(ctypes.Structure):
    """Mirror of `struct FpPickArgs` (pointers, then ints): B6's Maglev
    column."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("mtab", "slots",
                                               "out_pick")] + \
        [("m", ctypes.c_int)]


class _FpCidrArgs(ctypes.Structure):
    """Mirror of `struct FpCidrArgs` (pointers, then ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in _CIDR_PTRS] + \
        [(n, ctypes.c_int) for n in _CIDR_INTS]


def build_hint() -> str:
    """Compile csrc/fp_hint.cu (and its routine's header) once; -> the
    shared library's path."""
    return FC.build_library(SOURCE_HINT, "libfphint", "fp", (HEADER_HINT,))


def build_cidr() -> str:
    """Compile csrc/fp_cidr.cu (and its routine's header) once; -> the
    shared library's path."""
    return FC.build_library(SOURCE_CIDR, "libfpcidr", "fp", (HEADER_CIDR,))


_LIBS: dict = {}
_LIB_LOCK = threading.Lock()


def _load(kind: str):
    """Build (first use) and load one library ("hint" or "cidr"). -> the
    ctypes handle, its ABI checked against the ctypes mirror."""
    with _LIB_LOCK:
        lib = _LIBS.get(kind)
        if lib is not None:
            return lib
        path, args = (build_hint(), _FpHintArgs) if kind == "hint" else \
            (build_cidr(), _FpCidrArgs)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelError(f"cannot load {path}: {e}") from e
        fn = getattr(lib, f"vproxy_fp_{kind}")
        fn.restype = ctypes.c_int
        checks = [(kind, args)]
        pick = []
        if kind == "hint":  # B6 also takes its Maglev column
            pick = [ctypes.POINTER(_FpPickArgs)]
            checks.append(("pick", _FpPickArgs))
        fn.argtypes = [ctypes.POINTER(args), *pick, ctypes.c_int,
                       ctypes.c_void_p]
        for name, mirror in checks:
            size_fn = getattr(lib, f"vproxy_fp_{name}_args_size")
            size_fn.restype, size_fn.argtypes = ctypes.c_int, []
            if size_fn() != ctypes.sizeof(mirror):
                raise KernelError(f"{mirror.__name__} ABI drift: C "
                                  f"{size_fn()} B, ctypes "
                                  f"{ctypes.sizeof(mirror)} B")
        _LIBS[kind] = lib
        return lib


def _launch(kind: str, a, dev: torch.device, *pick) -> None:
    """Launch B6 ("hint": `pick` its Maglev column's _FpPickArgs or None)
    or B7 ("cidr")."""
    lib = _LIBS.get(kind) or _load(kind)
    err = getattr(lib, f"vproxy_fp_{kind}")(
        ctypes.byref(a), *pick, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise KernelError(f"fp {kind} kernel launch failed: CUDA error "
                          f"{err}")


class PreparedFpTable(dict):
    """A fingerprint table's arrays (the dict of tensors) checked for
    its kernel, with `device`, `ptrs` (name -> data pointer) and `ints`
    (name -> size) cached."""


def _prepare(t: dict, want: dict, optional: tuple, what: str):
    dev = t["rec"].device
    if dev.type == "cpu":  # the plain tier's, never the kernel's
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for k, dtype in want.items():
        if k in t:
            FC._check(k, t[k], dev, dtype)
        elif k not in optional:
            raise ValueError(f"{what}: missing {k!r}")
    p = PreparedFpTable(t)
    p.device = dev
    p.ptrs = {k: t[k].data_ptr() for k in want if k in t}
    return p


def prepare_hint_table(t: dict, build_kernel: bool = True
                       ) -> PreparedFpTable:
    """Check an FpHintTable's arrays once for B6 (device, dtypes,
    contiguity, shapes) and, with `build_kernel`, build + load its
    library. -> a PreparedFpTable (`t` itself when it already is one).
    Raises KernelError when the library cannot be built or loaded,
    ValueError on a bad table."""
    if build_kernel:
        _load("hint")
    if isinstance(t, PreparedFpTable):
        return t
    p = _prepare(t, HINT_TABLE, (), "fp hint kernel")
    (he, hm), (ue, um) = t["h_em"].shape, t["u_em"].shape
    rows, rw = t["rec"].shape
    if max(he * (2 + 4 * hm), ue * (2 + 4 * um)) > rw or rows <= 0:
        raise ValueError(f"fp hint kernel: rec [{rows}, {rw}] cannot hold "
                         f"E x M {he} x {hm} / {ue} x {um}")
    for k in ("wh_rec", "wu_rec"):
        if t[k].dim() != 2 or t[k].shape[1] != 4 or t[k].shape[0] <= 0:
            raise ValueError(f"fp hint kernel: {k} must be [n, 4], got "
                             f"{tuple(t[k].shape)}")
    p.ints = {"rows": rows, "rw": rw, "he": he, "hm": hm, "ue": ue,
              "um": um, "whc": t["wh_rec"].shape[0],
              "wuc": t["wu_rec"].shape[0],
              "r_cap": t["rcap_iota"].shape[0]}
    return p


def prepare_cidr_table(t: dict, build_kernel: bool = True
                       ) -> PreparedFpTable:
    """Check an FpCidrTable's arrays once for B7 and, with
    `build_kernel`, build + load its library (see prepare_hint_table)."""
    if build_kernel:
        _load("cidr")
    if isinstance(t, PreparedFpTable):
        return t
    p = _prepare(t, CIDR_TABLE, _CIDR_OPTIONAL, "fp cidr kernel")
    g = t["g_fam"].shape[0]
    e = t["e_m"].shape[0]
    ct = t["rec"].shape[0]
    if t["rec"].shape[1] != 3 * e or ct <= 0:
        raise ValueError(f"fp cidr kernel: rec {tuple(t['rec'].shape)}, "
                         f"want [ct, {3 * e}]")
    if tuple(t["g_mask4"].shape) != (g, 4) or any(
            tuple(t[k].shape) != (g,) for k in
            ("g_salt_s", "g_salt_f1", "g_salt_f2", "g_off", "g_capmask")):
        raise ValueError("fp cidr kernel: group arrays disagree on G")
    trie = "t_l0" in t
    if trie and (t["t_l0"].shape != (65536,) or "t_l1" not in t
                 or "t_l2" not in t):
        raise ValueError("fp cidr kernel: a trie needs t_l0 [65536], "
                         "t_l1 and t_l2")
    nm, mk = (t["mrows"].shape[0], t["mrows"].shape[1] // 2) \
        if "mrows" in t else (0, 0)
    p.ints = {"g": g, "ct": ct, "e": e, "nm": nm, "mk": mk,
              "s1": t["t_l1"].shape[0] if trie else 0,
              "s2": t["t_l2"].shape[0] if trie else 0,
              "r_cap": t["rcap_iota"].shape[0]}
    return p


def hint_fp(t: dict, q: dict):
    """B6's entry: (rule index int32 [B], -1 for none; level int32 [B]),
    bit for bit fphash.hint_fp_match. CPU tensors take the plain tier;
    CUDA tensors launch the kernel (hint_fp_cuda), which raises unless
    it launched."""
    if t["rec"].device.type == "cpu":
        return F.hint_fp_match(t, q)
    return hint_fp_cuda(t, q)


def _hint_args(t: PreparedFpTable, q: dict) -> _FpHintArgs:
    """Check an encoded batch against a prepared table. -> the launch
    arguments, every pointer and size set but the outputs'."""
    dev, what = t.device, "fp hint kernel"
    b, p = q["hp_slot"].shape
    u = q["up_slot"].shape[1]
    w = q["q_hmeta"].shape[1]
    trimmed = "um_fp1" in q
    l_ = q["um_fp1"].shape[1] if trimmed else u
    shapes = {"hp_fp1": (b, p), "hp_fp2": (b, p), "hp_level": (b, p),
              "up_fp1": (b, u), "up_fp2": (b, u), "up_score": (b, u),
              "q_hmeta": (b, w, 3), "hlen": (b,), "port": (b,),
              "has_host": (b,), "has_uri": (b,)}
    if trimmed:
        shapes.update({k: (b, l_) for k in _UM})
    for k, dtype in HINT_QUERY.items():
        if k in q:
            FC._check(k, q[k], dev, dtype)
        elif k not in _UM:
            raise ValueError(f"{what}: missing {k!r}")
    if trimmed != all(k in q for k in _UM):
        raise ValueError(f"{what}: um_* come as a set")
    for k, shape in shapes.items():
        if tuple(q[k].shape) != shape:
            raise ValueError(f"{what}: {k} has shape {tuple(q[k].shape)}, "
                             f"want {shape}")
    if min(p, u, w) <= 0:
        raise ValueError(f"{what}: empty probe arrays")
    a = _FpHintArgs(**t.ptrs, **t.ints)
    for k in HINT_QUERY:
        setattr(a, k, q[k].data_ptr() if k in q else None)
    a.b, a.p, a.u, a.l, a.w = b, p, u, l_, w
    return a


@card_entry("fp hint kernel")
def hint_fp_cuda(t: dict, q: dict, out=None, col: int = 0, mtab=None,
                 slots=None):
    """Launch B6: same contract as fphash.hint_fp_match, CUDA tensors
    only. -> (idx, level), int32 [B] views of one [B, 2] output; with
    `out` (int32 [B, C], C >= 1) the rule index goes to column `col`
    and no level is written (-> out). With a Maglev column (`mtab` int32
    [M], `slots` int64 [B]; no `out`) -> int32 [B, 2] rows (rule index,
    mtab[clamp(slot, 0, M - 1)]), hint_fp_pick_plain's. `t` is best a
    PreparedFpTable (prepare_hint_table); a plain dict is checked on
    every call. Raises KernelError unless it launched (card_entry)."""
    tt = prepare_hint_table(t)
    a = _hint_args(tt, q)
    if mtab is not None:
        if out is not None:
            raise ValueError("fp hint kernel: a Maglev column writes its own "
                             "[B, 2] rows")
        TC.check_column(mtab, slots, a.b, tt.device, "fp hint kernel")
        out = torch.empty((a.b, 2), dtype=torch.int32, device=tt.device)
        a.out_idx, a.out_stride = out[:, 0].data_ptr(), 2
        pick = _FpPickArgs(mtab=mtab.data_ptr(), slots=slots.data_ptr(),
                           out_pick=out[:, 1].data_ptr(), m=mtab.shape[0])
        _launch("hint", a, tt.device, ctypes.byref(pick))
        hint_fp_cuda.launches += 1
        hint_fp_cuda.pick_launches += 1
        return out
    own = out is None
    if own:
        out = torch.empty((a.b, 2), dtype=torch.int32, device=tt.device)
    _check_out(out, a.b, col, tt.device)
    a.out_idx = out[:, col].data_ptr()
    a.out_level = out[:, 1].data_ptr() if own else None
    a.out_stride = out.shape[1]
    _launch("hint", a, tt.device, None)
    hint_fp_cuda.launches += 1
    return (out[:, 0], out[:, 1]) if own else out


hint_fp_cuda.launches = 0  # every launch
hint_fp_cuda.pick_launches = 0  # of which: with the Maglev column


def hint_fp_pick_plain(t: dict, q: dict, mtab: torch.Tensor,
                       slots: torch.Tensor, mode=None) -> torch.Tensor:
    """The plain version of B6 with its Maglev column: the plain tier's
    rule index (fphash.hint_fp_match, member mode `mode`) beside B5's
    plain take (take_cuda.take_plain) -> int32 [B, 2]."""
    idx = F.hint_fp_match(t, q, mode)[0]
    return torch.stack([idx.to(torch.int32),
                        TC.take_plain(mtab, slots).to(torch.int32)], dim=1)


def hint_fp_pick(t: dict, q: dict, mtab: torch.Tensor, slots: torch.Tensor,
                 mode=None) -> torch.Tensor:
    """B6's classify+pick entry: int32 [B, 2] (rule index, Maglev pick)
    for an encoded batch and its flow slots. CPU tensors take the plain
    version (hint_fp_pick_plain, in member mode `mode`); CUDA tensors
    ONE launch of B6 with its Maglev column (hint_fp_cuda), which
    raises unless it launched. The kernel computes the one function the
    member modes agree on."""
    if t["rec"].device.type == "cpu":
        return hint_fp_pick_plain(t, q, mtab, slots, mode)
    return hint_fp_cuda(t, q, mtab=mtab, slots=slots)


def _check_out(out, b: int, col: int, dev) -> None:
    FC._check("out", out, dev, torch.int32)
    if out.dim() != 2 or out.shape[0] != b or not 0 <= col < out.shape[1]:
        raise ValueError(f"fp kernel: out {tuple(out.shape)} has no column "
                         f"{col} of {b} rows")


def cidr_fp(t: dict, a16, fam, port=None):
    """B7's entry: the first matching rule, int32 [B], -1 for none. CPU
    tensors take the plain tier (fphash.cidr_fp_match), everything else
    the kernel (cidr_fp_cuda), which raises unless it launched."""
    if t["rec"].device.type == "cpu":
        return F.cidr_fp_match(t, a16, fam, port)
    return cidr_fp_cuda(t, a16, fam, port)


@card_entry("fp cidr kernel")
def cidr_fp_cuda(t: dict, a16, fam, port=None, out=None, col: int = 0):
    """Launch B7: same contract as fphash.cidr_fp_match, CUDA tensors
    only. -> int32 [B]; with `out` (int32 [B, C]) the answers go to
    column `col` (-> out). A route table (no `mrows`) never reads
    `port`. Raises KernelError unless it launched (card_entry)."""
    tt = prepare_cidr_table(t)
    dev, b = tt.device, a16.shape[0]
    FC._check("a16", a16, dev, torch.uint8)
    FC._check("fam", fam, dev, torch.int32)
    if port is not None:
        FC._check("port", port, dev, torch.int32)
    if tuple(a16.shape) != (b, 16) or tuple(fam.shape) != (b,) or (
            port is not None and tuple(port.shape) != (b,)):
        raise ValueError(
            f"fp cidr kernel: want a16 [{b}, 16], fam [{b}], port [{b}]; "
            f"got {tuple(a16.shape)}, {tuple(fam.shape)}, "
            f"{None if port is None else tuple(port.shape)}")
    if a16.data_ptr() % 16:
        raise ValueError("fp cidr kernel: a16 is not 16-byte aligned")
    own = out is None
    if own:
        out = torch.empty((b, 1), dtype=torch.int32, device=dev)
    _check_out(out, b, col, dev)
    a = _FpCidrArgs(a16=a16.data_ptr(), fam=fam.data_ptr(),
                    port=None if port is None else port.data_ptr(),
                    out=out[:, col].data_ptr(), b=b,
                    out_stride=out.shape[1], **tt.ptrs, **tt.ints)
    _launch("cidr", a, dev)
    cidr_fp_cuda.launches += 1
    return out[:, 0] if own else out


cidr_fp_cuda.launches = 0  # every launch


def classify_fp_all(hint_t: dict, route_t: dict, acl_t: dict, hint_q: dict,
                    a16, fam, port):
    """The fingerprint flagship step: hint, route and ACL answers of one
    micro-batch -> int32 [B, 3]. CPU tensors take the plain tier
    (fphash.classify_fp_all); CUDA tensors launch B6 once and B7 twice
    (routes, then the ACL with its ports) into the columns of one
    output, on one stream, with no host round trip."""
    if hint_t["rec"].device.type == "cpu":
        return F.classify_fp_all(hint_t, route_t, acl_t, hint_q, a16, fam,
                                 port)
    b = hint_q["hp_slot"].shape[0]
    out = torch.empty((b, 3), dtype=torch.int32, device=a16.device)
    hint_fp_cuda(hint_t, hint_q, out=out, col=0)
    cidr_fp_cuda(route_t, a16, fam, None, out=out, col=1)
    cidr_fp_cuda(acl_t, a16, fam, port, out=out, col=2)
    return out
