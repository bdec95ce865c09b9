"""Minimal reader for R serialization format (RDX2/RDX3, XDR encoding).

The R package rsparse ships its MovieLens-100k dataset as an R ``.RData``
file (``data/movielens100k.RData``, referenced by ``R/data.R:1-21``).  Rather than depending on R, we parse the R
serialization format directly: enough of it to recover S4 sparse-matrix
objects (``dgCMatrix``/``dgRMatrix``/``dgTMatrix``) and plain vectors.

This is an original implementation written from the public R "serialization
format" documentation; it supports the subset of SEXP types that appear in
data files (no closures/environments/bytecode).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# SEXP type codes (from Rinternals.h, stable public ABI)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
EXPRSXP = 20
RAWSXP = 24
S4SXP = 25

# Pseudo-types used by the serializer
BASEENV_SXP = 241
EMPTYENV_SXP = 242
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 252
MISSINGARG_SXP = 251
NILVALUE_SXP = 254
REFSXP = 255
PERSISTSXP = 247
PACKAGESXP = 248
NAMESPACESXP = 249
CLASSREFSXP = 246
ALTREP_SXP = 238
ATTRLANGSXP = 240
ATTRLISTSXP = 239

R_NA_INT = -2147483648


@dataclass
class RObject:
    """A decoded R object."""

    type: int
    value: Any = None
    attributes: Dict[str, "RObject"] = field(default_factory=dict)
    tag: Optional[str] = None

    def attr(self, name: str) -> Any:
        a = self.attributes.get(name)
        return a.value if a is not None else None


class _XDRReader:
    def __init__(self, data: bytes):
        self._d = data
        self._o = 0
        self._refs: List[RObject] = []

    def _read(self, n: int) -> bytes:
        b = self._d[self._o : self._o + n]
        if len(b) != n:
            raise EOFError("truncated R serialization stream")
        self._o += n
        return b

    def u8(self) -> int:
        return self._read(1)[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._read(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self._read(8))[0]

    def i32_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(4 * n), dtype=">i4").astype(np.int32)

    def f64_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(8 * n), dtype=">f8").astype(np.float64)

    # ---- object decoding -------------------------------------------------

    def length(self) -> int:
        n = self.i32()
        if n == -1:  # long vector: two 32-bit words
            hi = self.i32()
            lo = self.i32()
            n = (hi << 32) | (lo & 0xFFFFFFFF)
        return n

    def read_object(self) -> RObject:
        flags = self.i32()
        typ = flags & 0xFF
        has_obj = bool(flags & 0x100)
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)
        levels = flags >> 12

        if typ == NILVALUE_SXP or typ == NILSXP:
            return RObject(NILSXP, None)

        if typ == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i32()
            return self._refs[idx - 1]

        if typ == SYMSXP:
            chobj = self.read_object()
            obj = RObject(SYMSXP, chobj.value)
            self._refs.append(obj)
            return obj

        if typ == CHARSXP:
            n = self.i32()
            if n == -1:
                return RObject(CHARSXP, None)  # NA_character_
            raw = self._read(n)
            try:
                s = raw.decode("utf-8")
            except UnicodeDecodeError:
                s = raw.decode("latin-1")
            return RObject(CHARSXP, s)

        if typ in (LISTSXP, LANGSXP, ATTRLISTSXP, ATTRLANGSXP):
            # Dotted-pair list; attributes/tag precede CAR.
            attrs: Dict[str, RObject] = {}
            if has_attr:
                attrs = self._read_attributes()
            tag = None
            if has_tag:
                tag_obj = self.read_object()
                tag = tag_obj.value
            car = self.read_object()
            car.tag = tag
            cdr = self.read_object()
            items: List[RObject] = [car]
            if cdr.type in (LISTSXP, LANGSXP):
                items.extend(cdr.value)
            obj = RObject(LISTSXP, items, attrs)
            return obj

        if typ == S4SXP:
            attrs = self._read_attributes() if has_attr else {}
            return RObject(S4SXP, None, attrs)

        if typ in (LGLSXP, INTSXP):
            n = self.length()
            vals = self.i32_array(n)
            obj = RObject(typ, vals)
        elif typ == REALSXP:
            n = self.length()
            obj = RObject(typ, self.f64_array(n))
        elif typ == CPLXSXP:
            n = self.length()
            data = self.f64_array(2 * n)
            obj = RObject(typ, data[0::2] + 1j * data[1::2])
        elif typ == STRSXP:
            n = self.length()
            strs = [self.read_object().value for _ in range(n)]
            obj = RObject(typ, strs)
        elif typ in (VECSXP, EXPRSXP):
            n = self.length()
            obj = RObject(VECSXP, [self.read_object() for _ in range(n)])
        elif typ == RAWSXP:
            n = self.length()
            obj = RObject(RAWSXP, np.frombuffer(self._read(n), dtype=np.uint8))
        elif typ == ALTREP_SXP:
            info = self.read_object()
            state = self.read_object()
            attr = self.read_object()
            obj = self._decode_altrep(info, state)
        elif typ in (GLOBALENV_SXP, EMPTYENV_SXP, BASEENV_SXP,
                     UNBOUNDVALUE_SXP, MISSINGARG_SXP):
            obj = RObject(typ, None)
        else:
            raise NotImplementedError(f"R SEXP type {typ} not supported")

        if has_attr and typ not in (LISTSXP, LANGSXP, S4SXP):
            obj.attributes = self._read_attributes()
        _ = (has_obj, levels)
        return obj

    def _decode_altrep(self, info: RObject, state: RObject) -> RObject:
        # info is a pairlist/lang: (class_symbol package type)
        name = None
        if isinstance(info.value, list) and info.value:
            name = info.value[0].value
        if name == "compact_intseq":
            # state: REALSXP [n, start, step]
            n, start, step = state.value
            return RObject(INTSXP, (np.arange(n) * step + start).astype(np.int32))
        if name == "compact_realseq":
            n, start, step = state.value
            return RObject(REALSXP, np.arange(n) * step + start)
        if name in ("wrap_integer", "wrap_real", "wrap_string", "wrap_logical"):
            inner = state.value[0] if isinstance(state.value, list) else state
            return inner
        if name == "deferred_string":
            inner = state.value[0] if isinstance(state.value, list) else state
            # Coerce numerics to strings the way R would.
            vals = inner.value
            return RObject(STRSXP, [str(v) for v in vals])
        raise NotImplementedError(f"ALTREP class {name!r} not supported")

    def _read_attributes(self) -> Dict[str, RObject]:
        attrs: Dict[str, RObject] = {}
        obj = self.read_object()
        if obj.type == LISTSXP and obj.value is not None:
            for item in obj.value:
                if item.tag is not None:
                    attrs[item.tag] = item
        return attrs


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"BZ":
        return bz2.decompress(raw)
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(raw)
    return raw


def parse_rdata(path: str) -> Dict[str, RObject]:
    """Parse an .RData / .rda file into ``{name: RObject}``."""
    data = _decompress(open(path, "rb").read())
    if not (data[:5] in (b"RDX2\n", b"RDX3\n")):
        raise ValueError("not an RDX2/RDX3 .RData file")
    r = _XDRReader(data[5:])
    fmt = r._read(2)
    if fmt != b"X\n":
        raise NotImplementedError("only XDR-format RData supported")
    version = r.i32()
    r.i32()  # writer version
    r.i32()  # min reader version
    if version >= 3:
        n = r.i32()  # native encoding string
        r._read(n)
    out: Dict[str, RObject] = {}
    top = r.read_object()
    if top.type == LISTSXP:
        for item in top.value:
            if item.tag is not None:
                out[item.tag] = item
    return out


def s4_to_scipy(obj: RObject):
    """Convert a Matrix-package S4 sparse matrix RObject to scipy.sparse."""
    import scipy.sparse as sp

    cls = obj.attr("class")
    cls_name = cls[0] if isinstance(cls, list) else cls
    dim = obj.attr("Dim")
    nrow, ncol = int(dim[0]), int(dim[1])
    x = obj.attr("x")
    dn = obj.attributes.get("Dimnames")
    names: Tuple[Optional[list], Optional[list]] = (None, None)
    if dn is not None and isinstance(dn.value, list):
        def _names(o):
            return o.value if o.type == STRSXP else None
        names = (_names(dn.value[0]), _names(dn.value[1]))

    if cls_name in ("dgCMatrix", "lgCMatrix", "ngCMatrix"):
        i = obj.attr("i")
        p = obj.attr("p")
        if x is None:  # pattern matrix
            x = np.ones(len(i), dtype=np.float64)
        m = sp.csc_matrix((np.asarray(x), np.asarray(i), np.asarray(p)),
                          shape=(nrow, ncol))
    elif cls_name in ("dgRMatrix", "lgRMatrix", "ngRMatrix"):
        j = obj.attr("j")
        p = obj.attr("p")
        if x is None:
            x = np.ones(len(j), dtype=np.float64)
        m = sp.csr_matrix((np.asarray(x), np.asarray(j), np.asarray(p)),
                          shape=(nrow, ncol))
    elif cls_name in ("dgTMatrix", "lgTMatrix", "ngTMatrix"):
        i = obj.attr("i")
        j = obj.attr("j")
        if x is None:
            x = np.ones(len(i), dtype=np.float64)
        m = sp.coo_matrix((np.asarray(x), (np.asarray(i), np.asarray(j))),
                          shape=(nrow, ncol))
    else:
        raise NotImplementedError(f"S4 class {cls_name!r} not supported")
    m.row_names = names[0]  # type: ignore[attr-defined]
    m.col_names = names[1]  # type: ignore[attr-defined]
    return m
