"""Native CSDAT `.cs` container codec (no cryosparc-tools dependency).

A copy of ``helicon_tpu/io/csdat.py`` (host code:
numpy and pandas); tests/test_torch_metadata.py pins the copy to the original.

CryoSPARC v4+ writes `.cs` datasets either as plain ``.npy`` structured
arrays (magic ``\\x93NUMPY``) or as the CSDAT streaming container
(magic ``\\x94CSDAT``). The reference reads both through cryosparc-tools
(reference ``lib/io.py:518-547``); this module implements the
container natively so CSDAT files load without cryosparc-tools.

Container layout (cryosparc-tools ``cryosparc/dataset.py`` /
``cryosparc/stream.py``, v4 series):

    bytes 0-5   magic  b"\\x94CSDAT"
    u32 LE      header byte length
    header      JSON object:
                  {"length": <n_rows>,
                   "dtype":  [[name, descr] | [name, descr, shape], ...],
                   "compression": {"<field>": "lz4", ...},     # optional
                   "compressed_fields": ["<field>", ...]}      # optional
    per field, in dtype order:
    u32 LE      field payload byte length
    payload     the column's C-order bytes, LZ4-block-compressed when the
                header marks the field compressed (the uncompressed byte
                count is n_rows * itemsize, known from the header, as LZ4
                block decoding requires)

Unicode/object columns are stored as fixed-width ``|S`` bytes columns
(the same normalization the NUMPY-format writer applies) and decoded
back to numpy bytes dtype on read — identical post-read semantics to
``read_cs`` on an ``.npy`` twin.

The LZ4 *block* format (not the frame format) is implemented in pure
Python below: full-spec decompression, greedy hash-table compression
(valid, moderately effective; any spec-conforming decoder reads it).
"""

from __future__ import annotations

import json
import struct

import numpy as np

__all__ = [
    "CSDAT_MAGIC",
    "lz4_block_compress",
    "lz4_block_decompress",
    "read_csdat",
    "write_csdat",
]

CSDAT_MAGIC = b"\x94CSDAT"

_MIN_MATCH = 4
# spec end conditions: the last match must start at least 12 bytes before
# the end of the block; the last 5 bytes are always literals
_MFLIMIT = 12
_LAST_LITERALS = 5


def lz4_block_decompress(src: bytes, uncompressed_size: int) -> bytes:
    """Decode one LZ4 *block* (raw sequences, no frame header).

    uncompressed_size bounds the output; a malformed stream raises
    ValueError rather than over-reading.
    """
    src = bytes(src)
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        # literal run
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4: truncated literals")
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence carries literals only
        # match
        if i + 2 > n:
            raise ValueError("lz4: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("lz4: invalid match offset")
        mlen = (token & 0x0F) + _MIN_MATCH
        if (token & 0x0F) == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        # overlapping copy semantics: byte-by-byte from `offset` back
        start = len(out) - offset
        if offset >= mlen:
            out += out[start : start + mlen]
        else:
            for k in range(mlen):
                out.append(out[start + k])
        if len(out) > uncompressed_size:
            raise ValueError("lz4: output exceeds declared size")
    if len(out) != uncompressed_size:
        raise ValueError(
            f"lz4: decoded {len(out)} bytes, expected {uncompressed_size}"
        )
    return bytes(out)


def _write_varlen(out: bytearray, value: int) -> None:
    while value >= 255:
        out.append(255)
        value -= 255
    out.append(value)


def lz4_block_compress(src: bytes) -> bytes:
    """Encode one LZ4 block: greedy single-entry hash table matcher.

    Produces spec-valid output (honors the 12-byte end-of-block match
    limit and the 5 trailing literals rule); ratio is modest but the
    decode side — any conforming LZ4 decoder — reads it fine.
    """
    src = bytes(src)
    n = len(src)
    out = bytearray()
    if n == 0:
        out.append(0)  # one empty-literal token
        return bytes(out)

    def emit(lit_start, lit_end, match_off=None, match_len=0):
        lit = lit_end - lit_start
        token_lit = 15 if lit >= 15 else lit
        token_m = 0
        if match_off is not None:
            m = match_len - _MIN_MATCH
            token_m = 15 if m >= 15 else m
        out.append((token_lit << 4) | token_m)
        if lit >= 15:
            _write_varlen(out, lit - 15)
        out.extend(src[lit_start:lit_end])
        if match_off is not None:
            out.extend(struct.pack("<H", match_off))
            m = match_len - _MIN_MATCH
            if m >= 15:
                _write_varlen(out, m - 15)

    if n < _MFLIMIT + 1:
        emit(0, n)
        return bytes(out)

    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - _MFLIMIT  # last position a match may start at
    while i < limit:
        key = src[i : i + _MIN_MATCH]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand : cand + _MIN_MATCH] == key:
            # extend the match forward, stopping before the tail literals
            mlen = _MIN_MATCH
            max_len = n - _LAST_LITERALS - i
            while mlen < max_len and src[cand + mlen] == src[i + mlen]:
                mlen += 1
            emit(anchor, i, i - cand, mlen)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(anchor, n)  # trailing literals
    return bytes(out)


def _normalize_for_store(arr: np.ndarray) -> np.ndarray:
    """Unicode/object columns -> fixed-width bytes (the .npy writer's
    normalization), so both .cs formats round-trip identically."""
    fields = []
    needs = False
    for name in arr.dtype.names:
        dt, shape = arr.dtype.fields[name][0], ()
        if dt.subdtype is not None:
            base, shape = dt.subdtype
        else:
            base = dt
        if base.kind in ("U", "O"):
            needs = True
            col = np.char.encode(arr[name].astype("U"), "utf-8")
            width = max(1, col.dtype.itemsize)
            fields.append((name, (f"S{width}", shape) if shape else f"S{width}", col))
        else:
            fields.append((name, (base.str, shape) if shape else base.str, arr[name]))
    if not needs:
        return arr
    dtype = [(n, d) for n, d, _ in fields]
    out = np.zeros(arr.shape, dtype=dtype)
    for n, _, col in fields:
        out[n] = col
    return out


def write_csdat(path, arr: np.ndarray, compression: str | None = "lz4") -> None:
    """Write a structured array as a CSDAT container.

    compression: "lz4" compresses every numeric/bytes column whose
    compressed payload is actually smaller; None stores raw bytes.
    """
    if arr.dtype.names is None:
        raise ValueError("write_csdat requires a structured array")
    arr = _normalize_for_store(np.ascontiguousarray(arr))
    dtype_descr = []
    for name in arr.dtype.names:
        dt = arr.dtype.fields[name][0]
        if dt.subdtype is not None:
            base, shape = dt.subdtype
            dtype_descr.append([name, base.str, list(shape)])
        else:
            dtype_descr.append([name, dt.str])
    payloads = []
    compressed_fields = []
    for name in arr.dtype.names:
        raw = np.ascontiguousarray(arr[name]).tobytes()
        if compression == "lz4":
            packed = lz4_block_compress(raw)
            if len(packed) < len(raw):
                payloads.append(packed)
                compressed_fields.append(name)
                continue
        payloads.append(raw)
    header = {
        "length": int(arr.shape[0]),
        "dtype": dtype_descr,
        "compression": {f: "lz4" for f in compressed_fields},
        "compressed_fields": compressed_fields,
    }
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(CSDAT_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for payload in payloads:
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)


def _field_dtype(entry):
    if len(entry) == 2:
        return np.dtype(entry[1])
    name, descr, shape = entry
    return np.dtype((descr, tuple(shape)))


def read_csdat(path) -> np.ndarray:
    """Read a CSDAT container into a numpy structured array."""
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != CSDAT_MAGIC:
            raise ValueError(f"{path}: not a CSDAT container (magic {magic!r})")
        (hdr_len,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hdr_len).decode("utf-8"))
        n_rows = int(header["length"])
        descr = header["dtype"]
        comp = dict(header.get("compression") or {})
        for name in header.get("compressed_fields") or []:
            comp.setdefault(name, "lz4")
        dtype = np.dtype(
            [(e[0], _field_dtype(e)) for e in descr]
        )
        out = np.zeros(n_rows, dtype=dtype)
        for entry in descr:
            name = entry[0]
            fdt = _field_dtype(entry)
            raw_size = n_rows * fdt.itemsize
            (plen,) = struct.unpack("<I", f.read(4))
            payload = f.read(plen)
            if len(payload) != plen:
                raise ValueError(f"{path}: truncated field {name!r}")
            scheme = comp.get(name)
            if scheme == "lz4":
                payload = lz4_block_decompress(payload, raw_size)
            elif scheme:
                raise ValueError(
                    f"{path}: field {name!r} uses unsupported compression "
                    f"{scheme!r} (only lz4/raw CSDAT streams are supported)"
                )
            if len(payload) != raw_size:
                raise ValueError(
                    f"{path}: field {name!r} payload {len(payload)} bytes, "
                    f"expected {raw_size}"
                )
            col = np.frombuffer(payload, dtype=fdt.base)
            if fdt.shape:
                col = col.reshape((n_rows,) + fdt.shape)
            out[name] = col
        return out
