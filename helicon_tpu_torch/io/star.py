"""STAR file parser and writer (no starfile dependency).

A copy of the Python path of ``helicon_tpu/io/star.py``: multiple data_
blocks, loop_ tables, key-value blocks, comments and numeric type
inference, read and written as the original's pure-Python path does. The
original's C++ codec (``native/star_codec.cpp``: its loop parser, block
splitter, string gather and row formatter) is not copied; it gives the
same frames and the same text. tests/test_torch_metadata.py pins the copy
to the original.
"""

from __future__ import annotations

import io as _io
import shlex
from pathlib import Path

import numpy as np
import pandas as pd

__all__ = ["read_star", "write_star"]


def _coerce(series: pd.Series) -> pd.Series:
    """Numeric conversion where the whole column parses."""
    s = pd.to_numeric(series, errors="coerce")
    if s.notna().all():
        try:
            as_int = s.astype(np.int64)
            if (as_int == s).all():
                return as_int
        except (ValueError, TypeError, OverflowError):
            pass  # non-finite or out-of-int64-range floats stay float
        return s
    return series


def _tokenize(line: str):
    if '"' in line or "'" in line:
        return shlex.split(line, comments=False)
    return line.split()


def read_star(path_or_buffer):
    """Parse a STAR file into {block_name: DataFrame | dict}.

    loop_ tables become DataFrames; bare key-value blocks become dicts.
    Block names keep their ``data_`` suffix stripped ("" for ``data_``).
    """
    if hasattr(path_or_buffer, "read"):
        text = path_or_buffer.read()
    else:
        text = Path(path_or_buffer).read_text()
    return _read_star_python(text)


def _read_star_python(text: str):
    """Line-machine reference parser (also the fallback for quoted or
    unusually shaped files)."""
    blocks: dict = {}
    name = None
    mode = None  # None | "loop_header" | "loop_rows" | "pairs"
    cols: list = []
    rows: list = []
    pairs: dict = {}
    loop_idx = 0  # loop_ tables seen in the current data_ block

    def flush():
        nonlocal cols, rows, pairs
        if name is None:
            cols, rows, pairs = [], [], {}
            return
        # a block's 2nd+ loop table keys as "<name>#loop<k>" instead of
        # silently overwriting (and thus losing) the earlier table
        key_name = name if loop_idx <= 1 else f"{name}#loop{loop_idx}"
        if cols:
            # rows holds RAW lines; per-token work happens here
            toks = []
            for irow, line in enumerate(rows):
                vals = _tokenize(line)
                if len(vals) != len(cols):
                    # fail loudly like the reference's starfile does
                    # on malformed input — a silently truncated
                    # table corrupts the pipeline
                    raise ValueError(
                        f"STAR loop row has {len(vals)} tokens but "
                        f"the header declares {len(cols)} columns "
                        f"(block 'data_{name}', row {irow + 1}): "
                        f"{line!r}"
                    )
                toks.append(vals)
            df = pd.DataFrame(toks, columns=cols)
            for c in df.columns:
                df[c] = _coerce(df[c])
            blocks[key_name] = df
        elif pairs:
            blocks[key_name] = dict(pairs)
        cols, rows, pairs = [], [], {}

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("data_"):
            flush()
            name = line[5:]
            mode = "pairs"
            loop_idx = 0
            continue
        if line.startswith("loop_"):
            if cols and rows:
                flush()  # preserve the block's previous loop table
            mode = "loop_header"
            loop_idx += 1
            cols = []
            rows = []
            continue
        if mode == "loop_header" and line.startswith("_"):
            cols.append(line.split()[0][1:])
            continue
        if mode in ("loop_header", "loop_rows") and not line.startswith("_"):
            mode = "loop_rows"
            rows.append(line)
            continue
        if line.startswith("_"):
            parts = _tokenize(line)
            key = parts[0][1:]
            val = parts[1] if len(parts) > 1 else ""
            try:
                num = float(val)
                val = (
                    int(num)
                    if np.isfinite(num) and num == int(num) and "." not in str(val)
                    else num
                )
            except (ValueError, TypeError, OverflowError):
                pass
            pairs[key] = val
            continue
    flush()
    return blocks


def _fmt(v) -> str:
    if isinstance(v, (float, np.floating)):
        return f"{v:.6f}"
    return str(v)


def write_star(path_or_buffer, blocks):
    """Write {block_name: DataFrame | dict} as STAR.

    A bare DataFrame is accepted and written as ``data_``.
    """
    if isinstance(blocks, pd.DataFrame):
        blocks = {"": blocks}
    out = _io.StringIO()
    out.write("# version 30001\n")
    for name, content in blocks.items():
        out.write(f"\ndata_{name}\n\n")
        if isinstance(content, dict):
            for k, v in content.items():
                out.write(f"_{k}\t{_fmt(v)}\n")
            continue
        df = content
        out.write("loop_\n")
        for i, c in enumerate(df.columns):
            out.write(f"_{c} #{i + 1}\n")
        # column-wise vectorized formatting (a per-row iterrows loop is
        # ~20x slower on 100k-row tables)
        cols = []
        for c in df.columns:
            s = df[c]
            if pd.api.types.is_float_dtype(s):
                cols.append(s.map("{:.6f}".format).to_numpy())
            else:
                cols.append(s.astype(str).to_numpy())
        if cols:
            body = cols[0]
            for col in cols[1:]:
                body = np.char.add(np.char.add(body.astype(str), " "), col.astype(str))
            out.write("\n".join(body))
            out.write("\n")
    text = out.getvalue()
    if hasattr(path_or_buffer, "write"):
        path_or_buffer.write(text)
    else:
        Path(path_or_buffer).write_text(text)
