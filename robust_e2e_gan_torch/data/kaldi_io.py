"""Kaldi ark/scp matrix and vector I/O (pure numpy).

Port of ``robust_e2e_gan_tpu/data/kaldi_io.py``, the port's own copy (it
imports nothing of the JAX package): the Kaldi binary table format, read
and written byte for byte as the JAX module does,

  ark entry:  <key> ' ' <binary-blob>
  blob:       '\\0B' magic, then 'FM'/'DM' (float/double matrix) or
              'FV'/'DV' (vector), then for matrices
              '\\4' int32 rows '\\4' int32 cols, then row-major data.
  scp entry:  <key> ' ' <ark-path>:<byte-offset>\\n

Text-format ark ("[ 1 2\\n 3 4 ]") is also read, since CMVN stats are often
shipped that way. Compressed matrices (the Kaldi CompressedMatrix formats
"CM" / "CM2" / "CM3") are read and written too — real Kaldi-prepped CHiME-4
dirs usually ship compressed feats, so a Kaldi corpus drops in unchanged:

  CM  (format 1): GlobalHeader {f32 min, f32 range, i32 rows, i32 cols},
      then cols x PerColHeader {4 x u16 percentiles p0,p25,p75,p100 encoded
      on the global [min, min+range] scale}, then column-major u8 codes
      (0..64 -> [p0,p25], 64..192 -> [p25,p75], 192..255 -> [p75,p100]).
  CM2 (format 2): GlobalHeader, then row-major u16 on the global scale.
  CM3 (format 3): GlobalHeader, then row-major u8 on the global scale.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, Iterator, Tuple

import numpy as np


def _read_token(f: BinaryIO) -> str:
    chars = []
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        chars.append(c)
    return b"".join(chars).decode()


def _expect(f: BinaryIO, token: bytes) -> None:
    got = f.read(len(token))
    if got != token:
        raise ValueError(f"expected {token!r}, got {got!r}")


def _read_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def read_matrix(f: BinaryIO) -> np.ndarray:
    """Read one matrix/vector blob at the current position."""
    binary = f.read(2)
    if binary != b"\x00B":
        # text format: everything up to the closing ']'
        rest = binary + f.readline()
        rows = []
        if b"[" in rest:
            rest = rest.split(b"[", 1)[1]
        while True:
            line = rest if rows == [] and rest.strip() else f.readline()
            rest = b""
            if not line:
                raise ValueError("unterminated text matrix")
            done = b"]" in line
            line = line.replace(b"]", b" ")
            vals = line.split()
            if vals:
                rows.append([float(x) for x in vals])
            if done:
                break
        return np.asarray(rows, dtype=np.float32)

    kind = _read_token(f)
    if kind in ("FM", "DM"):
        rows = _read_int32(f)
        cols = _read_int32(f)
        dt = np.float32 if kind == "FM" else np.float64
        data = np.frombuffer(f.read(rows * cols * dt().itemsize), dtype=dt)
        return data.reshape(rows, cols).astype(np.float32)
    if kind in ("FV", "DV"):
        n = _read_int32(f)
        dt = np.float32 if kind == "FV" else np.float64
        data = np.frombuffer(f.read(n * dt().itemsize), dtype=dt)
        return data.astype(np.float32)
    if kind in ("CM", "CM2", "CM3"):
        return _read_compressed(f, kind)
    raise ValueError(f"unknown Kaldi blob kind {kind!r}")


def _read_compressed(f: BinaryIO, kind: str) -> np.ndarray:
    """Decompress a Kaldi CompressedMatrix blob (format per module doc)."""
    min_value, value_range = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if kind == "CM2":
        data = np.frombuffer(f.read(2 * rows * cols), dtype="<u2")
        mat = min_value + value_range * data.astype(np.float64) / 65535.0
        return mat.reshape(rows, cols).astype(np.float32)
    if kind == "CM3":
        data = np.frombuffer(f.read(rows * cols), dtype=np.uint8)
        mat = min_value + value_range * data.astype(np.float64) / 255.0
        return mat.reshape(rows, cols).astype(np.float32)
    # format 1: per-column percentile headers + u8 codes, column-major
    hdr = np.frombuffer(f.read(8 * cols), dtype="<u2").reshape(cols, 4)
    pct = (
        min_value + value_range * hdr.astype(np.float64) / 65535.0
    )  # (cols, 4): p0, p25, p75, p100 per column
    codes = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(
        cols, rows
    ).astype(np.float64)
    p0, p25, p75, p100 = (pct[:, i : i + 1] for i in range(4))
    lo = p0 + (p25 - p0) * (codes / 64.0)
    mid = p25 + (p75 - p25) * ((codes - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((codes - 192.0) / 63.0)
    col_major = np.where(
        codes <= 64, lo, np.where(codes <= 192, mid, hi)
    )
    return col_major.T.astype(np.float32)


def _float_to_u16(vals: np.ndarray, min_value: float, rng: float):
    x = np.clip((vals - min_value) / max(rng, 1e-20), 0.0, 1.0)
    return np.round(x * 65535.0).astype("<u2")


def write_compressed_mat(
    f: BinaryIO, key: str, mat: np.ndarray, fmt: int = 1
) -> int:
    """Append one compressed (CM/CM2/CM3) entry; returns blob offset.

    The encoder mirrors Kaldi's CompressedMatrix: global [min, range] scale,
    per-column percentile anchors for format 1 (taken at the sorted column's
    0/25/75/100 percentiles), piecewise-linear u8 codes.
    """
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    if mat.ndim != 2:
        raise ValueError("compressed write needs a 2-D matrix")
    rows, cols = mat.shape
    min_value = float(mat.min()) if mat.size else 0.0
    value_range = max(float(mat.max()) - min_value, 1e-10)

    f.write(key.encode() + b" ")
    offset = f.tell()
    f.write(b"\x00B")
    f.write({1: b"CM ", 2: b"CM2 ", 3: b"CM3 "}[fmt])
    f.write(struct.pack("<ffii", min_value, value_range, rows, cols))
    if fmt == 2:
        f.write(_float_to_u16(mat, min_value, value_range).tobytes())
        return offset
    if fmt == 3:
        x = np.clip((mat - min_value) / value_range, 0.0, 1.0)
        f.write(np.round(x * 255.0).astype(np.uint8).tobytes())
        return offset

    srt = np.sort(mat, axis=0)  # per-column percentile anchors
    q = lambda frac: srt[min(int(frac * (rows - 1)), rows - 1)]
    p0, p25, p75, p100 = q(0.0), q(0.25), q(0.75), q(1.0)
    p25 = np.maximum(p25, p0)
    p75 = np.maximum(p75, p25)
    p100 = np.maximum(p100, p75)
    hdr = np.stack([
        _float_to_u16(p, min_value, value_range)
        for p in (p0, p25, p75, p100)
    ], axis=1)  # (cols, 4)
    # re-decode the quantized anchors so codes are chosen against what the
    # reader will reconstruct (Kaldi does the same)
    pq = min_value + value_range * hdr.astype(np.float64) / 65535.0
    p0q, p25q, p75q, p100q = (pq[:, i] for i in range(4))
    cm = mat.T.astype(np.float64)  # (cols, rows)

    def enc(vals, lo, hi, base, scale):
        span = np.maximum((hi - lo)[:, None], 1e-20)
        return base + np.clip(
            np.round((vals - lo[:, None]) / span * scale), 0, scale
        )

    codes = np.where(
        cm <= p25q[:, None],
        enc(cm, p0q, p25q, 0.0, 64.0),
        np.where(
            cm <= p75q[:, None],
            enc(cm, p25q, p75q, 64.0, 128.0),
            enc(cm, p75q, p100q, 192.0, 63.0),
        ),
    ).astype(np.uint8)
    f.write(hdr.astype("<u2").tobytes())
    f.write(codes.tobytes())
    return offset


def read_shape(f: BinaryIO) -> Tuple[int, int]:
    """Read ONLY the (rows, cols) header of the blob at the current
    position — no payload decode. Vectors report (n, 1). Text-format blobs
    have no header, so they fall back to a full parse.

    This keeps dataset construction O(entries), not O(corpus bytes)
    (SURVEY.md call stack 3.5: the index build needs lengths only).
    """
    start = f.tell()
    binary = f.read(2)
    if binary != b"\x00B":
        f.seek(start)
        m = read_matrix(f)
        return (m.shape[0], m.shape[1] if m.ndim == 2 else 1)
    kind = _read_token(f)
    if kind in ("FM", "DM"):
        return _read_int32(f), _read_int32(f)
    if kind in ("FV", "DV"):
        return _read_int32(f), 1
    if kind in ("CM", "CM2", "CM3"):
        f.read(8)  # min, range
        rows, cols = struct.unpack("<ii", f.read(8))
        return rows, cols
    raise ValueError(f"unknown Kaldi blob kind {kind!r}")


def read_shape_at(ark_path: str, offset: int) -> Tuple[int, int]:
    """Header-only (rows, cols) probe at an scp pointer."""
    with open(ark_path, "rb") as f:
        f.seek(offset)
        return read_shape(f)


def read_mat_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) over a binary/text ark file."""
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            yield key, read_matrix(f)


def read_mat_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) following an scp's ark:offset pointers.

    Consecutive entries pointing into the same ark reuse one open handle
    (scp files are usually grouped by ark, so this is one open per ark,
    not one per utterance)."""
    cur_path, cur_f = None, None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, rx = line.split(None, 1)
                ark_path, _, offset = rx.rpartition(":")
                if ark_path != cur_path:
                    if cur_f is not None:
                        cur_f.close()
                    cur_path, cur_f = ark_path, open(ark_path, "rb")
                cur_f.seek(int(offset))
                yield key, read_matrix(cur_f)
    finally:
        if cur_f is not None:
            cur_f.close()


def read_scp_index(path: str) -> Dict[str, Tuple[str, int]]:
    """scp -> {key: (ark_path, offset)} for random access."""
    out: Dict[str, Tuple[str, int]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, rx = line.split(None, 1)
            ark_path, _, offset = rx.rpartition(":")
            out[key] = (ark_path, int(offset))
    return out


def read_mat_at(ark_path: str, offset: int) -> np.ndarray:
    with open(ark_path, "rb") as f:
        f.seek(offset)
        return read_matrix(f)


def write_mat(
    f: BinaryIO, key: str, mat: np.ndarray
) -> int:
    """Append one (key, float matrix/vector) entry; returns blob offset."""
    f.write(key.encode() + b" ")
    offset = f.tell()
    f.write(b"\x00B")
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    if mat.ndim == 2:
        f.write(b"FM ")
        f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
        f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    elif mat.ndim == 1:
        f.write(b"FV ")
        f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    else:
        raise ValueError(f"only 1-D/2-D supported, got shape {mat.shape}")
    f.write(mat.tobytes())
    return offset


def write_ark_scp(
    entries: Iterator[Tuple[str, np.ndarray]],
    ark_path: str,
    scp_path: str = None,
    compress: int = 0,
    atomic: bool = False,
) -> int:
    """Write an ark (and optional matching scp) from (key, matrix) pairs.

    compress: 0 writes uncompressed FM blobs; 1/2/3 write CM/CM2/CM3.
    atomic: stage both files as .tmp and rename on completion, so readers
    never observe a partially written ark/scp. Returns the entry count.
    """
    ark_tmp = ark_path + ".tmp" if atomic else ark_path
    scp_lines = []
    n = 0
    with open(ark_tmp, "wb") as f:
        for key, mat in entries:
            if compress:
                offset = write_compressed_mat(f, key, mat, fmt=compress)
            else:
                offset = write_mat(f, key, mat)
            if scp_path:
                scp_lines.append(
                    f"{key} {os.path.abspath(ark_path)}:{offset}\n"
                )
            n += 1
    if atomic:
        os.replace(ark_tmp, ark_path)
    if scp_path:
        scp_tmp = scp_path + ".tmp" if atomic else scp_path
        with open(scp_tmp, "w") as f:
            f.writelines(scp_lines)
        if atomic:
            os.replace(scp_tmp, scp_path)
    return n
