"""Minimal OpenEXR codec of the port (numpy + zlib), written from the public
OpenEXR file-format specification.

It carries what the denoiser's files use: single-part scanline images,
channel types HALF and FLOAT (UINT is read too), compression NONE, RLE,
ZIPS and ZIP on read and ZIP on write. Its output is byte for byte that of
``bcd_tpu/io/exr.py``'s default writer. Other files (PXR24, PIZ, B44, DWA,
tiled, deep, multi-part) raise :class:`ExrError`: ROADMAP.md Queue 1 lists
them as still to be ported.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = 20000630
VERSION = 2

# pixel types (OpenEXR attribute values)
UINT, HALF, FLOAT = 0, 1, 2
_DTYPE = {UINT: np.dtype("<u4"), HALF: np.dtype("<f2"), FLOAT: np.dtype("<f4")}

# compression id -> scanlines per chunk, for the compressions carried here
NO_COMPRESSION, RLE_COMPRESSION, ZIPS_COMPRESSION, ZIP_COMPRESSION = 0, 1, 2, 3
_LINES_PER_CHUNK = {NO_COMPRESSION: 1, RLE_COMPRESSION: 1,
                    ZIPS_COMPRESSION: 1, ZIP_COMPRESSION: 16}

_NOT_SCANLINE = 0x200 | 0x800 | 0x1000  # version bits: tiled, deep, multi-part


class ExrError(RuntimeError):
    pass


def _predict(raw: bytes) -> bytes:
    """The ZIP/RLE predictor: interleave the bytes into two halves, then
    store byte deltas + 128 (mod 256)."""
    arr = np.frombuffer(raw, np.uint8)
    split = np.concatenate([arr[0::2], arr[1::2]])
    out = split.copy()
    out[1:] = split[1:] - split[:-1] + np.uint8(128)
    return out.tobytes()


def _unpredict(data: bytes) -> bytes:
    """Inverse of :func:`_predict`."""
    deltas = np.frombuffer(data, np.uint8).copy()
    deltas[1:] -= np.uint8(128)
    split = np.cumsum(deltas, dtype=np.uint8)
    half = (split.size + 1) // 2
    out = np.empty_like(split)
    out[0::2], out[1::2] = split[:half], split[half:]
    return out.tobytes()


def _rle_decode(data: bytes, expected: int) -> bytes:
    """OpenEXR run lengths: a signed count byte c, then c + 1 copies of one
    byte (c >= 0) or -c literal bytes (c < 0)."""
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        count = data[i]
        if count > 127:
            out += data[i + 1 : i + 1 + 256 - count]
            i += 1 + 256 - count
        else:
            out += data[i + 1 : i + 2] * (count + 1)
            i += 2
    if len(out) != expected:
        raise ExrError(f"RLE chunk decoded to {len(out)} bytes, "
                       f"expected {expected}")
    return bytes(out)


def _decompress(data: bytes, raw_size: int, compression: int) -> bytes:
    if compression == NO_COMPRESSION or len(data) == raw_size:
        return data  # a chunk that would not shrink is stored raw
    if compression == RLE_COMPRESSION:
        return _unpredict(_rle_decode(data, raw_size))
    return _unpredict(zlib.decompress(data))


def _cstring(data: bytes, pos: int) -> Tuple[str, int]:
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _parse_channels(payload: bytes) -> List[Tuple[str, int]]:
    channels, pos = [], 0
    while payload[pos] != 0:
        name, pos = _cstring(payload, pos)
        (pixel_type,) = struct.unpack_from("<i", payload, pos)
        channels.append((name, pixel_type))
        pos += 16  # pixel type, pLinear + 3 reserved, x/y sampling
    return channels


def read_exr(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read a single-part scanline EXR. Returns ``(channels, info)``:
    channel name -> (H, W) float32 plane, and ``width`` and ``height``."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8 or struct.unpack_from("<i", data, 0)[0] != MAGIC:
        raise ExrError(f"{path}: not an EXR file")
    (version,) = struct.unpack_from("<i", data, 4)
    if version & _NOT_SCANLINE:
        raise ExrError(f"{path}: tiled, deep and multi-part EXR files are "
                       "not carried by the port yet (ROADMAP.md Queue 1)")
    attrs, pos = {}, 8
    while data[pos] != 0:
        name, pos = _cstring(data, pos)
        _, pos = _cstring(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        attrs[name] = data[pos + 4 : pos + 4 + size]
        pos += 4 + size
    pos += 1
    channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in _LINES_PER_CHUNK:
        raise ExrError(f"{path}: EXR compression id {compression} is not "
                       "carried by the port yet (ROADMAP.md Queue 1)")
    xmin, ymin, xmax, ymax = struct.unpack_from("<iiii", attrs["dataWindow"])
    width, height = xmax - xmin + 1, ymax - ymin + 1
    lines = _LINES_PER_CHUNK[compression]
    n_chunks = (height + lines - 1) // lines
    offsets = struct.unpack_from(f"<{n_chunks}Q", data, pos)

    widths = [width * _DTYPE[t].itemsize for _, t in channels]
    starts = np.cumsum([0] + widths)
    planes = {name: np.empty((height, width), _DTYPE[t])
              for name, t in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        y -= ymin
        n = min(lines, height - y)
        raw = _decompress(data[off + 8 : off + 8 + size], starts[-1] * n,
                          compression)
        # each scanline holds one full row per channel, channels in order
        rows = np.frombuffer(raw, np.uint8).reshape(n, starts[-1])
        for (name, t), s, e in zip(channels, starts[:-1], starts[1:]):
            planes[name][y : y + n] = np.ascontiguousarray(
                rows[:, s:e]).view(_DTYPE[t])
    info = {"width": width, "height": height}
    return {k: v.astype(np.float32) for k, v in planes.items()}, info


def _attr(name: str, type_name: str, payload: bytes) -> bytes:
    return (name.encode() + b"\0" + type_name.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def write_exr(path: str, channels: Dict[str, np.ndarray],
              pixel_types: Optional[Dict[str, int]] = None) -> None:
    """Write a single-part scanline EXR, ZIP-compressed. ``channels`` maps
    name -> (H, W) array; ``pixel_types`` overrides the stored type per
    channel (default FLOAT)."""
    if not channels:
        raise ExrError("no channels to write")
    names = sorted(channels)  # EXR stores channels alphabetically
    shapes = {channels[n].shape for n in names}
    if len(shapes) != 1:
        raise ExrError(f"channel shape mismatch: {shapes}")
    ((height, width),) = shapes
    types = {n: (pixel_types or {}).get(n, FLOAT) for n in names}
    chlist = b"".join(n.encode() + b"\0"
                      + struct.pack("<iBBBBii", types[n], 0, 0, 0, 0, 1, 1)
                      for n in names) + b"\0"
    box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    header = b"".join([
        struct.pack("<ii", MAGIC, VERSION),
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression",
              struct.pack("<B", ZIP_COMPRESSION)),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", struct.pack("<B", 0)),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\0"])

    lines = _LINES_PER_CHUNK[ZIP_COMPRESSION]
    planes = [np.ascontiguousarray(channels[n], _DTYPE[types[n]]).view(
        np.uint8).reshape(height, -1) for n in names]
    chunks = []
    for y0 in range(0, height, lines):
        raw = np.concatenate([p[y0 : y0 + lines] for p in planes],
                             axis=1).tobytes()
        packed = zlib.compress(_predict(raw), 6)
        if len(packed) >= len(raw):
            packed = raw
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)
    offsets = np.cumsum([len(header) + 8 * len(chunks)]
                        + [len(c) for c in chunks[:-1]])
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{len(chunks)}Q", *(int(o) for o in offsets)))
        for chunk in chunks:
            f.write(chunk)
