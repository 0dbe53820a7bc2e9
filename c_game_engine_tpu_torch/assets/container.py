"""The `.g*` asset container (counterpart of
c_game_engine_tpu/assets/container.py): a 23-byte little-endian header
followed by one gzip stream.

Header layout (the reference's AssetReader.c and Asset.h):

    u32  magic            0x454D4147 ("GAME")
    u8   container version (2)
    u8   asset type        (AssetType enum)
    u8   type version
    u64  decompressed size
    u64  compressed size   (must equal file size - 23)

The payload is a gzip (not raw deflate) stream, written at gzip's default
level with mtime 0, so a written file is byte-equal to the JAX package's.
"""

from __future__ import annotations

import enum
import gzip
import struct
from dataclasses import dataclass
from pathlib import Path

MAGIC = 0x454D4147
CONTAINER_VERSION = 2
HEADER = struct.Struct("<IBBBQQ")


class AssetType(enum.IntEnum):
    # reference: engine/include/engine/structs/Asset.h:15-26
    TEXTURE = 0
    WAV = 1
    MAP = 2
    SHADER = 3
    MODEL = 4
    FONT = 5
    MAP_MATERIAL = 7
    KV_LIST = 8


@dataclass
class Asset:
    type: AssetType
    type_version: int
    data: bytes


class AssetFormatError(ValueError):
    pass


def read_asset(path: str | Path) -> Asset:
    raw = Path(path).read_bytes()
    if len(raw) < HEADER.size:
        raise AssetFormatError(f"{path}: file shorter than container header")
    magic, version, atype, type_version, dsize, csize = HEADER.unpack_from(raw, 0)
    if magic != MAGIC:
        raise AssetFormatError(f"{path}: bad magic {magic:#x}")
    if version != CONTAINER_VERSION:
        raise AssetFormatError(f"{path}: unsupported container version {version}")
    if len(raw) - HEADER.size != csize:
        raise AssetFormatError(f"{path}: compressed size {csize} != file remainder {len(raw) - HEADER.size}")
    try:
        data = gzip.decompress(raw[HEADER.size:])
    except (OSError, EOFError) as e:  # BadGzipFile / truncated stream
        raise AssetFormatError(f"{path}: corrupt payload ({e})") from e
    if len(data) != dsize:
        raise AssetFormatError(f"{path}: decompressed size {len(data)} != header {dsize}")
    return Asset(AssetType(atype), type_version, data)


def write_asset(path: str | Path, asset: Asset) -> None:
    payload = gzip.compress(asset.data, mtime=0)
    header = HEADER.pack(MAGIC, CONTAINER_VERSION, int(asset.type), asset.type_version, len(asset.data),
                         len(payload))
    Path(path).write_bytes(header + payload)
