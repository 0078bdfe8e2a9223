"""Per-chunk codecs for the chunk store (the JPEG 2000 role, §III.C).

The paper stores pre-processed imagery as JPEG 2000 / JPX for "compression
and image types as well as its support for internal tiling and a scalable
multi-resolution codestream".  The framework-level property is a *pluggable
per-chunk codec behind a stable byte format*, not the specific wavelet
transform, so this module provides a registry of codecs appropriate for
tensor data:

* ``raw``        — passthrough
* ``zlib``       — DEFLATE
* ``delta-zlib`` — byte-level delta then DEFLATE (integer rasters; the
                   satellite-band analogue of JPEG 2000's decorrelation step)
* ``f32-bf16``   — lossy 2x float compression (truncate mantissa), the
                   checkpoint-friendly analogue of JPEG 2000 lossy mode

Encoded chunk layout: ``magic(2) | codec_id(1) | version(1) | payload``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict

import numpy as np

_MAGIC = b"\xf5\x7e"  # 'festivus'
_VERSION = 1


class Codec:
    codec_id: int = -1
    name: str = "abstract"

    def encode_payload(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decode_payload(self, payload: bytes) -> bytes:
        raise NotImplementedError

    def encode(self, data: bytes) -> bytes:
        return _MAGIC + struct.pack("BB", self.codec_id, _VERSION) + \
            self.encode_payload(bytes(data))


class RawCodec(Codec):
    codec_id = 0
    name = "raw"

    def encode_payload(self, data: bytes) -> bytes:
        return data

    def decode_payload(self, payload: bytes) -> bytes:
        return payload


class ZlibCodec(Codec):
    codec_id = 1
    name = "zlib"

    def __init__(self, level: int = 1):
        self.level = level

    def encode_payload(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decode_payload(self, payload: bytes) -> bytes:
        return zlib.decompress(payload)


class DeltaZlibCodec(Codec):
    """Byte-delta + DEFLATE: effective on smooth integer rasters (imagery)."""

    codec_id = 2
    name = "delta-zlib"

    def __init__(self, level: int = 1):
        self.level = level

    def encode_payload(self, data: bytes) -> bytes:
        if not data:
            return zlib.compress(b"", self.level)
        arr = np.frombuffer(data, dtype=np.uint8).astype(np.int16)
        delta = np.empty_like(arr)
        delta[0] = arr[0]
        delta[1:] = arr[1:] - arr[:-1]
        return zlib.compress((delta % 256).astype(np.uint8).tobytes(), self.level)

    def decode_payload(self, payload: bytes) -> bytes:
        delta = np.frombuffer(zlib.decompress(payload), dtype=np.uint8)
        if delta.size == 0:
            return b""
        return np.cumsum(delta.astype(np.int64)).astype(np.uint8).tobytes()


class F32ToBf16Codec(Codec):
    """Lossy 2x for float32 tensors: drop the low mantissa half.

    Matches TPU-native bf16 semantics exactly (round-to-nearest-even on the
    upper 16 bits would be better; truncation is what checkpoint-side speed
    wants and is within 1 ulp of bf16 rounding).  Decode returns float32
    with the low half zeroed.
    """

    codec_id = 3
    name = "f32-bf16"

    def encode_payload(self, data: bytes) -> bytes:
        u32 = np.frombuffer(data, dtype=np.uint32)
        hi = (u32 >> 16).astype(np.uint16)
        return hi.tobytes()

    def decode_payload(self, payload: bytes) -> bytes:
        hi = np.frombuffer(payload, dtype=np.uint16).astype(np.uint32)
        return (hi << 16).tobytes()


_REGISTRY: Dict[int, Codec] = {}
_BY_NAME: Dict[str, Codec] = {}


def register(codec: Codec):
    _REGISTRY[codec.codec_id] = codec
    _BY_NAME[codec.name] = codec
    return codec


register(RawCodec())
register(ZlibCodec())
register(DeltaZlibCodec())
register(F32ToBf16Codec())


def by_name(name: str) -> Codec:
    if name not in _BY_NAME:
        raise KeyError(f"unknown codec {name!r}; have {sorted(_BY_NAME)}")
    return _BY_NAME[name]


def decode(blob: bytes) -> bytes:
    """Decode any festivus-encoded chunk (codec identified from header)."""
    if blob[:2] != _MAGIC:
        raise ValueError("not a festivus-encoded chunk (bad magic)")
    codec_id, version = struct.unpack("BB", blob[2:4])
    if version != _VERSION:
        raise ValueError(f"unsupported chunk version {version}")
    if codec_id not in _REGISTRY:
        raise ValueError(f"unknown codec id {codec_id}")
    return _REGISTRY[codec_id].decode_payload(blob[4:])
