"""sgg_torch.native — the JPEG decode + resize batch loader and the JPEG
encoder (``jpeg_loader.cc``, ctypes-bound), from ``sgg/native``. It builds with g++ at first use, never at
import; where it cannot, every call raises :class:`NativeUnavailable`, and
callers do not fall back to another decoder."""

from sgg_torch.native.loader import (
    NativeUnavailable,
    decode_batch,
    decode_file,
    decode_raw,
    encode_file,
    image_size,
    native_available,
    resize_plain,
    route,
)

__all__ = [
    "NativeUnavailable",
    "decode_batch",
    "decode_file",
    "decode_raw",
    "encode_file",
    "image_size",
    "native_available",
    "resize_plain",
    "route",
]
