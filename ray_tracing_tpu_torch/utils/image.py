"""Image output, the counterpart of ``ray_tracing_tpu/utils/image.py``.

The card's machine has numpy but no Pillow, so the formats the CLI
writes are encoded here: ``.bmp`` (24-bit, bottom-up, BGR, rows padded
to 4 bytes, byte for byte what the JAX package's native writer
``rt_write_bmp`` writes), ``.png`` (8-bit RGB, zlib from the standard
library) and ``.hdr`` (flat Radiance RGBE).  Any other extension goes
through Pillow, and without Pillow it is refused.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

NATIVE_FORMATS = (".bmp", ".png")


def encode_bmp(rgb_u8: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> the bytes of a 24-bit BMP file."""
    rgb = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = rgb.shape[:2]
    row = (w * 3 + 3) & ~3
    header = struct.pack("<2sIHHI", b"BM", 54 + row * h, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, row * h, 0, 0, 0, 0)
    pixels = np.zeros((h, row), np.uint8)
    pixels[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up, BGR
    return header + info + pixels.tobytes()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> the bytes of an 8-bit RGB PNG file (filter 0 on
    every row)."""
    rgb = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 1 + w * 3), np.uint8)
    raw[:, 1:] = rgb.reshape(h, w * 3)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image(path: str, rgb_u8: np.ndarray) -> None:
    """Save (H, W, 3) u8 to ``path``, the format from the extension:
    ``.bmp`` and ``.png`` are encoded here, others need Pillow."""
    ext = os.path.splitext(path)[1].lower()
    if ext in NATIVE_FORMATS:
        data = encode_bmp(rgb_u8) if ext == ".bmp" else encode_png(rgb_u8)
        with open(path, "wb") as fh:
            fh.write(data)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"saving {path!r} needs Pillow; without it .bmp and .png (save_image) "
            "and .hdr (save_hdr) are written"
        ) from e
    Image.fromarray(np.ascontiguousarray(rgb_u8)).save(path)


def save_hdr(path: str, rgb: np.ndarray) -> None:
    """Save (H, W, 3) float32 linear radiance as Radiance RGBE (.hdr):
    the three channels scaled by a shared power-of-2 exponent (Ward's
    format); zero pixels encode as all-zero bytes, and the exponent byte
    saturates at 255."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    rgb = np.where(np.isfinite(rgb), np.maximum(rgb, 0.0), 0.0)
    brightest = rgb.max(axis=-1)
    # frexp: brightest = mant * 2**exp with mant in [0.5, 1)
    mant, exp = np.frexp(brightest)
    scale = np.where(brightest > 1e-32, mant * 256.0 / np.maximum(brightest, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(brightest > 1e-32, np.minimum(exp + 128, 255), 0).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode())
        fh.write(rgbe.tobytes())  # flat (uncompressed) scanlines


def load_hdr(path: str) -> np.ndarray:
    """Read a flat Radiance RGBE file written by :func:`save_hdr` back to
    (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"#?RADIANCE"):
        raise ValueError(f"{path!r} is not a Radiance file")
    _, _, rest = data.partition(b"\n\n")
    dims, _, pix = rest.partition(b"\n")
    tok = dims.split()
    h, w = int(tok[1]), int(tok[3])
    rgbe = np.frombuffer(pix, np.uint8, count=h * w * 4).reshape(h, w, 4)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 128 - 8), 0.0)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
