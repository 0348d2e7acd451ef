"""Writers of image files that PIL does not write, for the image decoder
tests and ``scripts/make_io_fixtures_torch.py``: PNG of any colour type,
bit depth and interlace (Adam7 included, rows filtered with all five
filter types in turn), and baseline colour JPEG with any integral sampling
factors (4:1:1, 4:4:0).  numpy only."""
from __future__ import annotations

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_row(row: np.ndarray, depth: int) -> bytes:
    """[W, C] samples -> the scanline's bytes (MSB first below 8 bits)."""
    flat = row.reshape(-1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    bits = ((flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits).tobytes()


def _filter_rows(rows, bpp: int) -> bytes:
    """Filter each scanline with type y % 5 (None, Sub, Up, Average, Paeth)."""
    out, prev = bytearray(), bytes(len(rows[0])) if rows else b""
    for y, raw in enumerate(rows):
        kind = y % 5
        line = bytearray(len(raw))
        for x, v in enumerate(raw):
            a = raw[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            line[x] = (v - pred) & 0xFF
        out += bytes([kind]) + line
        prev = raw
    return bytes(out)


def png_bytes(samples: np.ndarray, color: int, depth: int, interlace: bool = False,
              palette: np.ndarray | None = None) -> bytes:
    """samples [H, W] or [H, W, C] (values below 2**depth) -> a PNG file."""
    arr = np.asarray(samples)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    assert c == _CHANNELS[color]
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = arr[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        data += _filter_rows([_pack_row(r, depth) for r in sub], bpp)
    blob = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))))
    if palette is not None:
        blob += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return blob + _chunk(b"IDAT", zlib.compress(data, 9)) + _chunk(b"IEND", b"")


# ---- baseline colour JPEG with any integral sampling factors ----

_LUM_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                   14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                   18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")


def _zigzag() -> list:
    order = []
    for s in range(15):
        ys = range(min(s, 7), max(0, s - 7) - 1, -1) if s % 2 == 0 else range(max(0, s - 7),
                                                                              min(s, 7) + 1)
        order += [y * 8 + (s - y) for y in ys]
    return order


def _codes(bits, vals):
    table, code, k = {}, 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def jpeg_color_bytes(rgb: np.ndarray, factors, quality: int = 75) -> bytes:
    """[H, W, 3] uint8 RGB -> a baseline JFIF JPEG whose components have the
    sampling factors ``factors`` ((h, v) per component; box-averaged
    chroma, float DCT)."""
    h_img, w_img, _ = rgb.shape
    x = rgb.astype(np.float64)
    ycc = np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                    128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
                    128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]], -1)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = np.clip((_LUM_Q * scale + 50) // 100, 1, 255)
    n = np.arange(8)
    basis = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * np.where(
        n[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    zz = _zigzag()
    planes = []
    for ci, (fh, fv) in enumerate(factors):
        sx, sy = hmax // fh, vmax // fv
        pw, ph = mcux * 8 * hmax, mcuy * 8 * vmax
        full = np.pad(ycc[..., ci], ((0, ph - h_img), (0, pw - w_img)), mode="edge")
        planes.append(full.reshape(ph // sy, sy, pw // sx, sx).mean(axis=(1, 3)))
    dc, ac = _codes(_DC_BITS, _DC_VALS), _codes(_AC_BITS, list(_AC_VALS))
    bits, last = [], [0, 0, 0]

    def put(code, length):
        bits.append(format(code, f"0{length}b") if length else "")

    def value_bits(v):
        size = abs(v).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (fh, fv) in enumerate(factors):
                for by in range(fv):
                    for bx in range(fh):
                        y0, x0 = (my * fv + by) * 8, (mx * fh + bx) * 8
                        blk = planes[ci][y0:y0 + 8, x0:x0 + 8] - 128
                        coef = np.round(basis @ blk @ basis.T / q.reshape(8, 8)).astype(int)
                        seq = coef.reshape(-1)[zz]
                        size, v = value_bits(int(seq[0]) - last[ci])
                        last[ci] = int(seq[0])
                        put(*dc[size])
                        put(v, size)
                        run = 0
                        for c in seq[1:]:
                            if c == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            size, v = value_bits(int(c))
                            put(*ac[(run << 4) | size])
                            put(v, size)
                            run = 0
                        if run:
                            put(*ac[0])
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    data = bytearray()
    for i in range(0, len(stream), 8):
        b = int(stream[i:i + 8], 2)
        data.append(b)
        if b == 0xFF:
            data.append(0)

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    comps = b"".join(bytes([i + 1, (fh << 4) | fv, 0]) for i, (fh, fv) in enumerate(factors))
    return (b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + seg(0xDB, b"\x00" + bytes(int(v) for v in q[zz]))
            + seg(0xC0, struct.pack(">BHHB", 8, h_img, w_img, 3) + comps)
            + seg(0xC4, b"\x00" + bytes(_DC_BITS) + bytes(_DC_VALS))
            + seg(0xC4, b"\x10" + bytes(_AC_BITS) + _AC_VALS)
            + seg(0xDA, b"\x03" + b"".join(bytes([i + 1, 0x00]) for i in range(3))
                  + b"\x00\x3f\x00")
            + bytes(data) + b"\xff\xd9")
