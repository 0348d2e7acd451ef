"""The plain Python/numpy twin of ``csrc/image_ccitt.cpp`` (CCITT RLE,
Group 3 and Group 4 inside TIFF), the later raster readers (TGA, SGI, PCX,
DDS, PSD, ICO / CUR, QOI, IM, SPIDER, Sun raster, MSP, XBM, XPM, WebP:
``csrc/image_*.cpp``), libtiff's YCbCr -> RGB and orientation as
``csrc/image_tiff.cpp`` applies them, and the identification of ``decode_any`` (``csrc/image_extra.cpp``): PIL's
plugins in ``Image.ID`` order.  ``images_plain.decode`` uses these; the
tests hold the library to them.
"""
from __future__ import annotations

import re

import numpy as np

from .images import UNKNOWN, Decoded

MAX_PIXELS = 178956970   # PIL raises DecompressionBombError above twice MAX_IMAGE_PIXELS


# ---- identification -------------------------------------------------------------

# what the port reads of the formats PIL identifies
_READ = ("JPEG", "PNG", "BMP", "CUR", "PCX", "DDS", "ICO", "IM", "TIFF", "GIF", "JPEG 2000",
         "MSP", "PPM", "PSD", "QOI", "SGI", "SPIDER", "SUN", "TGA", "WebP", "XBM", "XPM")

def identify(blob: bytes) -> str:
    """The format PIL's Image.open gives ``blob``, for the formats the port
    reads (``_READ``); ValueError
    naming the format for a file a plugin of PIL's the port does not read
    claims, and ``UNKNOWN`` for the rest."""
    n, le32 = len(blob), (lambda at: int.from_bytes(blob[at:at + 4], "little")
                          if len(blob) >= at + 4 else -1)
    le16 = lambda at: int.from_bytes(blob[at:at + 2], "little")   # noqa: E731
    be32 = lambda at: int.from_bytes(blob[at:at + 4], "big")      # noqa: E731
    checks = [
        ("AVIF", n >= 12 and blob[4:8] == b"ftyp" and blob[8:12] in (b"avif", b"avis", b"mif1",
                                                                        b"msf1")),
        ("BLP", blob[:4] in (b"BLP1", b"BLP2")),
        ("BMP", blob[:2] == b"BM"),
        ("DIB", le32(0) in (12, 40, 52, 56, 64, 108, 124)),
        ("BUFR", blob[:4] in (b"BUFR", b"ZCZC")),
        ("CUR", blob[:4] == b"\0\0\2\0" and n >= 6 and le16(4) > 0),
        ("PCX", n >= 12 and blob[0] == 10 and blob[1] in (0, 2, 3, 5)
         and le16(8) + 1 > le16(4) and le16(10) + 1 > le16(6)),
        ("DCX", le32(0) == 987654321),
        ("DDS", blob[:4] == b"DDS "),
        ("EPS", blob[:4] == b"%!PS" or le32(0) == 0xC6D3D0C5),
        ("FITS", blob[:6] == b"SIMPLE"),
        ("FLI", n >= 16 and le16(4) in (0xAF11, 0xAF12) and le16(14) in (0, 3)),
        ("FTEX", blob[:4] == b"FTEX"),
        ("GBR", n >= 8 and be32(0) >= 20 and be32(4) in (1, 2)),
        ("GIF", blob[:6] in (b"GIF87a", b"GIF89a")),
        ("GRIB", n >= 8 and blob[:4] == b"GRIB" and blob[7] == 1),
        ("HDF5", blob[:8] == b"\x89HDF\r\n\x1a\n"),
        ("PNG", blob[:8] == b"\x89PNG\r\n\x1a\n"),
        ("JPEG 2000", blob[:4] == b"\xff\x4f\xff\x51"
         or blob[:12] == b"\0\0\0\x0cjP  \r\n\x87\n"),
        ("ICNS", blob[:4] == b"icns"),
        ("ICO", blob[:4] == b"\0\0\1\0" and n >= 6 and le16(4) > 0),
        ("IM", _im_header(blob) is not None),       # PIL's header test, no magic
        ("JPEG", blob[:3] == b"\xff\xd8\xff"),
        ("McIdas", blob[:8] == b"\0\0\0\0\0\0\0\4"),
        ("MPEG", blob[:4] == b"\0\0\1\xb3"),
        ("TIFF", blob[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")),
        ("MSP", blob[:4] in (b"DanM", b"LinS")),
        ("PIXAR", blob[:4] == b"\x80\xe8\0\0"),
        ("PPM", n >= 2 and blob[0] == ord("P") and blob[1] in b"0123456fy"),
        ("PSD", blob[:4] == b"8BPS"),
        ("QOI", blob[:4] == b"qoif"),
        ("SGI", n >= 2 and int.from_bytes(blob[:2], "big") == 474),
        ("SPIDER", _spider_floats(blob) is not None),   # PIL's header test, no magic
        ("SUN", n >= 4 and be32(0) == 0x59A66A95),
        ("TGA", tga_header_valid(blob)),
        ("WebP", n >= 16 and blob[:4] == b"RIFF" and blob[8:12] == b"WEBP"
         and blob[12:16] in (b"VP8 ", b"VP8L", b"VP8X")),
        ("WMF", blob[:6] == b"\xd7\xcd\xc6\x9a\0\0" or blob[:4] == b"\1\0\0\0"),
        ("XBM", blob.lstrip(b" \t\n\r\v\f")[:7] == b"#define"),
        ("XPM", blob[:9] == b"/* XPM */"),
        ("XV thumbnail", blob[:6] == b"P7 332"),
    ]
    for name, claimed in checks:
        if claimed:
            if name not in _READ:
                raise ValueError(f"{name} files are not supported")
            return name
    raise ValueError(UNKNOWN)


# ---- TIFF helpers ------------------------------------------------------------------

def orient(img: Decoded, orientation: int) -> Decoded:
    """PIL's exif_transpose for TIFF orientation 2-8."""
    s = img.samples
    out = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, 3),
           7: lambda a: np.rot90(a, 2).transpose(1, 0, 2), 8: np.rot90}.get(orientation)
    if out is None:
        return img
    return Decoded(np.ascontiguousarray(out(s)), img.mode, img.palette)


class YCbCrToRGB:
    """tif_color.c TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB in libtiff's float32
    and fixed-point arithmetic, and TIFFRGBAImage's data units."""

    def __init__(self, luma, rbw):
        f = np.float32
        luma = list(luma[:3]) if len(luma) >= 3 else [f(0.299), f(0.587), f(0.114)]
        rbw = list(rbw[:6]) if len(rbw) >= 6 else [f(0), f(255), f(128), f(255), f(128), f(255)]

        def fix(x):
            return int(float(f(x) * f(65536)) + 0.5)

        def clamp2(x):
            return f(0) if x < 0 else (f(2) if x > 2 else x)

        def code2v(c, rb, rw, cr):
            den = (rw - rb) if (rw - rb) != 0 else f(1)
            return (f(c - int(rb)) * f(cr)) / den

        def clampw(v):
            return int(f(-4096) if v < -4096 else (f(4096) if v > 4096 else v))

        lr, lg, lb = (f(v) for v in luma)
        f1 = f(2) - f(2) * lr
        d1 = fix(clamp2(f1))
        d2 = -fix(clamp2(lr * f1 / lg))
        f3 = f(2) - f(2) * lb
        d3 = fix(clamp2(f3))
        d4 = -fix(clamp2(lb * f3 / lg))
        rbw = [f(v) for v in rbw]
        x = range(-128, 128)
        cr = np.array([clampw(code2v(v, rbw[4] - f(128), rbw[5] - f(128), 127)) for v in x],
                      np.int64)
        cb = np.array([clampw(code2v(v, rbw[2] - f(128), rbw[3] - f(128), 127)) for v in x],
                      np.int64)
        self.cr_r, self.cb_b = (d1 * cr + (1 << 15)) >> 16, (d3 * cb + (1 << 15)) >> 16
        self.cr_g, self.cb_g = d2 * cr, d4 * cb + (1 << 15)
        self.y = np.array([clampw(code2v(v + 128, rbw[0], rbw[1], 255)) for v in x], np.int64)

    def units_to_rgb(self, data: bytes, cw: int, rows: int, hs: int, vs: int) -> np.ndarray:
        """A strip or tile of YCbCr data units (per hs x vs block its luma,
        then Cb and Cr) -> RGB uint8 [rows, cw * 3], chroma over each block."""
        ux, uy = -(-cw // hs), -(-rows // vs)
        u = np.frombuffer(data, np.uint8, ux * uy * (hs * vs + 2)).reshape(uy, ux, -1)
        yy = u[:, :, :hs * vs].reshape(uy, ux, vs, hs).transpose(0, 2, 1, 3)
        yy = yy.reshape(uy * vs, ux * hs)[:rows, :cw].astype(np.int64)
        rep = lambda c: np.repeat(np.repeat(c, vs, 0), hs, 1)[:rows, :cw]   # noqa: E731
        cb, cr = rep(u[:, :, hs * vs].astype(np.int64)), rep(u[:, :, hs * vs + 1].astype(np.int64))
        i = self.y[yy]
        rgb = np.stack([i + self.cr_r[cr], i + ((self.cb_g[cb] + self.cr_g[cr]) >> 16),
                        i + self.cb_b[cb]], -1)
        return np.clip(rgb, 0, 255).astype(np.uint8).reshape(rows, cw * 3)


# ---- CCITT -----------------------------------------------------------------------

_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100 "
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111 "
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXTENDED = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
             "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
             "000000011111").split()
_EOL = -2


def _run_table(codes) -> dict:
    table = {}
    for i, code in enumerate(codes):
        table[code] = i if i < 64 else (i - 63) * 64
    for i, code in enumerate(_EXTENDED):
        table[code] = 1792 + 64 * i
    table["000000000001"] = _EOL
    return table


_WHITE_RUNS, _BLACK_RUNS = _run_table(_WHITE), _run_table(_BLACK)


class _FaxBits:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def bit(self) -> int:
        if self.pos >= len(self.bits):
            raise ValueError("TIFF: CCITT data ends early")
        self.pos += 1
        return self.bits[self.pos - 1]

    def run(self, table) -> int:
        code = ""
        for _ in range(13):
            code += "1" if self.bit() else "0"
            if code in table:
                return table[code]
        raise ValueError("TIFF: bad CCITT run code")

    def full_run(self, table) -> int:
        total = 0
        while True:
            v = self.run(table)
            if v == _EOL:
                raise ValueError("TIFF: unexpected CCITT EOL")
            total += v
            if v < 64:
                return total

    def sync_eol(self):   # tif_fax3.h SYNC_EOL: skip to past the next EOL
        while True:
            if self.pos + 11 > len(self.bits):
                raise ValueError("TIFF: CCITT data ends early")
            if not any(self.bits[self.pos:self.pos + 11]):
                break
            self.pos += 1
        while self.bit() == 0:
            pass


def _row_1d(br: _FaxBits, width: int) -> list:
    changes, a0, white = [], 0, True
    while a0 < width:
        a0 += br.full_run(_WHITE_RUNS if white else _BLACK_RUNS)
        changes.append(min(a0, width))
        white = not white
    return changes


def _row_2d(br: _FaxBits, width: int, ref: list) -> list:
    changes, a0, white, ri = [], -1, True, 0
    while a0 < width:
        i = ri
        while i < len(ref) and (ref[i] <= a0 or (i & 1) != (0 if white else 1)):
            i += 1
        ri = max(i - 1, 0)
        b1 = ref[i] if i < len(ref) else width
        b2 = ref[i + 1] if i + 1 < len(ref) else width
        if br.bit():
            mode = 5                                   # V0
        elif br.bit():
            mode = 6 if br.bit() else 4                # VR1 / VL1
        elif br.bit():
            mode = 1                                   # horizontal
        elif br.bit():
            mode = 0                                   # pass
        elif br.bit():
            mode = 7 if br.bit() else 3                # VR2 / VL2
        elif br.bit():
            mode = 8 if br.bit() else 2                # VR3 / VL3
        else:
            raise ValueError("TIFF: CCITT 2-D extension (uncompressed mode) is not supported")
        if mode == 0:
            a0 = b2
        elif mode == 1:
            start = max(a0, 0)
            r1 = br.full_run(_WHITE_RUNS if white else _BLACK_RUNS)
            r2 = br.full_run(_BLACK_RUNS if white else _WHITE_RUNS)
            a1 = min(start + r1, width)
            a2 = min(a1 + r2, width)
            changes += [a1, a2]
            a0 = a2
        else:
            a1 = b1 + mode - 5
            if a1 < 0 or a1 > width or a1 < a0:
                raise ValueError("TIFF: bad CCITT vertical code")
            changes.append(a1)
            a0 = a1
            white = not white
    return changes


def decode_ccitt(data: bytes, width: int, rows: int, compression: int, t4: int) -> np.ndarray:
    """One strip or tile of CCITT RLE (2), Group 3 (3) or Group 4 (4) data
    -> uint8 [rows, width], 1 in black runs."""
    if compression == 3 and t4 & 2:
        raise ValueError("TIFF: CCITT uncompressed mode is not supported")
    br = _FaxBits(data)
    out = np.zeros((rows, width), np.uint8)
    ref = [width, width]
    for r in range(rows):
        if compression == 2:
            cur = _row_1d(br, width)
            br.pos = (br.pos + 7) & ~7
        elif compression == 3:
            br.sync_eol()
            one_d = br.bit() == 1 if t4 & 1 else True
            cur = _row_1d(br, width) if one_d else _row_2d(br, width, ref)
        else:
            cur = _row_2d(br, width, ref)
        x, colour = 0, 0
        for c in cur:
            c = min(c, width)
            if c > x:
                out[r, x:c] = colour
                x = c
            colour ^= 1
        ref = cur + [width, width]
    return out


# ---- TGA -------------------------------------------------------------------------

def tga_header_valid(blob: bytes) -> bool:
    """Whether PIL's TgaImageFile._open gets past the header."""
    if len(blob) < 18:
        return False
    w, h = int.from_bytes(blob[12:14], "little"), int.from_bytes(blob[14:16], "little")
    return (blob[1] in (0, 1) and w > 0 and h > 0 and blob[16] in (1, 8, 16, 24, 32)
            and blob[2] in (1, 2, 3, 9, 10, 11) and (not blob[1] or blob[7] in (16, 24, 32)))


def _five(v):
    return ((v & 31) * 255 // 31).astype(np.uint8)


def decode_tga(blob: bytes) -> Decoded:
    """TGA as PIL's TgaImagePlugin reads it (see ``csrc/image_tga.cpp``)."""
    if not tga_header_valid(blob):
        raise ValueError("not a TGA file")
    id_len, cmap_type, image_type = blob[0], blob[1], blob[2]
    map_start, map_size = (int.from_bytes(blob[i:i + 2], "little") for i in (3, 5))
    map_depth, depth, flags = blob[7], blob[16], blob[17]
    w, h = int.from_bytes(blob[12:14], "little"), int.from_bytes(blob[14:16], "little")
    if w * h > MAX_PIXELS:
        raise ValueError("TGA: bad image size")
    kind = image_type & 7
    if kind == 3:
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif kind == 1:
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    pos = 18 + id_len
    palette = None
    if cmap_type:
        size = 2 if map_depth == 16 else map_depth // 8
        entries = min(map_size, max(len(blob) - pos, 0) // size)
        raw = np.frombuffer(blob, np.uint8, entries * size, pos).reshape(entries, size)
        if size == 2:
            v = raw[:, 0].astype(np.int64) | (raw[:, 1].astype(np.int64) << 8)
            rgb = np.stack([_five(v >> 10), _five(v >> 5), _five(v)], -1)
        else:
            rgb = raw[:, 2::-1]
        palette = np.concatenate([np.zeros((map_start, 3), np.uint8), rgb])[:256]
        pos += map_size * size
    if (kind, depth) in ((1, 8), (3, 8)):
        bits = 8
    elif (kind, depth) in ((3, 1), (3, 16), (2, 16), (2, 24), (2, 32)):
        bits = depth
    else:
        raise ValueError(f"TGA: image type {image_type} at {depth} bits is not supported "
                         "(PIL cannot load it)")
    if kind == 1 and not cmap_type:
        raise ValueError("TGA: a colour-mapped image without a colour map is not supported "
                         "(PIL cannot load it)")
    if cmap_type and map_depth == 32 and mode == "P":
        raise ValueError("TGA: 32-bit colour maps are not supported (PIL cannot load them)")
    rowbytes = (w * bits + 7) // 8
    if image_type & 8:   # TgaRleDecode.c
        pixel = depth // 8
        if pixel == 0:
            raise ValueError("TGA: run-length encoding at 1 bit is not supported (PIL reads "
                             "none)")
        out, total = bytearray(), rowbytes * h
        while len(out) < total:
            x = len(out) % rowbytes
            if pos >= len(blob):
                raise ValueError("TGA: truncated run-length data")
            head = blob[pos]
            n = pixel * ((head & 0x7F) + 1)
            if head & 0x80:
                if pos + 1 + pixel > len(blob):
                    raise ValueError("TGA: truncated run-length data")
                if x + n > rowbytes:
                    raise ValueError("TGA: a run crosses the end of a row")
                out += blob[pos + 1:pos + 1 + pixel] * (n // pixel)
                pos += 1 + pixel
            else:
                if pos + 1 + n > len(blob):
                    raise ValueError("TGA: truncated run-length data")
                out += blob[pos + 1:pos + 1 + n]
                pos += 1 + n
        data = bytes(out[:total])
    else:
        data = blob[pos:pos + rowbytes * h]
        if len(data) < rowbytes * h:
            raise ValueError("TGA: truncated image data")
    rows = np.frombuffer(data, np.uint8).reshape(h, rowbytes)
    if not flags & 0x20:
        rows = rows[::-1]
    if bits == 1:
        px = np.unpackbits(rows, axis=1)[:, :w, None]
    elif bits == 8:
        px = rows[:, :w, None]
    elif kind == 3:
        px = rows.reshape(h, w, 2)
    elif bits == 16:
        v = rows.reshape(h, w, 2).astype(np.int64)
        v = v[:, :, 0] | (v[:, :, 1] << 8)
        alpha = np.where(v & 0x8000, 0, 255).astype(np.uint8)
        px = np.stack([_five(v >> 10), _five(v >> 5), _five(v), alpha], -1)
    else:
        px = rows.reshape(h, w, bits // 8)
        px = np.concatenate([px[:, :, 2::-1], px[:, :, 3:]], -1)
    if flags & 0x10:
        px = px[:, ::-1]
    return Decoded(np.ascontiguousarray(px, np.uint8), mode, palette if mode == "P" else None)


# ---- SGI and PCX -------------------------------------------------------------------

def decode_sgi(blob: bytes) -> Decoded:
    """SGI as PIL's SgiImagePlugin reads it (see ``csrc/image_sgi_pcx.cpp``)."""
    if len(blob) < 512 or int.from_bytes(blob[:2], "big") != 474:
        raise ValueError("not an SGI file")
    rle, bpc = blob[2], blob[3]
    dimension, w, h, z = (int.from_bytes(blob[i:i + 2], "big") for i in (4, 6, 8, 10))
    modes = {(1, 1): "L", (2, 1): "L", (3, 3): "RGB", (3, 4): "RGBA"}
    if bpc not in (1, 2) or (dimension, z) not in modes:
        raise ValueError("SGI: unsupported SGI image mode")
    if not w or not h:
        raise ValueError("SGI: bad image size")
    if rle not in (0, 1):
        raise ValueError("SGI: unknown compression")
    row_bytes = w * bpc
    out = np.zeros((z, h, w), np.uint8)       # channel, file row (bottom-up), high bytes
    if rle == 0:
        if 512 + row_bytes * h * z > len(blob):
            raise ValueError("SGI: truncated image data")
        out[:] = np.frombuffer(blob, np.uint8, row_bytes * h * z, 512).reshape(
            z, h, w, bpc)[..., 0]
    else:
        if 512 + h * z * 8 > len(blob):
            raise ValueError("SGI: truncated RLE tables")
        tabs = np.frombuffer(blob, ">u4", 2 * h * z, 512).reshape(2, z, h)
        for c in range(z):
            for r in range(h):
                start, length = int(tabs[0, c, r]), int(tabs[1, c, r])
                if start > len(blob) or start + length > len(blob):
                    raise ValueError("SGI: truncated RLE row")
                p, end, x, row = start, start + length, 0, bytearray(row_bytes)
                while True:                    # SgiRleDecode.c expandrow / expandrow2
                    if p + bpc > end:
                        raise ValueError("SGI: an RLE row ends early")
                    pixel = int.from_bytes(blob[p:p + bpc], "big")
                    p += bpc
                    count = pixel & 0x7F
                    if not count:
                        break
                    if x + count > w:
                        raise ValueError("SGI: an RLE run crosses the end of a row")
                    n = count * bpc
                    if pixel & 0x80:
                        if p + n > end:
                            raise ValueError("SGI: an RLE row ends early")
                        row[x * bpc:x * bpc + n] = blob[p:p + n]
                        p += n
                    else:
                        if p + bpc > end:
                            raise ValueError("SGI: an RLE row ends early")
                        row[x * bpc:x * bpc + n] = blob[p:p + bpc] * count
                        p += bpc
                    x += count
                out[c, r] = np.frombuffer(bytes(row), np.uint8).reshape(w, bpc)[:, 0]
    samples = out[:, ::-1].transpose(1, 2, 0)
    return Decoded(np.ascontiguousarray(samples), {1: "L", 3: "RGB", 4: "RGBA"}[z])


def decode_pcx(blob: bytes) -> Decoded:
    """PCX as PIL's PcxImagePlugin reads it (see ``csrc/image_sgi_pcx.cpp``)."""
    if len(blob) < 128 or blob[0] != 10:
        raise ValueError("not a PCX file")
    version, bits, planes = blob[1], blob[3], blob[65]
    x0, y0, x1, y1 = (int.from_bytes(blob[i:i + 2], "little") for i in (4, 6, 8, 10))
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError("PCX: bad image size")
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, palette = "P", np.frombuffer(blob[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = blob[-769:]
        if len(blob) >= 769 + 128 and tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if (pal != np.arange(256, dtype=np.uint8)[:, None]).any():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"PCX: unknown PCX mode (version {version}, {bits} bits, {planes} "
                         "planes)")
    stride = (w * bits + 7) // 8
    if int.from_bytes(blob[66:68], "little") != stride:
        stride += stride % 2
    line = stride * planes
    data, pos, total = bytearray(), 128, line * h
    while len(data) < total:                  # PcxDecode.c
        if pos >= len(blob):
            raise ValueError("PCX: truncated image data")
        byte = blob[pos]
        if byte & 0xC0 == 0xC0:
            if pos + 1 >= len(blob):
                raise ValueError("PCX: truncated image data")
            n = byte & 0x3F
            if len(data) % line + n > line:
                raise ValueError("PCX: a run crosses the end of a row")
            data += blob[pos + 1:pos + 2] * n
            pos += 2
        else:
            data.append(byte)
            pos += 1
    rows = np.frombuffer(bytes(data), np.uint8).reshape(h, line).copy()
    if bits == 1 and planes > 1:              # PcxDecode.c's band moves
        unpacked, bands = (w + 7) // 8, planes
    else:
        unpacked, bands = w, line // w
    band = line // bands if bands else 0
    if band > unpacked:
        for i in range(1, bands):
            rows[:, i * unpacked:(i + 1) * unpacked] = rows[:, i * band:i * band + unpacked].copy()
    if mode == "1":
        px = np.unpackbits(rows, axis=1)[:, :w]
    elif bits == 1:                           # P;2L / P;4L: one bit from each plane
        plane = (w + 7) // 8
        px = sum(np.unpackbits(rows[:, k * plane:(k + 1) * plane], axis=1)[:, :w].astype(np.uint8)
                 << k for k in range(planes))
    elif mode == "RGB":                       # RGB;L: a line each of R, G and B
        px = rows[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1)
    else:
        px = rows[:, :w]
    px = px.reshape(h, w, -1)
    return Decoded(np.ascontiguousarray(px, np.uint8), mode, palette)


# ---- DDS -----------------------------------------------------------------------

_DDS_FOURCC = {b"DXT1": (1, "RGBA"), b"DXT3": (2, "RGBA"), b"DXT5": (3, "RGBA"),
               b"BC4U": (4, "L"), b"ATI1": (4, "L"), b"BC5S": (-5, "RGB"), b"BC5U": (5, "RGB"),
               b"ATI2": (5, "RGB")}
_DXGI = {70: (1, "RGBA"), 71: (1, "RGBA"), 73: (2, "RGBA"), 74: (2, "RGBA"), 76: (3, "RGBA"),
         77: (3, "RGBA"), 79: (4, "L"), 80: (4, "L"), 82: (5, "RGB"), 83: (5, "RGB"),
         84: (-5, "RGB"), 95: (6, "RGB"), 96: (-6, "RGB"), 97: (7, "RGBA"), 98: (7, "RGBA"),
         99: (7, "RGBA"), 27: (0, "RGBA"), 28: (0, "RGBA"), 29: (0, "RGBA")}


def _bc1_colours(blocks: np.ndarray, four: bool) -> np.ndarray:
    """BcnDecode.c decode_bc1_color: [n, 8] blocks -> [n, 16, 4] RGBA."""
    c0 = blocks[:, 0].astype(np.int64) | (blocks[:, 1].astype(np.int64) << 8)
    c1 = blocks[:, 2].astype(np.int64) | (blocks[:, 3].astype(np.int64) << 8)

    def rgb565(x):
        r, g, b = (x & 0xF800) >> 8, (x & 0x7E0) >> 3, (x & 0x1F) << 3
        return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)

    p0, p1 = rgb565(c0), rgb565(c1)
    opaque = (c0 > c1)[:, None] | four
    p2 = np.where(opaque, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(opaque, (p0 + 2 * p1) // 3, 0)
    a3 = np.where(opaque[:, 0], 255, 0)
    full = np.full(len(blocks), 255)
    pal = np.stack([np.concatenate([p0, full[:, None]], 1), np.concatenate([p1, full[:, None]], 1),
                    np.concatenate([p2, full[:, None]], 1),
                    np.concatenate([p3, a3[:, None]], 1)], 1)           # [n, 4, 4]
    lut = blocks[:, 4:8].astype(np.int64)
    lut = lut[:, 0] | lut[:, 1] << 8 | lut[:, 2] << 16 | lut[:, 3] << 24
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[:, :, None], 1)


def _bc3_alpha(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """BcnDecode.c decode_bc3_alpha: [n, 8] -> [n, 16] values."""
    if signed:
        a0 = (blocks[:, 0].astype(np.int8).astype(np.int64) + 128) & 0xFFFF
        a1 = (blocks[:, 1].astype(np.int8).astype(np.int64) + 128) & 0xFFFF
    else:
        a0, a1 = blocks[:, 0].astype(np.int64), blocks[:, 1].astype(np.int64)
    big = (a0 > a1)[:, None]
    k = np.arange(1, 7)
    seven = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    five = ((5 - k[:4]) * a0[:, None] + k[:4] * a1[:, None]) // 5
    five = np.concatenate([five, np.zeros_like(a0)[:, None], np.full_like(a0, 255)[:, None]], 1)
    pal = np.concatenate([a0[:, None] & 0xFF, a1[:, None] & 0xFF,
                          np.where(big, seven, five)], 1) & 0xFF
    bits = blocks[:, 2:8].astype(np.int64)
    lut1 = bits[:, 0] | bits[:, 1] << 8 | bits[:, 2] << 16
    lut2 = bits[:, 3] | bits[:, 4] << 8 | bits[:, 5] << 16
    idx = np.concatenate([(lut1[:, None] >> (3 * np.arange(8))) & 7,
                          (lut2[:, None] >> (3 * np.arange(8))) & 7], 1)
    return np.take_along_axis(pal, idx, 1)


def _bcn(data: bytes, n: int, w: int, h: int) -> np.ndarray:
    """BcnDecode.c: blocks of 4 x 4 in rows -> [h, w, channels] uint8."""
    size = 8 if abs(n) in (1, 4) else 16
    if abs(n) in (6, 7):
        bw, bh = -(-w // 4), -(-h // 4)
        if len(data) < bw * bh * 16:
            raise ValueError("DDS: truncated image data")
        blocks = [data[16 * i:16 * i + 16] for i in range(bw * bh)]
        px = np.stack([_bc7_block(b) for b in blocks] if n == 7
                      else [_bc6_block(b, n < 0) for b in blocks])
        c = px.shape[-1]
        px = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, c)
        return px[:h, :w].astype(np.uint8)
    bw, bh = -(-w // 4), -(-h // 4)
    if len(data) < bw * bh * size:
        raise ValueError("DDS: truncated image data")
    blocks = np.frombuffer(data, np.uint8, bw * bh * size).reshape(-1, size)
    if n == 1:
        px = _bc1_colours(blocks, False)
    elif n == 2:
        px = _bc1_colours(blocks[:, 8:], True)
        nib = blocks[:, :8].astype(np.int64)
        a = np.stack([nib & 15, nib >> 4], -1).reshape(-1, 16)
        px[:, :, 3] = a | a << 4
    elif n == 3:
        px = _bc1_colours(blocks[:, 8:], True)
        px[:, :, 3] = _bc3_alpha(blocks[:, :8])
    elif n == 4:
        px = _bc3_alpha(blocks)[:, :, None]
    else:
        blue = np.full((len(blocks), 16), 128 if n < 0 else 0, np.int64)   # signed zero: 128
        px = np.stack([_bc3_alpha(blocks[:, :8], n < 0), _bc3_alpha(blocks[:, 8:], n < 0),
                       blue], -1)
    px = px.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, -1)
    return px[:h, :w].astype(np.uint8)


def decode_dds(blob: bytes) -> Decoded:
    """DDS as PIL's DdsImagePlugin reads it (see ``csrc/image_dds.cpp``)."""
    if blob[:4] != b"DDS ":
        raise ValueError("not a DDS file")
    if len(blob) < 128 or int.from_bytes(blob[4:8], "little") != 124:
        raise ValueError("DDS: unsupported or incomplete header")
    h, w = (int.from_bytes(blob[i:i + 4], "little") for i in (12, 16))
    if w * h > MAX_PIXELS or w > MAX_PIXELS or h > MAX_PIXELS:
        raise ValueError("DDS: bad image size")
    pfflags, fourcc = int.from_bytes(blob[80:84], "little"), blob[84:88]
    bitcount = int.from_bytes(blob[88:92], "little")
    pos, palette = 128, None
    if pfflags & 0x40:                          # RGB(A) with bit masks: DdsRgbDecoder
        mode = "RGBA" if pfflags & 0x1 else "RGB"
        masks = [int.from_bytes(blob[92 + 4 * i:96 + 4 * i], "little") for i in range(len(mode))]
        shifts = [(m & -m).bit_length() - 1 if m else 0 for m in masks]
        totals = [m >> s for m, s in zip(masks, shifts)]
        nbytes = bitcount // 8
        out = np.zeros((h * w, len(mode)), np.uint8)
        for i in range(h * w):
            chunk = blob[pos + i * nbytes:pos + (i + 1) * nbytes] if nbytes else b""
            value = int.from_bytes(chunk, "little")
            for c, (m, s, t) in enumerate(zip(masks, shifts, totals)):
                out[i, c] = int((((value & m) >> s) / t) * 255) if t else 0
        return Decoded(out.reshape(h, w, -1), mode)
    if pfflags & 0x20000:
        if bitcount == 8:
            mode, n = "L", 0
        elif bitcount == 16 and pfflags & 0x1:
            mode, n = "LA", 0
        else:
            raise ValueError(f"DDS: unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & 0x20:
        mode, n = "P", 0
        pal = np.frombuffer(blob[pos:pos + 1024], np.uint8)
        palette = pal[:len(pal) // 4 * 4].reshape(-1, 4)[:, :3].copy()
        pos += 1024
    elif pfflags & 0x4:
        if fourcc == b"DX10":
            dxgi = int.from_bytes(blob[128:132], "little")
            pos += 20
            if dxgi not in _DXGI:
                raise ValueError(f"DDS: DXGI format {dxgi} is not supported")
            n, mode = _DXGI[dxgi]
        elif fourcc in _DDS_FOURCC:
            n, mode = _DDS_FOURCC[fourcc]
        else:
            raise ValueError(f"DDS: pixel format {fourcc!r} is not supported")
    else:
        raise ValueError(f"DDS: unknown pixel format flags {pfflags}")
    if n:
        return Decoded(np.ascontiguousarray(_bcn(blob[pos:], n, w, h)), mode)
    channels = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[mode]
    data = blob[pos:pos + w * h * channels]
    if len(data) < w * h * channels:
        raise ValueError("DDS: truncated image data")
    return Decoded(np.frombuffer(data, np.uint8).reshape(h, w, channels).copy(), mode, palette)


# ---- PSD -----------------------------------------------------------------------

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}


def decode_psd(blob: bytes) -> Decoded:
    """PSD's composite image as PIL's PsdImagePlugin reads it (see
    ``csrc/image_psd.cpp``)."""
    be16 = lambda at: int.from_bytes(blob[at:at + 2], "big")   # noqa: E731
    be32 = lambda at: int.from_bytes(blob[at:at + 4], "big")   # noqa: E731
    if len(blob) < 26 or blob[:4] != b"8BPS" or be16(4) != 1:
        raise ValueError("not a PSD file")
    channels_in, h, w, bits, psd_mode = be16(12), be32(14), be32(18), be16(22), be16(24)
    if (psd_mode, bits) not in _PSD_MODES:
        raise ValueError(f"PSD: colour mode {psd_mode} at {bits} bits is not supported")
    mode, channels = _PSD_MODES[psd_mode, bits]
    if channels > channels_in:
        raise ValueError("PSD: not enough channels")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    if w > MAX_PIXELS or h > MAX_PIXELS or w * h > MAX_PIXELS:
        raise ValueError("PSD: bad image size")
    pos, palette = 26, None
    size = be32(pos)
    if mode == "P" and size == 768:
        palette = np.frombuffer(blob[pos + 4:pos + 4 + 768], np.uint8).reshape(3, 256).T.copy()
    pos += 4 + size
    for _ in range(2):                             # image resources, layers
        pos += 4 + be32(pos)
    if pos + 2 > len(blob):
        raise ValueError("PSD: truncated file")
    compression, pos = be16(pos), pos + 2
    rowbytes = (w + 7) // 8 if mode == "1" else w
    planes = []
    if compression == 0:
        for c in range(channels):
            at = pos + c * w * h
            data = blob[at:at + rowbytes * h]
            if len(data) < rowbytes * h:
                raise ValueError("PSD: truncated image data")
            planes.append(np.frombuffer(data, np.uint8).reshape(h, rowbytes))
    elif compression == 1:
        counts = np.frombuffer(blob, ">u2", channels * h, pos).astype(np.int64) \
            if pos + 2 * channels * h <= len(blob) else None
        if counts is None:
            raise ValueError("PSD: truncated file")
        at = pos + 2 * channels * h
        for c in range(channels):
            planes.append(_packbits_rows(blob, at, rowbytes, h))
            at += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise ValueError(f"PSD: compression {compression} is not supported")
    if mode == "1":
        px = np.unpackbits(planes[0], axis=1)[:, :w, None]
    else:
        px = np.stack(planes, -1)
        if mode == "CMYK":                          # "C;I" etc.: inverted
            px = 255 - px
        elif mode == "LAB":                         # the "A" / "B" band unpackers
            px[:, :, 1:] ^= 0x80
    return Decoded(np.ascontiguousarray(px, np.uint8), mode, palette)


def _packbits_rows(blob: bytes, at: int, rowbytes: int, rows: int) -> np.ndarray:
    """PackDecode.c from ``at`` until ``rows`` rows are full: a run or a
    literal that would pass a row's end is cut there."""
    out, row, pos = np.zeros((rows, rowbytes), np.uint8), bytearray(), at
    y = 0
    while y < rows:
        if pos >= len(blob):
            raise ValueError("PSD: truncated image data")
        c = blob[pos]
        if c == 0x80:
            pos += 1
            continue
        if c & 0x80:
            if pos + 1 >= len(blob):
                raise ValueError("PSD: truncated image data")
            row += blob[pos + 1:pos + 2] * min(257 - c, rowbytes - len(row))
            pos += 2
        else:
            if pos + c + 2 > len(blob):
                raise ValueError("PSD: truncated image data")
            row += blob[pos + 1:pos + 1 + min(c + 1, rowbytes - len(row))]
            pos += c + 2
        if len(row) >= rowbytes:
            out[y] = np.frombuffer(bytes(row), np.uint8)
            row, y = bytearray(), y + 1
    return out


# ---- ICO and CUR ------------------------------------------------------------------

def _ico_entries(blob: bytes) -> list:
    n = int.from_bytes(blob[4:6], "little")
    if len(blob) < 6 + 16 * n:
        raise ValueError("ICO: truncated directory")
    out = []
    for i in range(n):
        s = blob[6 + 16 * i:22 + 16 * i]
        bpp = int.from_bytes(s[6:8], "little")
        colours = int(np.ceil(np.log(float(s[2])) / np.log(2.0))) if s[2] else 0
        out.append(dict(w=s[0] or 256, h=s[1] or 256, bpp=bpp, depth=bpp or colours or 256,
                        size=int.from_bytes(s[8:12], "little"),
                        offset=int.from_bytes(s[12:16], "little")))
    return out


def _half_height_dib(blob: bytes, at: int):
    """The DIB at ``at`` with its height halved, read as PIL's BMP reader
    reads it -> (Decoded, where its pixels start)."""
    from .images_plain import _decode_bmp
    if at > len(blob) or len(blob) - at < 16:
        raise ValueError("ICO: truncated bitmap header")
    hsize = int.from_bytes(blob[at:at + 4], "little")
    if hsize < 12 or hsize > len(blob) - at:
        raise ValueError("ICO: truncated bitmap header")
    dib = bytearray(blob[at:])
    colours, padding, extra = 0, 3 if hsize == 12 else 4, 0
    if hsize == 12:
        bits = int.from_bytes(dib[10:12], "little")
        dib[6:8] = (int.from_bytes(dib[6:8], "little") // 2).to_bytes(2, "little")
    else:
        if hsize < 40:
            raise ValueError("ICO: bad bitmap header")
        bits = int.from_bytes(dib[14:16], "little")
        dib[8:12] = int(int.from_bytes(dib[8:12], "little", signed=True) / 2).to_bytes(
            4, "little", signed=True)
        colours = int.from_bytes(dib[32:36], "little")
        extra = 12 if int.from_bytes(dib[16:20], "little") == 3 and hsize == 40 else 0
    colours = (colours or 1 << bits) if bits <= 8 else 0
    offset = 14 + hsize + extra + padding * colours
    head = b"BM" + bytes(8) + offset.to_bytes(4, "little")
    return _decode_bmp(head + bytes(dib)), at + offset - 14


def decode_ico(blob: bytes) -> Decoded:
    """ICO as PIL's IcoImagePlugin reads it (see ``csrc/image_ico.cpp``)."""
    from .images_plain import _decode_png
    entries = _ico_entries(blob)
    if not entries:
        raise ValueError("ICO: no icons")
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["w"] * e["h"], reverse=True)
    e = entries[0]
    if blob[e["offset"]:e["offset"] + 8] == b"\x89PNG\r\n\x1a\n":
        return _decode_png(blob[e["offset"]:])
    img, data_at = _half_height_dib(blob, e["offset"])
    h, w = img.samples.shape[:2]
    if e["bpp"] == 32:
        if len(blob) - data_at < w * h * 4:
            raise ValueError("ICO: not enough alpha data")
        alpha = np.frombuffer(blob, np.uint8, w * h * 4, data_at)[3::4].reshape(h, w)[::-1]
    else:
        padded = -(-w // 32) * 32
        total = padded * h // 8
        at = e["offset"] + e["size"] - total
        if at < 0 or len(blob) - at < total:
            raise ValueError("ICO: not enough mask data")
        bits = np.unpackbits(np.frombuffer(blob, np.uint8, total, at).reshape(h, padded // 8),
                             axis=1)[:, :w]
        alpha = np.where(bits[::-1], 0, 255).astype(np.uint8)
    s = img.samples
    if img.mode == "RGB":
        rgb = s
    elif img.mode == "RGBA":
        rgb = s[:, :, :3]
    elif img.mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(img.palette)] = img.palette
        rgb = pal[s[:, :, 0]]
    else:
        g = s[:, :, 0] * (255 if img.mode == "1" else 1)
        rgb = np.stack([g, g, g], -1)
    return Decoded(np.ascontiguousarray(np.concatenate([rgb, alpha[:, :, None]], -1),
                                        np.uint8), "RGBA")


def decode_cur(blob: bytes) -> Decoded:
    """CUR as PIL's CurImagePlugin reads it: the first entry, replaced by
    each later one larger in both dimensions, its DIB at half height."""
    n = int.from_bytes(blob[4:6], "little")
    if not n or len(blob) < 6 + 16 * n:
        raise ValueError("CUR: no cursors")
    pick = 0
    for i in range(1, n):
        m, s = blob[6 + 16 * pick:], blob[6 + 16 * i:]
        if s[0] > m[0] and s[1] > m[1]:
            pick = i
    at = int.from_bytes(blob[6 + 16 * pick + 12:6 + 16 * pick + 16], "little")
    return _half_height_dib(blob, at)[0]


# ---- QOI -----------------------------------------------------------------------

def decode_qoi(blob: bytes) -> Decoded:
    """QOI as PIL's QoiImagePlugin decodes it (see ``csrc/image_qoi.cpp``)."""
    if len(blob) < 14 or blob[:4] != b"qoif":
        raise ValueError("not a QOI file")
    w, h = int.from_bytes(blob[4:8], "big"), int.from_bytes(blob[8:12], "big")
    if w > MAX_PIXELS or h > MAX_PIXELS or w * h > MAX_PIXELS:
        raise ValueError("QOI: bad image size")
    bands = 3 if blob[12] == 3 else 4
    total, out, pos = w * h, bytearray(), 14
    prev, seen = (0, 0, 0, 255), {}
    while len(out) < total * 4:
        if pos >= len(blob):
            raise ValueError("QOI: truncated image data")
        op = blob[pos]
        pos += 1
        if op in (0xFE, 0xFF):
            n = 3 if op == 0xFE else 4
            if pos + n > len(blob):
                raise ValueError("QOI: truncated image data")
            v = tuple(blob[pos:pos + n]) + (prev[3:] if n == 3 else ())
            pos += n
        elif op >> 6 == 0:
            v = seen.get(op & 63, (0, 0, 0, 0))
        elif op >> 6 == 1:
            v = ((prev[0] + ((op >> 4) & 3) - 2) % 256, (prev[1] + ((op >> 2) & 3) - 2) % 256,
                 (prev[2] + (op & 3) - 2) % 256, prev[3])
        elif op >> 6 == 2:
            if pos >= len(blob):
                raise ValueError("QOI: truncated image data")
            second, dg = blob[pos], (op & 63) - 32
            pos += 1
            v = ((prev[0] + dg + (second >> 4) - 8) % 256, (prev[1] + dg) % 256,
                 (prev[2] + dg + (second & 15) - 8) % 256, prev[3])
        else:                                   # a run of the previous pixel
            out += bytes(prev) * ((op & 63) + 1)
            continue
        prev = v
        seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64] = v
        out += bytes(v)
    px = np.frombuffer(bytes(out[:total * 4]), np.uint8).reshape(h, w, 4)[:, :, :bands]
    return Decoded(np.ascontiguousarray(px), "RGB" if bands == 3 else "RGBA")


# ---- IM ------------------------------------------------------------------------

_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type")


def _im_header(blob: bytes):
    """PIL's ImImageFile header loop -> ({key: value}, where the data
    starts), or None where PIL would not claim the file."""
    if b"\n" not in blob[:100]:
        return None
    kv, pos, known = {}, 0, 0
    while pos < len(blob):
        c = blob[pos]
        if c == 13:
            pos += 1
            continue
        if c in (0, 0x1A):
            break
        end = blob.find(b"\n", pos)
        end = len(blob) if end < 0 else end
        nxt = min(end + 1, len(blob))
        if nxt - pos > 100:
            return None
        line = blob[pos:end]
        if end < len(blob) and line.endswith(b"\r"):
            line = line[:-1]
        pos = nxt
        m = re.match(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$", line, re.S)
        if not m:
            return None
        key = m.group(1).decode("latin-1")
        kv[key] = m.group(2).decode("latin-1")
        known += key in _IM_TAGS
    if not known:
        return None
    end = blob.find(b"\x1a", pos)
    return None if end < 0 else (kv, end + 1)


_IM_TYPES = {"0 1 image": ("1", "1", 1), "L 1 image": ("1", "1", 1), "B1 image": ("1", "1", 1),
             "Greyscale image": ("L", "L", 1), "Grayscale image": ("L", "L", 1),
             "LA image": ("LA", "lines", 2), "RGB image": ("RGB", "lines", 3),
             "RGBA image": ("RGBA", "lines", 4), "RGBX image": ("RGB", "lines", 4),
             "CMYK image": ("CMYK", "lines", 4), "X 24 image": ("RGB", "RGB", 3),
             "L 16 image": ("I;16", "<u2", 1), "L*16 image": ("I;16", "<u2", 1),
             "L 16B image": ("I;16B", ">u2", 1), "L*16B image": ("I;16B", ">u2", 1),
             "L 32S image": ("I", "<i4", 1), "L*32S image": ("I", "<i4", 1),
             "L 32F image": ("F", "<f4", 1), "L*32F image": ("F", "<f4", 1)}


def decode_im(blob: bytes) -> Decoded:
    """IM as PIL's ImImagePlugin reads it (see ``csrc/image_im.cpp``)."""
    parsed = _im_header(blob)
    if parsed is None:
        raise ValueError("not an IM file")
    kv, pos = parsed
    w = h = 512
    if "Image size (x*y)" in kv:
        parts = kv["Image size (x*y)"].replace("*", ",").split(",")
        try:
            w, h = (int(p) for p in parts)
        except ValueError:
            raise ValueError("IM: bad image size") from None
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError("IM: bad image size")
    kind = kv.get("Image type", "Greyscale image")
    if kind not in _IM_TYPES:
        raise ValueError(f'IM: image type "{kind}" is not supported')
    mode, raw, bands = _IM_TYPES[kind]
    palette = None
    if "Lut" in kv:
        lut = np.frombuffer(blob[pos:pos + 768], np.uint8)
        if len(lut) < 768:
            raise ValueError("IM: truncated Lut")
        lut = lut.reshape(3, 256)
        grey = bool((lut[0] == lut[1]).all() and (lut[0] == lut[2]).all())
        if not grey and mode == "L":
            mode, palette = "P", np.ascontiguousarray(lut.T)
        elif not grey and mode == "LA":
            raise ValueError("IM: a colour Lut on LA (PIL's PA) is not supported")
        pos += 768
    row = {"1": (w + 7) // 8, "L": w, "lines": bands * w, "RGB": 3 * w}.get(raw, 4 * w)
    if raw in ("<u2", ">u2"):
        row = 2 * w
    data = blob[pos:pos + row * h]
    if len(data) < row * h:
        raise ValueError("IM: truncated image data")
    rows = np.frombuffer(data, np.uint8).reshape(h, row)[::-1]        # bottom-up
    if raw == "1":
        px = np.unpackbits(rows, axis=1)[:, :w, None]
    elif raw == "L":
        px = rows[:, :, None]
    elif raw == "lines":
        px = rows.reshape(h, bands, w).transpose(0, 2, 1)[:, :, :len(mode)]
    elif raw == "RGB":
        px = rows.reshape(h, w, 3)
    else:
        px = rows.copy().view(raw).astype(raw[1:] if raw[0] != ">" else "<u2")[:, :, None]
        if mode == "I":
            px = px.astype(np.int32)
        elif mode == "F":
            px = px.astype(np.float32)
        else:
            px = px.astype(np.uint16)
    return Decoded(np.ascontiguousarray(px), mode, palette)


# ---- SUN, MSP, XBM, XPM ----------------------------------------------------------

def decode_sun(blob: bytes) -> Decoded:
    """Sun raster as PIL's SunImagePlugin reads it (see ``csrc/image_misc.cpp``)."""
    if len(blob) < 32 or blob[:4] != b"\x59\xa6\x6a\x95":
        raise ValueError("not a SUN raster file")
    w, h, depth, _, kind, pal_type, pal_len = (int.from_bytes(blob[i:i + 4], "big")
                                               for i in range(4, 32, 4))
    if depth == 1:
        mode = "1"
    elif depth in (4, 8):
        mode = "L"
    elif depth in (24, 32):
        mode = "RGB"
    else:
        raise ValueError(f"SUN: unsupported depth {depth}")
    pos, palette = 32, None
    if pal_len:
        if pal_len > 1024:
            raise ValueError("SUN: unsupported colour map length")
        if pal_type != 1:
            raise ValueError("SUN: unsupported colour map type")
        if mode == "L":
            mode = "P"
            n = min(pal_len, len(blob) - 32) // 3
            palette = np.frombuffer(blob, np.uint8, 3 * n, 32).reshape(3, n).T.copy()
        pos += pal_len
    if kind > 5:
        raise ValueError(f"SUN: unsupported raster type {kind}")
    if not w or not h or w * h > MAX_PIXELS:
        raise ValueError("SUN: bad image size")
    rowbytes = (w * depth + 7) // 8
    stride = rowbytes if kind == 2 else (w * depth + 15) // 16 * 2
    total = stride * h
    if kind == 2:                                # SunRleDecode.c over unpadded rows
        out = bytearray()
        while len(out) < total:
            if pos >= len(blob):
                raise ValueError("SUN: truncated image data")
            if blob[pos] == 0x80:
                if pos + 1 >= len(blob):
                    raise ValueError("SUN: truncated image data")
                if blob[pos + 1] == 0:
                    out.append(0x80)
                    pos += 2
                else:
                    if pos + 2 >= len(blob):
                        raise ValueError("SUN: truncated image data")
                    out += bytes([blob[pos + 2]]) * min(blob[pos + 1] + 1, total - len(out))
                    pos += 3
            else:
                out.append(blob[pos])
                pos += 1
        data = bytes(out)
    else:
        data = blob[pos:pos + total]
        if len(data) < total:
            raise ValueError("SUN: truncated image data")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride)
    if depth == 1:
        px = 1 - np.unpackbits(rows, axis=1)[:, :w]      # "1;I"
    elif depth == 4:
        px = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        px = px if mode == "P" else px * 17
    elif depth == 8:
        px = rows[:, :w]
    else:
        px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)[:, :, :3]
        px = px if kind == 3 else px[:, :, ::-1]
    return Decoded(np.ascontiguousarray(px.reshape(h, w, -1), np.uint8), mode, palette)


def decode_msp(blob: bytes) -> Decoded:
    """MSP as PIL's MspImagePlugin reads it (see ``csrc/image_misc.cpp``)."""
    if len(blob) < 32 or blob[:4] not in (b"DanM", b"LinS"):
        raise ValueError("not an MSP file")
    if np.bitwise_xor.reduce(np.frombuffer(blob[:32], "<u2")):
        raise ValueError("MSP: bad checksum")
    w, h = int.from_bytes(blob[4:6], "little"), int.from_bytes(blob[6:8], "little")
    if not w or not h:
        raise ValueError("MSP: bad image size")
    rowbytes = (w + 7) // 8
    if blob[:4] == b"DanM":
        stream = blob[32:32 + rowbytes * h]
        if len(stream) < rowbytes * h:
            raise ValueError("MSP: truncated image data")
    else:                                        # MspDecoder
        if len(blob) < 32 + 2 * h:
            raise ValueError("MSP: truncated row map")
        lengths = np.frombuffer(blob, "<u2", h, 32)
        out, pos = bytearray(), 32 + 2 * h
        for r, n in enumerate(lengths.tolist()):
            if n == 0:
                out += b"\xff" * rowbytes
                continue
            row = blob[pos:pos + n]
            if len(row) != n:
                raise ValueError(f"MSP: truncated row {r}")
            i = 0
            while i < n:
                kind = row[i]
                i += 1
                if kind == 0:
                    if i + 2 > n:
                        raise ValueError(f"MSP: corrupted row {r}")
                    out += row[i + 1:i + 2] * row[i]
                    i += 2
                else:
                    out += row[i:i + kind]
                    i += kind
            pos += n
        stream = bytes(out)
        if len(stream) < rowbytes * h:
            raise ValueError("MSP: not enough image data")
    rows = np.frombuffer(stream, np.uint8, rowbytes * h).reshape(h, rowbytes)
    return Decoded(np.ascontiguousarray(np.unpackbits(rows, axis=1)[:, :w, None]), "1")


_XBM_HEAD = re.compile(rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
                       rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
                       rb"[\000-\377]*_bits\[]")


def decode_xbm(blob: bytes) -> Decoded:
    """XBM as PIL's XbmImagePlugin reads it (see ``csrc/image_misc.cpp``)."""
    m = _XBM_HEAD.match(blob[:512])
    if not m:
        raise ValueError("XBM: not a XBM file (PIL's header pattern)")
    w, h = int(m.group("width")), int(m.group("height"))
    if not w or not h or w * h > MAX_PIXELS:
        raise ValueError("XBM: bad image size")
    rowbytes, pos, out = (w + 7) // 8, m.end(), bytearray()
    hexval = {c: int(chr(c), 16) for c in b"0123456789abcdefABCDEF"}
    while len(out) < rowbytes * h:               # XbmDecode.c
        pos = blob.find(b"x", pos)
        if pos < 0 or pos + 3 > len(blob):
            raise ValueError("XBM: not enough image data")
        out.append((hexval.get(blob[pos + 1], 0) << 4) + hexval.get(blob[pos + 2], 0))
        pos += 3
    rows = np.frombuffer(bytes(out), np.uint8).reshape(h, rowbytes)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]   # "1;R"
    return Decoded(np.ascontiguousarray(bits[:, :, None]), "1")


def decode_xpm(blob: bytes) -> Decoded:
    """XPM as PIL's XpmImagePlugin reads it (see ``csrc/image_misc.cpp``)."""
    if blob[:9] != b"/* XPM */":
        raise ValueError("not an XPM file")
    lines = blob[9:].splitlines(keepends=True)
    i = 0
    while True:
        if i >= len(lines):
            raise ValueError("XPM: broken XPM file")
        m = re.match(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)', lines[i])
        i += 1
        if m:
            break
    if any(not g for g in m.groups()):
        raise ValueError("XPM: bad header")
    w, h, colours, bpp = (int(g) for g in m.groups())
    if w <= 0 or h <= 0 or bpp <= 0 or w * h > MAX_PIXELS:
        raise ValueError("XPM: bad image size")
    table = {}
    for _ in range(colours):
        line = lines[i].rstrip() if i < len(lines) else b""
        i += 1
        key, words = line[1:bpp + 1], line[bpp + 1:-2].split()
        for k in range(0, len(words), 2):
            if words[k] == b"c":
                if k + 1 >= len(words):
                    raise ValueError("XPM: cannot read this XPM file")
                rgb = words[k + 1]
                if rgb == b"None":
                    break
                if not rgb.startswith(b"#"):
                    raise ValueError("XPM: cannot read this XPM file")
                v = int(rgb[1:], 16)
                table[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                break
        else:
            raise ValueError("XPM: cannot read this XPM file")
    keys = list(table)
    mode = "RGB" if colours > 256 else "P"
    total, px, header = w * h, [], False
    for line in lines[i:]:
        if len(px) >= total:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        body = b'"'.join(line.split(b'"')[1:-1])
        for k in range(0, len(body), bpp):
            key = body[k:k + bpp]
            if key not in table:
                raise ValueError("XPM: a pixel names no colour")
            px.append(table[key] if mode == "RGB" else keys.index(key))
    if len(px) < total:
        raise ValueError("XPM: not enough image data")
    arr = np.array(px[:total], np.uint8).reshape(h, w, -1)
    palette = np.array([table[k] for k in keys], np.uint8).reshape(-1, 3) if mode == "P" else None
    return Decoded(arr, mode, palette)


# ---- SPIDER ----------------------------------------------------------------------

def _spider_length(t) -> int:
    """SpiderImagePlugin.isSpiderHeader -> the header length, or 0."""
    def whole(i):
        return bool(np.isfinite(t[i - 1]) and np.trunc(t[i - 1]) == t[i - 1]
                    and abs(t[i - 1]) <= 1e15)
    if not all(whole(i) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(t[4]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(t[12]), int(t[21]), int(t[22])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider_floats(blob: bytes):
    """(27 header floats, big-endian) of a file PIL's SpiderImageFile
    claims (a 2-D image), else None."""
    if len(blob) < 108:
        return None
    for order in (">", "<"):
        with np.errstate(invalid="ignore"):
            t = np.frombuffer(blob, order + "f4", 27).astype(np.float64)
        if _spider_length(t):
            return (t, order == ">") if int(t[4]) == 1 else None
    return None


def decode_spider(blob: bytes) -> Decoded:
    """SPIDER as PIL's SpiderImagePlugin reads it (see ``csrc/image_misc.cpp``)."""
    found = _spider_floats(blob)
    if found is None:
        raise ValueError("not a SPIDER file")
    t, big = found
    if not (np.isfinite(t[23]) and np.isfinite(t[26])):
        raise ValueError("SPIDER: bad stack header")
    hdrlen, istack, imgnumber = _spider_length(t), int(t[23]), int(t[26])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    else:
        raise ValueError("SPIDER: this stack header is not supported (PIL reads none)")
    w, h = t[11], t[1]
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS or offset < 0:
        raise ValueError("SPIDER: bad image size")
    w, h = int(w), int(h)
    if len(blob) - offset < 4 * w * h:
        raise ValueError("SPIDER: truncated image data")
    px = np.frombuffer(blob, (">" if big else "<") + "f4", w * h, offset).astype(np.float32)
    return Decoded(px.reshape(h, w, 1), "F")


# ---- BC7 (BcnDecode.c decode_bc7_block) -------------------------------------------

_BC7_MODES = (   # subsets, partition bits, rotation bits, index-selection bits, colour bits,
    (3, 4, 0, 0, 4, 0, 1, 0, 3, 0),   # alpha bits, endpoint p-bits, shared p-bits,
    (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),   # index bits, second index bits
    (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
    (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
    (1, 0, 2, 1, 5, 6, 0, 0, 2, 3),
    (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
    (1, 0, 0, 0, 7, 7, 1, 0, 4, 0),
    (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
_BC7_P2 = (0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
           0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
           0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
           0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
           0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
           0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
_BC7_P3 = (   # 64 partitions x 16 pixels, subset of each
    "0011001102212222000100112211222100002001221122110222002200110111"
    "0000000011221122001100110022002200220022111111110011001122112211"
    "0000000011112222000011111111222200001111222222220012001200120012"
    "0112011201120112012201220122012200110112112212220011200122002220"
    "0001001101121122011100112001220000001122112211220022002200221111"
    "0111011102220222000100012221222100000011012201220000110022102210"
    "0122012200110000001200121122222201101221122101100000011012211221"
    "0022110211020022011001102002222200110122012200110000200022112221"
    "0000000211221222022200220012001100110012002202220120012001200120"
    "0000111122220000012012012012012001202012120101200011220011220011"
    "0011112222000011010101012222222200000000212121210022112200221122"
    "0022001100220011022012210220122101012222222201010000212121212121"
    "0101010101012222022201110222011100021112000211120000211221122112"
    "0222011101110222000211121112000201100110011022220000000021122112"
    "0110011022222222002200110011002200221122112200220000000000002112"
    "0002000100020001022212220222122201012222222222220111201122012220")
_BC7_ANCHOR2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8,
                8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
                6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_BC7_ANCHOR3A = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8,
                 8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15,
                 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_BC7_ANCHOR3B = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15,
                 8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6,
                 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_BC7_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
                4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


def _bc7_block(block: bytes) -> np.ndarray:
    """One BC7 block -> [16, 4] RGBA (opaque black for the reserved mode 8)."""
    v = int.from_bytes(block, "little")
    mode = (v & -v).bit_length() - 1 if v & 0xFF else 8
    if mode >= 8:
        return np.tile(np.array([0, 0, 0, 255], np.int64), (16, 1))
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    pos = mode + 1

    def take(n):
        nonlocal pos
        out = (v >> pos) & ((1 << n) - 1)
        pos += n
        return out

    partition, rotation, index_sel = take(pb), take(rb), take(isb)
    ep = np.zeros((2 * ns, 4), np.int64)
    for c in range(3):
        for j in range(2 * ns):
            ep[j, c] = take(cb)
    if ab:
        for j in range(2 * ns):
            ep[j, 3] = take(ab)
    if epb:
        cb, ab = cb + 1, ab + 1 if ab else 0
        for j in range(2 * ns):
            p = take(1)
            ep[j, :3] = ep[j, :3] << 1 | p
            if ab:
                ep[j, 3] = ep[j, 3] << 1 | p
    if spb:
        cb, ab = cb + 1, ab + 1 if ab else 0
        for s in range(ns):
            p = take(1)
            for j in (2 * s, 2 * s + 1):
                ep[j, :3] = ep[j, :3] << 1 | p
                if ab:
                    ep[j, 3] = ep[j, 3] << 1 | p

    def unquantize(x, bits):
        x = (x << (8 - bits)) & 0xFF
        return x | (x >> bits)

    ep[:, :3] = unquantize(ep[:, :3], cb)
    ep[:, 3] = unquantize(ep[:, 3], ab) if ab else 255
    if ns == 1:
        subset, anchors = [0] * 16, (0,)
    elif ns == 2:
        subset = [(_BC7_P2[partition] >> i) & 1 for i in range(16)]
        anchors = (0, _BC7_ANCHOR2[partition])
    else:
        subset = [int(c) for c in _BC7_P3[16 * partition:16 * partition + 16]]
        anchors = (0, _BC7_ANCHOR3A[partition], _BC7_ANCHOR3B[partition])
    idx1 = [take(ib - (i in anchors)) for i in range(16)]
    idx2 = [take(ib2 - (i == 0)) for i in range(16)] if ib2 else idx1
    out = np.zeros((16, 4), np.int64)
    for i in range(16):
        e0, e1 = ep[2 * subset[i]], ep[2 * subset[i] + 1]
        ci, ai, cbits, abits = idx1[i], idx2[i], ib, ib2 or ib
        if ib2 and index_sel:
            ci, ai, cbits, abits = idx2[i], idx1[i], ib2, ib
        wc, wa = _BC7_WEIGHTS[cbits][ci], _BC7_WEIGHTS[abits][ai]
        out[i, :3] = (e0[:3] * (64 - wc) + e1[:3] * wc + 32) >> 6
        out[i, 3] = (e0[3] * (64 - wa) + e1[3] * wa + 32) >> 6
        if rotation:
            out[i, [3, rotation - 1]] = out[i, [rotation - 1, 3]]
    return out


# ---- BC6H (BcnDecode.c decode_bc6_block) ------------------------------------------
# Each rule was found by random blocks of every mode against PIL 12.1.

_BC6_MODES = (   # subsets, transformed, partition bits, endpoint bits, delta bits r, g, b
    (2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
    (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
    (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
    (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
    (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# the endpoint bits of each mode as the BC6H format document lays them out,
# from the block's low bits up, after the mode bits; "r0[10:15]" stores the
# bits reversed (r0[15] first); endpoints r0 g0 b0 r1 g1 b1 (subset 0) and
# r2 g2 b2 r3 g3 b3 (subset 1); csrc/image_dds.cpp kBc6Layouts is the same
_BC6_LAYOUTS = (
    "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
    "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] b0[6:0] b3[3] b3[5] "
    "b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] b1[3:0] "
    "b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] g3[3:0] b1[3:0] "
    "b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] "
    "b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] b3[3]",
    "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
    "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] g2[3:0] g1[4:0] "
    "b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]",
    "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
    "g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
    "g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] b0[5:0] g3[5] b3[3] "
    "b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]",
    "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] b0[10:11]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] b0[10:15]")


def _bc6_packing(layout: str) -> tuple:
    """A layout -> (endpoint, bit) per stored bit."""
    out = []
    for tok in layout.split():
        e = 3 * int(tok[1]) + "rgb".index(tok[0])
        a, _, b = tok[3:-1].partition(":")
        a, b = int(a), int(b or a)
        out += [(e, k) for k in (range(b, a + 1) if a >= b else range(b, a - 1, -1))]
    return tuple(out)


_BC6_PACKINGS = tuple(_bc6_packing(layout) for layout in _BC6_LAYOUTS)


def _bc6_sign_extend(v: int, prec: int) -> int:
    return (v | (-1 << prec)) & 0xFFFF if v & (1 << (prec - 1)) else v


def _bc6_unquantize(v: int, prec: int, sign: bool) -> int:
    if not sign:
        if prec >= 15 or v == 0:
            return v
        return 0xFFFF if v == (1 << prec) - 1 else ((v << 15) + 0x4000) >> (prec - 1)
    x = v - 0x10000 if v & 0x8000 else v                  # (INT16)
    if prec >= 16:
        return x
    mag = abs(x)
    if mag:
        mag = 0x7FFF if mag >= (1 << (prec - 1)) - 1 else ((mag << 15) + 0x4000) >> (prec - 1)
    return -mag if x < 0 else mag


def _bc6_channels(v: np.ndarray, sign: bool) -> np.ndarray:
    """bc6_finalize and bc6_clamp: [n] interpolated values -> [n] uint8, in
    float32 as BcnDecode.c (half_to_float rebases the exponent by a float
    multiply; x 255 truncated)."""
    if sign:
        half = np.where(v < 0, 0x8000 | ((-v) * 31) // 32, (v * 31) // 32)
    else:
        half = (v * 31) // 64
    f = ((half & 0x7FFF) << 13).astype(np.uint32).view(np.float32)
    f = f * np.uint32(0x77800000).view(np.float32)
    bits = f.view(np.uint32) | np.where(f >= np.uint32(0x47800000).view(np.float32),
                                        np.uint32(255 << 23), np.uint32(0))
    f = (bits | ((half & 0x8000) << 16).astype(np.uint32)).view(np.float32)
    scaled = np.clip(f * np.float32(255.0), 0, 255)       # the clip only guards the cast
    return np.where(f < 0, 0, np.where(f > 1, 255, scaled.astype(np.int64)))


def _bc6_block(block: bytes, sign: bool) -> np.ndarray:
    """One BC6H block -> [16, 3] RGB (black for the reserved modes)."""
    v = int.from_bytes(block, "little")
    mode, pos, ib = v & 0x1F, 5, 3
    if mode & 3 < 2:
        mode, pos = mode & 3, 2
    elif mode & 3 == 2:
        mode = 2 + (mode >> 2)
    else:
        mode, ib = 10 + (mode >> 2), 4
    if mode >= 14:
        return np.zeros((16, 3), np.int64)
    ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[mode]
    numep, mask = 6 * ns, (1 << epb) - 1
    ep = [0] * 12
    for e, k in _BC6_PACKINGS[mode]:
        ep[e] |= ((v >> pos) & 1) << k
        pos += 1
    partition = (v >> pos) & ((1 << pb) - 1)
    pos += pb
    if sign:
        ep[:3] = [_bc6_sign_extend(x, epb) for x in ep[:3]]
    if sign or tr:
        ep[3:numep] = [_bc6_sign_extend(x, (rb, gb, bb)[i % 3])
                       for i, x in enumerate(ep[3:numep])]
    if tr:   # masked to the endpoint bits, and (unlike the format document) not re-extended
        ep[3:numep] = [(x + ep[i % 3]) & mask for i, x in enumerate(ep[3:numep])]
    u = np.array([_bc6_unquantize(x, epb, sign) for x in ep[:numep]], np.int64)
    weights = _BC7_WEIGHTS[ib]
    lerp = np.zeros((16, 3), np.int64)
    for i in range(16):
        subset = (_BC7_P2[partition] >> i) & 1 if ns == 2 else 0
        bits = ib - (i == 0 or (ns == 2 and i == _BC7_ANCHOR2[partition]))
        w = weights[(v >> pos) & ((1 << bits) - 1)]
        pos += bits
        e0, e1 = u[6 * subset:6 * subset + 3], u[6 * subset + 3:6 * subset + 6]
        lerp[i] = (e0 * (64 - w) + e1 * w) >> 6
    return _bc6_channels(lerp.reshape(-1), sign).reshape(16, 3)


# ---- WebP lossless (VP8L) --------------------------------------------------------

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_CODE_TO_PLANE = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)


class _LsbBits:
    """VP8L's bit reader: bits least significant first."""

    def __init__(self, data: bytes):
        self.value, self.n, self.pos = int.from_bytes(data, "little"), 8 * len(data), 0

    def read(self, k: int) -> int:
        if self.pos + k > self.n:
            raise ValueError("WebP: truncated lossless data")
        out = (self.value >> self.pos) & ((1 << k) - 1)
        self.pos += k
        return out


class _Prefix:
    """A canonical prefix code from code lengths, read a bit at a time
    (a code of one used symbol reads no bits)."""

    def __init__(self, lengths):
        used = [s for s, n in enumerate(lengths) if n]
        if not used:
            raise ValueError("WebP: an empty prefix code")
        self.single = used[0] if len(used) == 1 else None
        self.table, code = {}, 0
        for n in range(1, 16):
            for s in used:
                if lengths[s] == n:
                    self.table[(n, code)] = s
                    code += 1
            code <<= 1
        if self.single is None and code != 1 << 16:
            raise ValueError("WebP: an incomplete prefix code")

    def read(self, br: _LsbBits) -> int:
        if self.single is not None:
            return self.single
        code = 0
        for n in range(1, 16):
            code = code << 1 | br.read(1)
            s = self.table.get((n, code))
            if s is not None:
                return s
        raise ValueError("WebP: a bad prefix code")


def _prefix_code(br: _LsbBits, size: int) -> _Prefix:
    lengths = [0] * size
    if br.read(1):                                    # simple code
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if n == 2:
            second = br.read(8)
            if second >= size or first >= size:
                raise ValueError("WebP: a bad simple prefix code")
            lengths[second] = 1
        return _Prefix(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    lengths_code = _Prefix(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise ValueError("WebP: a bad code length count")
    else:
        max_symbol = size
    symbol, prev = 0, 8
    while symbol < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = lengths_code.read(br)
        if c < 16:
            lengths[symbol] = c
            symbol += 1
            prev = c or prev
            continue
        repeat = br.read((2, 3, 7)[c - 16]) + (3, 3, 11)[c - 16]
        if symbol + repeat > size:
            raise ValueError("WebP: a code length run past the alphabet")
        lengths[symbol:symbol + repeat] = [prev if c == 16 else 0] * repeat
        symbol += repeat
    return _Prefix(lengths)


def _copy_distance(br: _LsbBits, symbol: int) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _vp8l_image(br: _LsbBits, w: int, h: int, level0: bool):
    """One entropy-coded image (the main one with ``level0``) -> [h * w]
    ARGB ints, before the transforms; and the transforms read."""
    transforms = []
    if level0:
        while br.read(1):
            kind = br.read(2)
            if any(t[0] == kind for t in transforms):
                raise ValueError("WebP: a transform repeated")
            if kind in (0, 1):
                bits = br.read(3) + 2
                sub = _vp8l_image(br, -(-w // (1 << bits)), -(-h // (1 << bits)), False)[0]
                transforms.append((kind, bits, sub, w))
            elif kind == 3:
                colours = br.read(8) + 1
                bits = 0 if colours > 16 else 1 if colours > 4 else 2 if colours > 2 else 3
                table = _vp8l_image(br, colours, 1, False)[0]
                for i in range(1, colours):       # delta-coded per channel
                    a, b = table[i - 1], table[i]
                    table[i] = sum(((a >> s) + (b >> s) & 255) << s for s in (0, 8, 16, 24))
                transforms.append((3, bits, table, w))
                w = -(-w // (1 << bits))
            else:
                transforms.append((2, 0, None, w))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("WebP: a bad colour cache size")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = -(-w // (1 << meta_bits))
        meta = [(p >> 8) & 0xFFFF for p in _vp8l_image(br, mw, -(-h // (1 << meta_bits)),
                                                        False)[0]]
    groups = (max(meta) + 1) if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    codes = [[_prefix_code(br, n) for n in (280 + cache_size, 256, 256, 256, 40)]
             for _ in range(groups)]
    out, cache, total = [], [0] * cache_size, w * h
    inserted = 0
    while len(out) < total:
        pos = len(out)
        g = codes[meta[(pos // w >> meta_bits) * mw + (pos % w >> meta_bits)]] if meta \
            else codes[0]
        code = g[0].read(br)
        if code < 256:
            r, b, a = g[1].read(br), g[2].read(br), g[3].read(br)
            out.append(a << 24 | r << 16 | code << 8 | b)
        elif code < 280:
            length = _copy_distance(br, code - 256)
            plane = _copy_distance(br, g[4].read(br))
            if plane > 120:
                dist = plane - 120
            else:
                d = _CODE_TO_PLANE[plane - 1]
                dist = max((d >> 4) * w + 8 - (d & 15), 1)
            if dist > pos or pos + length > total:
                raise ValueError("WebP: a backward reference out of the image")
            for k in range(length):
                out.append(out[pos - dist + k])
        else:
            if code - 280 >= cache_size:
                raise ValueError("WebP: a bad colour cache index")
            while inserted < len(out):
                p = out[inserted]
                cache[((0x1E35A7BD * p) & 0xFFFFFFFF) >> (32 - cache_bits)] = p
                inserted += 1
            out.append(cache[code - 280])
        if cache_size:
            while inserted < len(out):
                p = out[inserted]
                cache[((0x1E35A7BD * p) & 0xFFFFFFFF) >> (32 - cache_bits)] = p
                inserted += 1
    return out, transforms, w


def _vp8l_inverse(px: list, transforms, h: int) -> np.ndarray:
    """The transforms undone in reverse order -> [h, w, 4] RGBA uint8."""
    arr = np.array(px, np.uint32)
    cur_w = len(px) // h
    for kind, bits, data, width in reversed(transforms):
        if kind == 2:                                    # add green back
            g = (arr >> 8) & 255
            r = (((arr >> 16) & 255) + g) & 255
            b = ((arr & 255) + g) & 255
            arr = (arr & 0xFF00FF00) | (r << 16) | b
        elif kind == 3:                                  # colour indexing
            table = np.zeros(256, np.uint32)
            table[:len(data)] = data
            img = arr.reshape(h, cur_w)
            green = (img >> 8) & 255
            per = 1 << bits
            bpp = 8 >> bits
            xs = np.arange(width)
            packed = green[:, xs >> bits]
            index = (packed >> ((xs & (per - 1)) * bpp)) & ((1 << bpp) - 1)
            arr = table[index].reshape(-1)
            cur_w = width
        else:
            img = arr.reshape(h, cur_w).astype(np.int64)
            sw = -(-cur_w // (1 << bits))
            sub = np.array(data, np.int64).reshape(-1, sw)
            out = img.copy()
            if kind == 1:                                # cross colour
                el = sub[np.arange(h)[:, None] >> bits, np.arange(cur_w)[None, :] >> bits]
                s8 = lambda v: ((v & 255) ^ 128) - 128   # noqa: E731
                g = s8(img >> 8)
                r = ((img >> 16) & 255) + ((s8(el) * g) >> 5)
                r &= 255
                b = (img & 255) + ((s8(el >> 8) * g) >> 5) + ((s8(el >> 16) * s8(r)) >> 5)
                out = (img & 0xFF00FF00) | (r << 16) | (b & 255)
            else:                                        # predictor
                _predict(out, sub, bits)
            arr = out.astype(np.uint32).reshape(-1)
    return arr.reshape(h, -1)


def _predict(img: np.ndarray, sub: np.ndarray, bits: int):
    """The predictor transform undone in place (row by row, in order)."""
    h, w = img.shape

    def ch(v):
        return [(v >> s) & 255 for s in (24, 16, 8, 0)]

    def join(c):
        return (c[0] & 255) << 24 | (c[1] & 255) << 16 | (c[2] & 255) << 8 | (c[3] & 255)

    def avg(a, b):
        return [(x + y) >> 1 for x, y in zip(ch(a), ch(b))]

    for y in range(h):
        for x in range(w):
            if y == 0:
                pred = 0xFF000000 if x == 0 else int(img[0, x - 1])
            elif x == 0:
                pred = int(img[y - 1, 0])
            else:
                mode = (int(sub[y >> bits, x >> bits]) >> 8) & 15
                L, T, TL = int(img[y, x - 1]), int(img[y - 1, x]), int(img[y - 1, x - 1])
                TR = int(img[y - 1, x + 1]) if x + 1 < w else int(img[y, 0])
                if mode == 1:
                    pred = L
                elif mode == 2:
                    pred = T
                elif mode == 3:
                    pred = TR
                elif mode == 4:
                    pred = TL
                elif mode == 5:
                    pred = join(avg(join(avg(L, TR)), T))
                elif mode == 6:
                    pred = join(avg(L, TL))
                elif mode == 7:
                    pred = join(avg(L, T))
                elif mode == 8:
                    pred = join(avg(TL, T))
                elif mode == 9:
                    pred = join(avg(T, TR))
                elif mode == 10:
                    pred = join(avg(join(avg(L, TL)), join(avg(T, TR))))
                elif mode == 11:
                    cl, ct, ctl = ch(L), ch(T), ch(TL)
                    pl = sum(abs(t - tl) for t, tl in zip(ct, ctl))     # |estimate - L|
                    pt = sum(abs(l_ - tl) for l_, tl in zip(cl, ctl))   # |estimate - T|
                    pred = L if pl < pt else T
                elif mode == 12:
                    pred = join([min(max(a + b - c, 0), 255)
                                 for a, b, c in zip(ch(L), ch(T), ch(TL))])
                elif mode == 13:
                    pred = join([min(max(a + (a - c) // 2 if a >= c else a - (c - a) // 2, 0), 255)
                                 for a, c in zip(avg(L, T), ch(TL))])
                else:
                    pred = 0xFF000000
            v = int(img[y, x])
            img[y, x] = join([a + b for a, b in zip(ch(v), ch(pred))])


def _vp8l_decode(body: bytes, alpha: bool) -> np.ndarray:
    """A VP8L bitstream -> [h, w, 4] RGBA (``alpha``), else [h, w, 3] RGB."""
    head = int.from_bytes(body[1:5], "little")
    w, h = (head & 0x3FFF) + 1, ((head >> 14) & 0x3FFF) + 1
    if w * h > MAX_PIXELS:
        raise ValueError("WebP: bad image size")
    br = _LsbBits(body[5:])
    px, transforms, _ = _vp8l_image(br, w, h, True)
    argb = _vp8l_inverse(px, transforms, h)
    rgba = np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255, argb >> 24], -1)
    rgba = rgba.astype(np.uint8)
    return np.ascontiguousarray(rgba if alpha else rgba[:, :, :3])


def _check_lossless_header(body: bytes):
    if len(body) < 5 or body[0] != 0x2F:
        raise ValueError("WebP: bad lossless signature")
    if int.from_bytes(body[1:5], "little") >> 29:
        raise ValueError("WebP: unknown lossless version")


def _vp8_decode_rgba(body: bytes, alph) -> np.ndarray:
    """A VP8 key frame and its ALPH chunk (or None: opaque) -> [h, w, 4]."""
    Y, U, V = _vp8_decode_vp8(body)
    h, w = Y.shape
    a = _vp8_decode_alpha(alph, w, h) if alph is not None else np.full((h, w), 255, np.uint8)
    return np.ascontiguousarray(np.concatenate([_vp8_to_rgb(Y, U, V), a[:, :, None]], -1))


def _frame_features(lossy: bool, d: bytes, avail: int, size: int):
    """WebPGetFeatures on a frame's image chunk (VP8GetInfo / VP8LGetInfo in
    libwebp's dec/webp_dec.c, vp8_dec.c, vp8l_dec.c): its (w, h), or a
    refusal.  ``avail`` is the padded payload, ``size`` the chunk's own."""
    if lossy:
        if avail < 10 or d[3:6] != b"\x9d\x01\x2a":
            raise ValueError("WebP: bad frame bitstream header")
        bits = int.from_bytes(d[:3], "little")
        w = int.from_bytes(d[6:8], "little") & 0x3FFF
        h = int.from_bytes(d[8:10], "little") & 0x3FFF
        if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= size \
                or not w or not h:
            raise ValueError("WebP: bad frame bitstream header")
        return w, h
    if avail < 5 or d[0] != 0x2F or d[4] >> 5:
        raise ValueError("WebP: bad frame bitstream header")
    head = int.from_bytes(d[1:5], "little")
    return (head & 0x3FFF) + 1, ((head >> 14) & 0x3FFF) + 1


def _webp_anim(blob: bytes, vp8x: int) -> Decoded:
    """An animated WebP's first frame as PIL reads it through WebPAnimDecoder
    (libwebp src/demux/demux.c parses and validates, anim_decode.c
    composites; see ``csrc/image_webp.cpp`` decode_webp_anim)."""
    le = lambda at, n: int.from_bytes(blob[at:at + n], "little")   # noqa: E731
    # demux.c ReadHeader: the RIFF size bounds the data; a shorter file is partial
    riff_size = le(4, 4)
    if riff_size < 8 or riff_size > 0xFFFFFFF6 or len(blob) < riff_size + 8:
        raise ValueError("WebP: the RIFF size does not match the file")
    end = riff_size + 8
    # ParseVP8X: the flags, the canvas (sizes less one: never 0) below MAX_IMAGE_AREA
    vp8x_size = le(vp8x + 4, 4) + (le(vp8x + 4, 4) & 1)
    if end < vp8x + 8 or vp8x_size > end - vp8x - 8:
        raise ValueError("WebP: a chunk runs past the end of the RIFF data")
    flags = blob[vp8x + 8]
    cw, ch = 1 + le(vp8x + 12, 3), 1 + le(vp8x + 15, 3)
    if cw * ch >= 1 << 32:
        raise ValueError("WebP: bad canvas size")
    pos = vp8x + 8 + vp8x_size

    def header(at):   # a chunk's tag, size and padded size, size-checked
        if end - at < 8:
            raise ValueError("WebP: truncated chunk data")
        size = le(at + 4, 4)
        padded = size + (size & 1)
        if size > 0xFFFFFFF6 or padded > end - at - 8:
            raise ValueError("WebP: a chunk runs past the end of the RIFF data")
        return blob[at:at + 4], size, padded

    # ParseVP8XChunks / ParseAnimationFrame / StoreFrame
    anim, frames, last_complete = False, [], True
    while True:
        tag, size, padded = header(pos)
        if tag == b"VP8X":
            raise ValueError("WebP: a second VP8X chunk")
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            raise ValueError("WebP: an image chunk outside ANMF in an animated WebP")
        if tag == b"ANIM":
            if padded < 6:
                raise ValueError("WebP: short ANIM chunk")
            anim = True   # the background colour and loop count: PIL's pixels ignore them
            pos += 8 + padded
        elif tag == b"ANMF":
            if not anim:
                raise ValueError("WebP: ANMF before ANIM")
            if padded < 16:
                raise ValueError("WebP: short ANMF chunk")
            d = pos + 8
            # the size fields only bound the frame's area: its bitstream's size counts
            if (1 + le(d + 6, 3)) * (1 + le(d + 9, 3)) >= 1 << 32:
                raise ValueError("WebP: bad frame size")
            fr = {"x": 2 * le(d, 3), "y": 2 * le(d + 3, 3), "alph": None, "image": None,
                  "alph_last": False}
            payload, start = padded - 16, pos + 8 + 16
            if end - start < 8 or end - start < payload:
                raise ValueError("WebP: truncated chunk data")
            cur, has_frame, complete, done = start, False, False, False
            while not done:
                sub, sub_size, sub_padded = header(cur)
                body = blob[cur + 8:cur + 8 + sub_size]
                if sub == b"ALPH" and fr["alph"] is None:
                    fr["alph"], fr["alph_last"] = body, fr["image"] is not None
                    has_frame = True
                    cur += 8 + sub_padded
                elif sub in (b"VP8 ", b"VP8L") and fr["image"] is None:
                    fr["lossy"] = sub == b"VP8 "
                    if not fr["lossy"] and fr["alph"] is not None:
                        raise ValueError("WebP: ALPH before VP8L in a frame")
                    fr["w"], fr["h"] = _frame_features(
                        fr["lossy"], blob[cur + 8:cur + 8 + sub_padded], sub_padded, sub_size)
                    fr["image"] = body
                    has_frame = complete = True
                    cur += 8 + sub_padded
                else:
                    done = True   # any other chunk ends the frame
                if cur == end:
                    done = True
                elif end - cur < 8:
                    raise ValueError("WebP: truncated chunk data")
            if cur - start > payload:
                raise ValueError("WebP: a frame's chunks run past its ANMF chunk")
            if has_frame:   # AddFrame: only with a chunk, none after an incomplete frame
                if not last_complete:
                    raise ValueError("WebP: an ANMF with no image chunk")
                frames.append(fr)
                last_complete = complete
            pos = cur   # the parse goes on after the frame's chunks
        else:
            pos += 8 + padded
        if pos == end:
            break
    # IsValidExtendedFormat
    if not frames:
        raise ValueError("WebP: an animated WebP with no frame")
    if flags & ~0x3E:
        raise ValueError("WebP: reserved VP8X flags are set")
    for fr in frames:
        if fr["alph_last"]:
            raise ValueError("WebP: ALPH after the image chunk of a frame")
        if fr["image"] is None:
            raise ValueError("WebP: an ANMF with no image chunk")
        if fr["x"] + fr["w"] > cw or fr["y"] + fr["h"] > ch:
            raise ValueError("WebP: a frame lies outside the canvas")
    if cw * ch > MAX_PIXELS:
        raise ValueError("WebP: bad image size")
    # WebPAnimDecoderGetNext, first frame: a key frame, so the canvas is zeroed
    # (transparent black) and the frame decoded into its rectangle
    fr = frames[0]
    if fr["lossy"]:
        px = _vp8_decode_rgba(fr["image"], fr["alph"])
    else:
        _check_lossless_header(fr["image"])
        px = _vp8l_decode(fr["image"], True)
    alpha = bool(flags & 0x10)   # PIL: RGBA where VP8X has alpha, else RGBX -> RGB
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[fr["y"]:fr["y"] + px.shape[0], fr["x"]:fr["x"] + px.shape[1]] = px
    return Decoded(np.ascontiguousarray(canvas if alpha else canvas[:, :, :3]),
                   "RGBA" if alpha else "RGB")


def decode_webp(blob: bytes) -> Decoded:
    """A WebP as PIL reads it through libwebp's animation decoder: a still
    image (VP8L or VP8, alone or in a VP8X file), RGBA where the file says it
    has alpha, else RGB; an animated one's first frame (see
    ``csrc/image_webp.cpp``)."""
    if len(blob) < 20 or blob[:4] != b"RIFF" or blob[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    pos, alpha, chunk, alph = 12, None, None, None
    while pos + 8 <= len(blob):
        name, size = blob[pos:pos + 4], int.from_bytes(blob[pos + 4:pos + 8], "little")
        body = blob[pos + 8:pos + 8 + size]
        if name == b"VP8X":
            if len(body) < 10:
                raise ValueError("WebP: bad VP8X chunk")
            if body[0] & 0x02:
                return _webp_anim(blob, pos)
            alpha = bool(body[0] & 0x10)
        elif name == b"ALPH":
            alph = body
        elif name in (b"VP8L", b"VP8 "):
            chunk = (name, body)
            break
        pos += 8 + size + (size & 1)
    if chunk is None:
        raise ValueError("WebP: no image chunk")
    if chunk[0] == b"VP8 ":
        if not alpha:
            Y, U, V = _vp8_decode_vp8(chunk[1])
            return Decoded(_vp8_to_rgb(Y, U, V), "RGB")
        return Decoded(_vp8_decode_rgba(chunk[1], alph), "RGBA")
    body = chunk[1]
    _check_lossless_header(body)
    if alpha is None:
        alpha = bool(int.from_bytes(body[1:5], "little") >> 28 & 1)
    return Decoded(_vp8l_decode(body, alpha), "RGBA" if alpha else "RGB")


# ---- WebP lossy (VP8 key frame, as libwebp decodes it) ------------------------------

_VP8_UPDATE_T = (
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,)

_VP8_COEFFS0_T = (
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,)

_VP8_BMODES_T = (
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,)

_VP8_DC = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,)

_VP8_AC = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,)

_VUPDATE = np.array(_VP8_UPDATE_T).reshape(4, 8, 3, 11)
_VCOEFFS0 = np.array(_VP8_COEFFS0_T).reshape(4, 8, 3, 11)
_VBMODES = np.array(_VP8_BMODES_T).reshape(10, 10, 9)
_VBANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_VZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_VYMODES4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_VCAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
       (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_VDC_PRED, _VTM_PRED, _VV_PRED, _VH_PRED = 0, 1, 2, 3


class _BoolDecoder:
    """RFC 6386's boolean decoder (zeros past the end)."""

    def __init__(self, data: bytes):
        self.d, self.pos = data, 2
        self.value = (data[0] if data else 0) << 8 | (data[1] if len(data) > 1 else 0)
        self.range, self.count = 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            bit = 1
            self.range -= split
            self.value -= big
        else:
            bit = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.d[self.pos] if self.pos < len(self.d) else 0
                self.pos += 1
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v


def _vp8_clip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def _vp8_decode_vp8(data: bytes):
    """-> (Y [h, w], U, V [(h+1)//2, (w+1)//2]) uint8, cropped."""
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError("WebP: a VP8 frame that is not a key frame")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP: bad VP8 start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if not w or not h or w * h > MAX_PIXELS:
        raise ValueError("WebP: bad image size")
    if len(data) < 10 or part0 > len(data) - 10:
        raise ValueError("WebP: truncated VP8 frame")
    br = _BoolDecoder(data[10:10 + part0])
    br.value_bits(1)   # colour space
    br.value_bits(1)   # clamping type
    use_segment = br.value_bits(1)
    update_map = absolute = 0
    seg_q, seg_f, seg_p = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.value_bits(1)
        if br.value_bits(1):   # update data
            absolute = br.value_bits(1)
            seg_q = [br.signed(7) if br.value_bits(1) else 0 for _ in range(4)]
            seg_f = [br.signed(6) if br.value_bits(1) else 0 for _ in range(4)]
        if update_map:
            seg_p = [br.value_bits(8) if br.value_bits(1) else 255 for _ in range(3)]
    simple = br.value_bits(1)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    use_lf_delta = br.value_bits(1)
    ref_d, mode_d = [0] * 4, [0] * 4
    if use_lf_delta and br.value_bits(1):
        ref_d = [br.signed(6) if br.value_bits(1) else 0 for _ in range(4)]
        mode_d = [br.signed(6) if br.value_bits(1) else 0 for _ in range(4)]
    num_parts = 1 << br.value_bits(2)
    # token partitions
    at = 10 + part0
    sizes_at = at
    at += 3 * (num_parts - 1)
    parts = []
    for p in range(num_parts):
        if p < num_parts - 1:
            n = int.from_bytes(data[sizes_at + 3 * p:sizes_at + 3 * p + 3], "little")
            parts.append(_BoolDecoder(data[at:at + n]))
            at += n
        else:
            parts.append(_BoolDecoder(data[at:]))
    # quantizers
    base_q = br.value_bits(7)
    dq = [br.signed(4) if br.value_bits(1) else 0 for _ in range(5)]   # y1dc y2dc y2ac uvdc uvac
    quant = []
    for s in range(4):
        if use_segment:
            q = seg_q[s] + (0 if absolute else base_q)
        else:
            q = base_q
        y1 = (_VP8_DC[_vp8_clip(q + dq[0], 0, 127)], _VP8_AC[_vp8_clip(q, 0, 127)])
        y2dc = _VP8_DC[_vp8_clip(q + dq[1], 0, 127)] * 2
        y2ac = _VP8_AC[_vp8_clip(q + dq[2], 0, 127)] * 101581 >> 16
        y2 = (y2dc, max(y2ac, 8))
        uv = (_VP8_DC[_vp8_clip(q + dq[3], 0, 117)], _VP8_AC[_vp8_clip(q + dq[4], 0, 127)])
        quant.append((y1, y2, uv))
    br.value_bits(1)   # refresh entropy probs (ignored)
    proba = _VCOEFFS0.copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(_VUPDATE[t, b, c, p])):
                        proba[t, b, c, p] = br.value_bits(8)
    use_skip = br.value_bits(1)
    skip_p = br.value_bits(8) if use_skip else 0
    # filter strengths per segment and i4x4
    ftype = 0 if level == 0 else (1 if simple else 2)
    fstr = {}
    for s in range(4):
        base = (seg_f[s] + (0 if absolute else level)) if use_segment else level
        for i4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_d[0]
                if i4:
                    lv += mode_d[0]
            lv = _vp8_clip(lv, 0, 63)
            if lv > 0:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                fstr[s, i4] = (2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0)
            else:
                fstr[s, i4] = (0, 0, 0)
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    Y = np.zeros((mbh * 16, mbw * 16), np.int32)
    U = np.zeros((mbh * 8, mbw * 8), np.int32)
    V = np.zeros((mbh * 8, mbw * 8), np.int32)
    intra_t = [0] * (4 * mbw)
    nz_top = [(0, 0)] * mbw   # (nz, nz_dc)
    finfo = [[None] * mbw for _ in range(mbh)]
    for my in range(mbh):
        intra_l = [0] * 4
        nz_left = (0, 0)
        tok = parts[my & (num_parts - 1)]
        for mx in range(mbw):
            # modes
            segment = 0
            if update_map:
                segment = br.bit(seg_p[1]) if not br.bit(seg_p[0]) else br.bit(seg_p[2]) + 2
            skip = br.bit(skip_p) if use_skip else 0
            is_i4 = not br.bit(145)
            imodes = []
            if not is_i4:
                ymode = (_VTM_PRED if br.bit(128) else _VH_PRED) if br.bit(156) else \
                    (_VV_PRED if br.bit(163) else _VDC_PRED)
                for k in range(4):
                    intra_t[4 * mx + k] = ymode
                    intra_l[k] = ymode
            else:
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = _VBMODES[intra_t[4 * mx + x], ym]
                        i = _VYMODES4[br.bit(int(prob[0]))]
                        while i > 0:
                            i = _VYMODES4[2 * i + br.bit(int(prob[i]))]
                        ym = -i
                        intra_t[4 * mx + x] = ym
                        imodes.append(ym)
                    intra_l[y] = ym
            uvmode = _VDC_PRED if not br.bit(142) else (_VV_PRED if not br.bit(114) else
                                                       (_VTM_PRED if br.bit(183) else _VH_PRED))
            # residuals
            coeffs = np.zeros((25, 16), np.int64)   # 16 y, 4 u, 4 v (+1 scratch)
            y1, y2, uvq = quant[segment]
            has_coeffs = False
            if not skip:
                tnz_all, tdc = nz_top[mx]
                lnz_all, ldc = nz_left
                if not is_i4:
                    dc = np.zeros(16, np.int64)
                    nz = _vp8_get_coeffs(tok, proba[1], tdc + ldc, y2, 0, dc)
                    tdc = ldc = int(nz > 0)
                    if nz > 1:
                        _vp8_wht(dc, coeffs)
                    else:
                        coeffs[:16, 0] = _vp8_to16((int(dc[0]) + 3) >> 3)
                    first, ac_p = 1, proba[0]
                else:
                    first, ac_p = 0, proba[3]
                tnz, lnz = tnz_all & 0x0F, lnz_all & 0x0F
                nonzero = False
                for y in range(4):
                    l = lnz & 1
                    for x in range(4):
                        ctx = l + (tnz & 1)
                        blk = coeffs[4 * y + x]
                        nz = _vp8_get_coeffs(tok, ac_p, ctx, y1, first, blk)
                        l = int(nz > first)
                        tnz = (tnz >> 1) | (l << 7)
                        nonzero |= nz > 1 or blk[0] != 0
                    tnz >>= 4
                    lnz = (lnz >> 1) | (l << 7)
                out_t, out_l = tnz, lnz >> 4
                for ch in (0, 2):
                    tnz = tnz_all >> (4 + ch)
                    lnz = lnz_all >> (4 + ch)
                    for y in range(2):
                        l = lnz & 1
                        for x in range(2):
                            ctx = l + (tnz & 1)
                            blk = coeffs[16 + 2 * ch + 2 * y + x]
                            nz = _vp8_get_coeffs(tok, proba[2], ctx, uvq, 0, blk)
                            l = int(nz > 0)
                            tnz = (tnz >> 1) | (l << 3)
                            nonzero |= nz > 1 or blk[0] != 0
                        tnz >>= 2
                        lnz = (lnz >> 1) | (l << 5)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lnz & 0xF0) << ch
                nz_top[mx] = (out_t, tdc)
                nz_left = (out_l, ldc)
                has_coeffs = nonzero
            else:
                nz_top[mx] = (0, 0 if not is_i4 else nz_top[mx][1])
                nz_left = (0, 0 if not is_i4 else nz_left[1])
            _vp8_reconstruct(Y, U, V, mx, my, mbw, is_i4, imodes, ymode if not is_i4 else None,
                        uvmode, coeffs)
            fs = fstr[segment, int(is_i4)]
            finfo[my][mx] = (fs[0], fs[1], fs[2], is_i4 or has_coeffs)
    if ftype:
        for my in range(mbh):
            for mx in range(mbw):
                _vp8_loop_filter(Y, U, V, mx, my, ftype, *finfo[my][mx])
    return (Y[:h, :w].astype(np.uint8), U[:(h + 1) // 2, :(w + 1) // 2].astype(np.uint8),
            V[:(h + 1) // 2, :(w + 1) // 2].astype(np.uint8))


def _vp8_to16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _vp8_get_coeffs(br, prob, ctx, dq, n, out):
    """libwebp GetCoeffsFast -> the count of coefficients read."""
    p = prob[_VBANDS[n]][ctx]
    while n < 16:
        if not br.bit(int(p[0])):
            return n
        while not br.bit(int(p[1])):
            n += 1
            p = prob[_VBANDS[n]][0]
            if n == 16:
                return 16
        nxt = prob[_VBANDS[n + 1]]
        if not br.bit(int(p[2])):
            v = 1
            p = nxt[1]
        else:
            v = _vp8_large_value(br, p)
            p = nxt[2]
        s = -v if br.bit(128) else v
        out[_VZIGZAG[n]] = _vp8_to16(s * dq[n > 0])
        n += 1
    return 16


def _vp8_large_value(br, p):
    if not br.bit(int(p[3])):
        if not br.bit(int(p[4])):
            return 2
        return 3 + br.bit(int(p[5]))
    if not br.bit(int(p[6])):
        if not br.bit(int(p[7])):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(int(p[8]))
    bit0 = br.bit(int(p[9 + bit1]))
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _VCAT[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _vp8_wht(inp, coeffs):
    tmp = [0] * 16
    for i in range(4):
        a0 = int(inp[0 + i]) + int(inp[12 + i])
        a1 = int(inp[4 + i]) + int(inp[8 + i])
        a2 = int(inp[4 + i]) - int(inp[8 + i])
        a3 = int(inp[0 + i]) - int(inp[12 + i])
        tmp[0 + i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        dc = tmp[0 + i * 4] + 3
        a0 = dc + tmp[3 + i * 4]
        a1 = tmp[1 + i * 4] + tmp[2 + i * 4]
        a2 = tmp[1 + i * 4] - tmp[2 + i * 4]
        a3 = dc - tmp[3 + i * 4]
        coeffs[4 * i + 0, 0] = _vp8_to16((a0 + a1) >> 3)
        coeffs[4 * i + 1, 0] = _vp8_to16((a3 + a2) >> 3)
        coeffs[4 * i + 2, 0] = _vp8_to16((a0 - a1) >> 3)
        coeffs[4 * i + 3, 0] = _vp8_to16((a3 - a2) >> 3)


def _vp8_mul1(a):
    return ((a * 20091) >> 16) + a


def _vp8_mul2(a):
    return (a * 35468) >> 16


def _vp8_transform(inp, block):
    """TransformOne: add the inverse DCT of ``inp`` (16) into block [4, 4]."""
    C = [0] * 16
    for i in range(4):
        a = int(inp[i]) + int(inp[8 + i])
        b = int(inp[i]) - int(inp[8 + i])
        c = _vp8_mul2(int(inp[4 + i])) - _vp8_mul1(int(inp[12 + i]))
        d = _vp8_mul1(int(inp[4 + i])) + _vp8_mul2(int(inp[12 + i]))
        C[4 * i:4 * i + 4] = [a + d, b + c, b - c, a - d]
    for i in range(4):
        dc = C[i] + 4
        a = dc + C[8 + i]
        b = dc - C[8 + i]
        c = _vp8_mul2(C[4 + i]) - _vp8_mul1(C[12 + i])
        d = _vp8_mul1(C[4 + i]) + _vp8_mul2(C[12 + i])
        for x, v in enumerate((a + d, b + c, b - c, a - d)):
            block[i, x] = _vp8_clip(block[i, x] + (v >> 3), 0, 255)


# the work buffer: prediction from unfiltered reconstruction with libwebp's borders
def _vp8_reconstruct(Y, U, V, mx, my, mbw, is_i4, imodes, ymode, uvmode, coeffs):
    for plane, size, blocks in ((Y, 16, None), (U, 8, 16), (V, 8, 20)):
        x0, y0 = mx * size, my * size
        buf = np.zeros((size + 1, size + 1 + 4), np.int32)   # row 0 / col 0: borders
        if my == 0:
            buf[0, :] = 127
        else:
            buf[0, 1:size + 1] = plane[y0 - 1, x0:x0 + size]
            buf[0, 0] = 129 if mx == 0 else plane[y0 - 1, x0 - 1]
        if mx == 0:
            buf[1:, 0] = 129
        else:
            buf[1:, 0] = plane[y0:y0 + size, x0 - 1]
        if size == 16:
            if my > 0:
                if mx >= mbw - 1:
                    buf[0, 17:21] = plane[y0 - 1, x0 + 15]
                else:
                    buf[0, 17:21] = plane[y0 - 1, x0 + 16:x0 + 20]
            # top-right replicated below
            for r in (4, 8, 12):
                buf[r, 17:21] = buf[0, 17:21]
            if is_i4:
                for n in range(16):
                    by, bx = 4 * (n // 4) + 1, 4 * (n % 4) + 1
                    _vp8_pred4(buf, by, bx, imodes[n])
                    _vp8_transform(coeffs[n], buf[by:by + 4, bx:bx + 4])
            else:
                _vp8_pred_n(buf, 16, ymode, mx, my)
                for n in range(16):
                    by, bx = 4 * (n // 4) + 1, 4 * (n % 4) + 1
                    _vp8_transform(coeffs[n], buf[by:by + 4, bx:bx + 4])
        else:
            _vp8_pred_n(buf, 8, uvmode, mx, my)
            for n in range(4):
                by, bx = 4 * (n // 2) + 1, 4 * (n % 2) + 1
                _vp8_transform(coeffs[blocks + n], buf[by:by + 4, bx:bx + 4])
        plane[y0:y0 + size, x0:x0 + size] = buf[1:size + 1, 1:size + 1]


def _vp8_pred_n(buf, n, mode, mx, my):
    top, left, tl = buf[0, 1:n + 1], buf[1:n + 1, 0], int(buf[0, 0])
    sh = 5 if n == 16 else 4
    if mode == _VDC_PRED:
        if mx == 0 and my == 0:
            v = 0x80
        elif my == 0:
            v = (int(left.sum()) + (n >> 1)) >> (sh - 1)
        elif mx == 0:
            v = (int(top.sum()) + (n >> 1)) >> (sh - 1)
        else:
            v = (int(top.sum()) + int(left.sum()) + n) >> sh
        buf[1:n + 1, 1:n + 1] = v
    elif mode == _VTM_PRED:
        buf[1:n + 1, 1:n + 1] = np.clip(top[None, :] + left[:, None] - tl, 0, 255)
    elif mode == _VV_PRED:
        buf[1:n + 1, 1:n + 1] = top[None, :]
    else:
        buf[1:n + 1, 1:n + 1] = left[:, None]


def _vp8_avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _vp8_avg2(a, b):
    return (a + b + 1) >> 1


def _vp8_pred4(buf, by, bx, mode):
    top = [int(v) for v in buf[by - 1, bx - 1:bx + 8]]   # X, A..H
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = (int(buf[by + r, bx - 1]) for r in range(4))
    out = [[0] * 4 for _ in range(4)]
    a3, a2 = _vp8_avg3, _vp8_avg2

    def put(x, y, v):
        out[y][x] = v
    if mode == 0:   # DC
        dc = (A + B + C + D + I + J + K + L + 4) >> 3
        out = [[dc] * 4 for _ in range(4)]
    elif mode == 1:   # TM
        out = [[_vp8_clip(t + l - X, 0, 255) for t in (A, B, C, D)] for l in (I, J, K, L)]
    elif mode == 2:   # VE
        vals = [a3(X, A, B), a3(A, B, C), a3(B, C, D), a3(C, D, E)]
        out = [vals[:] for _ in range(4)]
    elif mode == 3:   # HE
        out = [[a3(X, I, J)] * 4, [a3(I, J, K)] * 4, [a3(J, K, L)] * 4, [a3(K, L, L)] * 4]
    elif mode == 4:   # RD
        for (x, y), v in {(0, 3): a3(J, K, L), (1, 3): a3(I, J, K), (0, 2): a3(I, J, K),
                          (2, 3): a3(X, I, J), (1, 2): a3(X, I, J), (0, 1): a3(X, I, J),
                          (3, 3): a3(A, X, I), (2, 2): a3(A, X, I), (1, 1): a3(A, X, I),
                          (0, 0): a3(A, X, I), (3, 2): a3(B, A, X), (2, 1): a3(B, A, X),
                          (1, 0): a3(B, A, X), (3, 1): a3(C, B, A), (2, 0): a3(C, B, A),
                          (3, 0): a3(D, C, B)}.items():
            put(x, y, v)
    elif mode == 5:   # VR
        vals = {(0, 0): a2(X, A), (1, 2): a2(X, A), (1, 0): a2(A, B), (2, 2): a2(A, B),
                (2, 0): a2(B, C), (3, 2): a2(B, C), (3, 0): a2(C, D),
                (0, 3): a3(K, J, I), (0, 2): a3(J, I, X), (0, 1): a3(I, X, A),
                (1, 3): a3(I, X, A), (1, 1): a3(X, A, B), (2, 3): a3(X, A, B),
                (2, 1): a3(A, B, C), (3, 3): a3(A, B, C), (3, 1): a3(B, C, D)}
        for (x, y), v in vals.items():
            put(x, y, v)
    elif mode == 6:   # LD
        seq = [a3(A, B, C), a3(B, C, D), a3(C, D, E), a3(D, E, F), a3(E, F, G),
               a3(F, G, H), a3(G, H, H)]
        for y in range(4):
            for x in range(4):
                put(x, y, seq[x + y])
    elif mode == 7:   # VL
        vals = {(0, 0): a2(A, B), (1, 0): a2(B, C), (0, 2): a2(B, C), (2, 0): a2(C, D),
                (1, 2): a2(C, D), (3, 0): a2(D, E), (2, 2): a2(D, E),
                (0, 1): a3(A, B, C), (1, 1): a3(B, C, D), (0, 3): a3(B, C, D),
                (2, 1): a3(C, D, E), (1, 3): a3(C, D, E), (3, 1): a3(D, E, F),
                (2, 3): a3(D, E, F), (3, 2): a3(E, F, G), (3, 3): a3(F, G, H)}
        for (x, y), v in vals.items():
            put(x, y, v)
    elif mode == 8:   # HD
        vals = {(0, 0): a2(I, X), (2, 1): a2(I, X), (0, 1): a2(J, I), (2, 2): a2(J, I),
                (0, 2): a2(K, J), (2, 3): a2(K, J), (0, 3): a2(L, K),
                (3, 0): a3(A, B, C), (2, 0): a3(X, A, B), (1, 0): a3(I, X, A),
                (3, 1): a3(I, X, A), (1, 1): a3(J, I, X), (3, 2): a3(J, I, X),
                (1, 2): a3(K, J, I), (3, 3): a3(K, J, I), (1, 3): a3(L, K, J)}
        for (x, y), v in vals.items():
            put(x, y, v)
    else:   # HU
        vals = {(0, 0): a2(I, J), (2, 0): a2(J, K), (0, 1): a2(J, K), (2, 1): a2(K, L),
                (0, 2): a2(K, L), (1, 0): a3(I, J, K), (3, 0): a3(J, K, L),
                (1, 1): a3(J, K, L), (3, 1): a3(K, L, L), (1, 2): a3(K, L, L)}
        for x, y in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
            vals[x, y] = L
        for (x, y), v in vals.items():
            put(x, y, v)
    buf[by:by + 4, bx:bx + 4] = out


def _vp8_sclip1(v):
    return _vp8_clip(v, -128, 127)


def _vp8_sclip2(v):
    return _vp8_clip(v, -16, 15)


def _vp8_clip1(v):
    return _vp8_clip(v, 0, 255)


def _vp8_filter2(P, i, s):
    p1, p0, q0, q1 = P[i - 2 * s], P[i - s], P[i], P[i + s]
    a = 3 * (q0 - p0) + _vp8_sclip1(p1 - q1)
    a1, a2 = _vp8_sclip2((a + 4) >> 3), _vp8_sclip2((a + 3) >> 3)
    P[i - s], P[i] = _vp8_clip1(p0 + a2), _vp8_clip1(q0 - a1)


def _vp8_filter4(P, i, s):
    c1 = _vp8_clip1
    p1, p0, q0, q1 = P[i - 2 * s], P[i - s], P[i], P[i + s]
    a = 3 * (q0 - p0)
    a1, a2 = _vp8_sclip2((a + 4) >> 3), _vp8_sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    P[i - 2 * s], P[i - s], P[i], P[i + s] = c1(p1 + a3), c1(p0 + a2), c1(q0 - a1), \
        c1(q1 - a3)


def _vp8_filter6(P, i, s):
    c1 = _vp8_clip1
    p2, p1, p0, q0, q1, q2 = (P[i + k * s] for k in (-3, -2, -1, 0, 1, 2))
    a = _vp8_sclip1(3 * (q0 - p0) + _vp8_sclip1(p1 - q1))
    a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
    P[i - 3 * s], P[i - 2 * s], P[i - s] = c1(p2 + a3), c1(p1 + a2), c1(p0 + a1)
    P[i], P[i + s], P[i + 2 * s] = c1(q0 - a1), c1(q1 - a2), c1(q2 - a3)


def _vp8_hev(P, i, s, t):
    return abs(P[i - 2 * s] - P[i - s]) > t or abs(P[i + s] - P[i]) > t


def _vp8_needs(P, i, s, t):
    return 4 * abs(P[i - s] - P[i]) + abs(P[i - 2 * s] - P[i + s]) <= t


def _vp8_needs2(P, i, s, t, it):
    p3, p2, p1, p0, q0, q1, q2, q3 = (P[i + k * s] for k in range(-4, 4))
    if 4 * abs(p0 - q0) + abs(p1 - q1) > t:
        return False
    return (abs(p3 - p2) <= it and abs(p2 - p1) <= it and abs(p1 - p0) <= it
            and abs(q3 - q2) <= it and abs(q2 - q1) <= it and abs(q1 - q0) <= it)


def _vp8_edge(plane, starts, step, thresh, ithresh, hev_t, six):
    P = plane.reshape(-1)
    t2 = 2 * thresh + 1
    for i in starts:
        if _vp8_needs2(P, i, step, t2, ithresh):
            if _vp8_hev(P, i, step, hev_t):
                _vp8_filter2(P, i, step)
            elif six:
                _vp8_filter6(P, i, step)
            else:
                _vp8_filter4(P, i, step)


def _vp8_simple_edge(plane, starts, step, thresh):
    P = plane.reshape(-1)
    t2 = 2 * thresh + 1
    for i in starts:
        if _vp8_needs(P, i, step, t2):
            _vp8_filter2(P, i, step)


def _vp8_loop_filter(Y, U, V, mx, my, ftype, limit, ilevel, hev_t, inner):
    if limit == 0:
        return
    W, UW = Y.shape[1], U.shape[1]
    y0, x0 = 16 * my, 16 * mx
    col = lambda plane, w, yy, xx, n: [(yy + r) * w + xx for r in range(n)]   # noqa: E731
    row = lambda plane, w, yy, xx, n: [yy * w + xx + c for c in range(n)]      # noqa: E731
    if ftype == 1:
        if mx > 0:
            _vp8_simple_edge(Y, col(Y, W, y0, x0, 16), 1, limit + 4)
        if inner:
            for k in (4, 8, 12):
                _vp8_simple_edge(Y, col(Y, W, y0, x0 + k, 16), 1, limit)
        if my > 0:
            _vp8_simple_edge(Y, row(Y, W, y0, x0, 16), W, limit + 4)
        if inner:
            for k in (4, 8, 12):
                _vp8_simple_edge(Y, row(Y, W, y0 + k, x0, 16), W, limit)
        return
    u0, v0 = 8 * my, 8 * mx
    if mx > 0:
        _vp8_edge(Y, col(Y, W, y0, x0, 16), 1, limit + 4, ilevel, hev_t, True)
        for P in (U, V):
            _vp8_edge(P, col(P, UW, u0, v0, 8), 1, limit + 4, ilevel, hev_t, True)
    if inner:
        for k in (4, 8, 12):
            _vp8_edge(Y, col(Y, W, y0, x0 + k, 16), 1, limit, ilevel, hev_t, False)
        for P in (U, V):
            _vp8_edge(P, col(P, UW, u0, v0 + 4, 8), 1, limit, ilevel, hev_t, False)
    if my > 0:
        _vp8_edge(Y, row(Y, W, y0, x0, 16), W, limit + 4, ilevel, hev_t, True)
        for P in (U, V):
            _vp8_edge(P, row(P, UW, u0, v0, 8), UW, limit + 4, ilevel, hev_t, True)
    if inner:
        for k in (4, 8, 12):
            _vp8_edge(Y, row(Y, W, y0 + k, x0, 16), W, limit, ilevel, hev_t, False)
        for P in (U, V):
            _vp8_edge(P, row(P, UW, u0 + 4, v0, 8), UW, limit, ilevel, hev_t, False)


def _vp8_yuv_to_rgb(y, u, v):
    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    hy = (y * 19077) >> 8
    r = clip8(hy + ((v * 26149) >> 8) - 14234)
    g = clip8(hy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip8(hy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _vp8_upsample_pair(top_y, bot_y, tu, tv, cu, cv, w):
    """libwebp's fancy upsampler for a row pair -> (top rgb, bottom rgb or None)."""
    def chroma(tc, cc):
        tc, cc = tc.astype(np.int64), cc.astype(np.int64)
        top = np.zeros(w, np.int64)
        bot = np.zeros(w, np.int64)
        top[0] = (3 * tc[0] + cc[0] + 2) >> 2
        bot[0] = (3 * cc[0] + tc[0] + 2) >> 2
        last = (w - 1) >> 1
        for x in range(1, last + 1):
            a, b, c, d = tc[x - 1], tc[x], cc[x - 1], cc[x]
            avg = a + b + c + d + 8
            d12 = (avg + 2 * (b + c)) >> 3
            d03 = (avg + 2 * (a + d)) >> 3
            top[2 * x - 1], top[2 * x] = (d12 + a) >> 1, (d03 + b) >> 1
            bot[2 * x - 1], bot[2 * x] = (d03 + c) >> 1, (d12 + d) >> 1
        if not w & 1:
            a, c = tc[last], cc[last]
            top[w - 1] = (3 * a + c + 2) >> 2
            bot[w - 1] = (3 * c + a + 2) >> 2
        return top, bot
    ut, ub = chroma(tu, cu)
    vt, vb = chroma(tv, cv)
    top = _vp8_yuv_to_rgb(top_y, ut, vt)
    bot = _vp8_yuv_to_rgb(bot_y, ub, vb) if bot_y is not None else None
    return top, bot


def _vp8_to_rgb(Y, U, V):
    h, w = Y.shape
    out = np.zeros((h, w, 3), np.uint8)
    out[0] = _vp8_upsample_pair(Y[0], None, U[0], V[0], U[0], V[0], w)[0]
    k = 0
    y = 1
    while y + 1 < h:
        t, b = _vp8_upsample_pair(Y[y], Y[y + 1], U[k], V[k], U[k + 1], V[k + 1], w)
        out[y], out[y + 1] = t, b
        k += 1
        y += 2
    if not h & 1:
        out[h - 1] = _vp8_upsample_pair(Y[h - 1], None, U[k], V[k], U[k], V[k], w)[0]
    return out


def _vp8_decode_alpha(data: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk -> alpha [h, w] uint8 (alpha_dec.c: VP8L's green
    channel or raw bytes, then the row filter undone)."""
    if not data:
        raise ValueError("WebP: truncated alpha")
    head = data[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        if len(data) - 1 < w * h:
            raise ValueError("WebP: truncated alpha")
        a = np.frombuffer(data[1:1 + w * h], np.uint8).reshape(h, w).astype(np.int64)
    elif method == 1:
        br = _LsbBits(data[1:])
        px, transforms, _ = _vp8l_image(br, w, h, True)
        argb = _vp8l_inverse(px, transforms, h)
        a = ((argb >> 8) & 255).astype(np.int64)
    else:
        raise ValueError("WebP: unknown alpha compression")
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        prev = out[y - 1] if y > 0 else None
        row = a[y]
        if filt == 0:
            out[y] = row
        elif filt == 1 or prev is None:
            pred = 0 if prev is None else int(prev[0])
            for x in range(w):
                pred = (pred + int(row[x])) & 255
                out[y, x] = pred
        elif filt == 2:
            out[y] = (prev + row) & 255
        else:
            top_left = left = int(prev[0])
            for x in range(w):
                top = int(prev[x])
                g = left + top - top_left
                g = g if 0 <= g <= 255 else (0 if g < 0 else 255)
                left = (int(row[x]) + g) & 255
                top_left = top
                out[y, x] = left
    return out.astype(np.uint8)
