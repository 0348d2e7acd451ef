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


def jpeg_color_bytes(rgb: np.ndarray, factors, quality: int = 75, planes=None,
                     adobe=None) -> bytes:
    """[H, W, 3] uint8 RGB -> a baseline JFIF JPEG whose components have the
    sampling factors ``factors`` ((h, v) per component; box-averaged
    chroma, float DCT).  With ``planes`` [H, W, N] the components are those
    samples as they are (``rgb`` unused); with ``adobe`` an Adobe APP14
    marker of that transform replaces the JFIF one (N = 4: CMYK for 0, YCCK
    for 2)."""
    if planes is None:
        x = rgb.astype(np.float64)
        ycc = np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                        128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
                        128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]],
                       -1)
    else:
        ycc = np.asarray(planes, np.float64)
    h_img, w_img, n_comp = ycc.shape
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
    bits, last = [], [0] * n_comp

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
    app = (seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") if adobe is None
           else seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)))
    return (b"\xff\xd8" + app
            + seg(0xDB, b"\x00" + bytes(int(v) for v in q[zz]))
            + seg(0xC0, struct.pack(">BHHB", 8, h_img, w_img, n_comp) + comps)
            + seg(0xC4, b"\x00" + bytes(_DC_BITS) + bytes(_DC_VALS))
            + seg(0xC4, b"\x10" + bytes(_AC_BITS) + _AC_VALS)
            + seg(0xDA, bytes([n_comp]) + b"".join(bytes([i + 1, 0x00]) for i in range(n_comp))
                  + b"\x00\x3f\x00")
            + bytes(data) + b"\xff\xd9")


# ---- TIFF ----------------------------------------------------------------------

def lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW (libtiff's encoder): MSB-first codes, 9 to 12 bits, the width
    growing one code early, a clear code first and before the table fills."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = reset()
    put(256, width)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt >= 4093:
            put(256, width)
            table, nxt, width = reset()
        elif nxt >= 1 << width:
            width += 1
        w = bytes([byte])
    if w:
        put(table[w], width)
        nxt += 1
        if nxt >= 1 << width and width < 12:
            width += 1
    put(257, width)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeat packets, the rest as
    literal packets (both at most 128 bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_rows(samples: np.ndarray, bps: int, order: str, predictor: int) -> np.ndarray:
    """[rows, cols, n] samples -> [rows, bytes] as stored (predictor applied)."""
    rows, cols, n = samples.shape
    flat = samples.reshape(rows, cols * n)
    if predictor == 3:                         # floating point: MSB-first byte planes
        u = np.ascontiguousarray(flat, np.float32).view(np.uint32).astype(np.int64)
        planes = np.concatenate([(u >> s) & 0xFF for s in (24, 16, 8, 0)], axis=1)
        diff = planes.copy()
        diff[:, n:] = planes[:, n:] - planes[:, :-n]
        return (diff & 0xFF).astype(np.uint8)
    if bps == 32 and flat.dtype == np.float32:
        flat = flat.view(np.uint32)
    v = flat.astype(np.int64) & ((1 << bps) - 1)
    if predictor == 2:
        d = v.copy()
        d[:, n:] = v[:, n:] - v[:, :-n]
        v = d & ((1 << bps) - 1)
    if bps >= 8:
        return v.astype(f"{order}u{bps // 8}").view(np.uint8).reshape(rows, -1)
    bits = ((v[:, :, None] >> np.arange(bps - 1, -1, -1)) & 1).reshape(rows, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def zstd_frame(level: int = 3, checksum: bool = False, skippable: bytes = b"",
               content_size: bool = True):
    """A chunk compressor writing one Zstandard frame (the ``zstandard``
    package, libzstd's encoder) at ``level``, with the XXH64 content
    checksum or without, the content size or not, and a skippable frame
    holding ``skippable`` after it when that is not empty."""
    import zstandard

    def compress(data: bytes) -> bytes:
        frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                         write_content_size=content_size).compress(data)
        if skippable:
            frame += struct.pack("<II", 0x184D2A5E, len(skippable)) + skippable
        return frame
    return compress


def zstd_match_frame(window_log: int, matches: int, extra: int = 65535,
                     content_size: int = None) -> bytes:
    """A Zstandard frame of one compressed block: ``matches`` sequences of
    one raw literal and a match of 65539 + ``extra`` bytes at offset 1 (the
    literal repeated; RLE tables, so the bitstream is the extra bits), in a
    window of 2**``window_log`` bytes, with a 4-byte content size or none."""
    assert matches < 128
    block = (bytes([(matches & 15) << 4 | 4, matches >> 4]) + bytes(range(1, matches + 1))
             + bytes([matches, 0x54, 1, 0, 52]))
    bits = 1 << 16 * matches
    for i in range(matches):
        bits |= extra << 16 * (matches - 1 - i)
    block += bits.to_bytes(2 * matches + 1, "little")
    head = bytes([0x28, 0xB5, 0x2F, 0xFD, 0 if content_size is None else 0x80,
                  (window_log - 10) << 3])
    if content_size is not None:
        head += struct.pack("<I", content_size)
    return head + ((len(block) << 3) | 5).to_bytes(3, "little") + block


def tiff_bytes(samples: np.ndarray, bps: int, photometric: int, sample_format: int = 1,
               extra=(), compression: int = 1, predictor: int = 1, planar: int = 1,
               tile=None, rows_per_strip=None, big_endian: bool = False, colormap=None,
               tags=(), codec=None) -> bytes:
    """A one-image TIFF of ``samples`` [H, W, N] (ints, or float32 for sample
    format 3): strips of ``rows_per_strip`` rows or ``tile`` = (width,
    length) tiles, planar configuration 1 or 2, compression 1 / 5 (LZW) /
    8 or 32946 (Deflate) / 32773 (PackBits) / 50000 (ZSTD, by ``codec`` or
    ``zstd_frame()``), predictor 1 / 2 / 3, either byte order; ``colormap``
    [3, 2**bps] for palette files; ``tags`` extra (tag, type, values)
    entries; ``codec`` compresses each chunk in place of the compression's
    own."""
    e = ">" if big_endian else "<"
    h, w, n = samples.shape
    compress = codec or {1: bytes, 5: lzw_tiff, 8: lambda d: zlib.compress(d, 6),
                         32946: lambda d: zlib.compress(d, 9), 32773: packbits,
                         50000: zstd_frame()}[compression]
    planes = [samples[:, :, k:k + 1] for k in range(n)] if planar == 2 else [samples]
    chunks = []
    if tile:
        tw, tl = tile
        for plane in planes:
            padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw, plane.shape[2]), plane.dtype)
            padded[:h, :w] = plane
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    chunks.append(compress(_tiff_rows(padded[y:y + tl, x:x + tw], bps, e,
                                                      predictor).tobytes()))
    else:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                chunks.append(compress(_tiff_rows(plane[y:y + rps], bps, e, predictor).tobytes()))
    entries = [(258, 3, [bps] * n), (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [n]), (284, 3, [planar])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if sample_format != 1:
        entries.append((339, 3, [sample_format] * n))
    if extra:
        entries.append((338, 3, list(extra)))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap).reshape(-1))))
    return tiff_chunks_bytes(w, h, chunks, entries + list(tags), big_endian=big_endian, tile=tile,
                             rows_per_strip=rows_per_strip)


# ---- GIF -----------------------------------------------------------------------

def lzw_gif(indices, bits: int) -> bytes:
    """GIF LZW of palette indices: LSB-first codes, a clear code first and
    when the table fills, the width growing when the next code needs it."""
    clear, out, acc, nacc = 1 << bits, bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc, nacc = acc | code << nacc, nacc + width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc, nacc = acc >> 8, nacc - 8

    width, nxt, table = bits + 1, clear + 2, {}
    put(clear, width)
    prefix = None
    for c in map(int, indices):
        if prefix is None:
            prefix = c
            continue
        if (prefix, c) in table:
            prefix = table[(prefix, c)]
            continue
        put(prefix, width)
        if nxt >= 4096:
            put(clear, width)
            width, nxt, table = bits + 1, clear + 2, {}
        else:
            table[(prefix, c)] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        prefix = c
    if prefix is not None:
        put(prefix, width)
        nxt += 1
        if nxt > 1 << width and width < 12:
            width += 1
    put(clear + 1, width)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_bytes(frames, screen, global_palette=None, version=b"GIF89a") -> bytes:
    """A GIF of ``frames``: dicts with ``indices`` [h, w], ``offset`` (x, y),
    and optionally ``palette`` (a local colour table, [2**k, 3]),
    ``interlace``, ``transparency`` (an index: a graphic control extension)
    and ``bits`` (the LZW code size, default 8)."""
    def table(p):
        p = np.asarray(p, np.uint8).reshape(-1, 3)
        k = max(1, int(np.ceil(np.log2(len(p)))))
        full = np.zeros((1 << k, 3), np.uint8)
        full[:len(p)] = p
        return k - 1, full.tobytes()

    flags, gtable = 0, b""
    if global_palette is not None:
        size, gtable = table(global_palette)
        flags = 128 | size
    out = bytearray(version + struct.pack("<HHBBB", screen[0], screen[1], flags, 0, 0) + gtable)
    for fr in frames:
        idx = np.asarray(fr["indices"])
        h, w = idx.shape
        if fr.get("transparency") is not None:
            out += b"!\xf9\x04" + bytes([1, 0, 0, fr["transparency"], 0])
        lflags, ltable = 0, b""
        if fr.get("palette") is not None:
            size, ltable = table(fr["palette"])
            lflags = 128 | size
        rows = list(range(h))
        if fr.get("interlace"):
            lflags |= 64
            rows = [y for s, d in ((0, 8), (4, 8), (2, 4), (1, 2)) for y in range(s, h, d)]
        x0, y0 = fr.get("offset", (0, 0))
        bits = fr.get("bits", 8)
        out += b"," + struct.pack("<HHHHB", x0, y0, w, h, lflags) + ltable + bytes([bits])
        out += _blocks(lzw_gif(idx[rows].reshape(-1), bits))
    return bytes(out + b";")


# ---- BMP -----------------------------------------------------------------------

def rle_bmp(indices: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4 of [h, w] palette indices, rows bottom-up: encoded runs,
    absolute runs (padded to 16 bits), a delta over each row's first two
    pixels when they are 0, end of line and end of bitmap."""
    out = bytearray()
    for row in indices[::-1]:
        row = [int(v) for v in row]
        x, w = 0, len(row)
        if w > 2 and row[0] == row[1] == 0:
            out += bytes([0, 2, 2, 0])
            x = 2
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                out += bytes([run if not rle4 else min(run, 255),
                              row[x] if not rle4 else (row[x] << 4) | row[x]])
                x += run
                continue
            n = 3
            while x + n < w and n < 254 and not (x + n + 2 < w and row[x + n] == row[x + n + 1]
                                                 == row[x + n + 2]):
                n += 1
            if rle4:
                n -= n % 2
                vals = row[x:x + n]
                body = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
            else:
                body = bytes(row[x:x + n])
            out += bytes([0, n]) + body + (b"\0" if len(body) % 2 else b"")
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_bytes(pixels: np.ndarray, bits: int, header: int = 40, compression: int = 0,
              palette=None, masks=None, top_down: bool = False, colors_field=None) -> bytes:
    """A BMP of ``pixels``: palette indices [h, w] for 1/4/8 bits (``palette``
    [n, 3] RGB), RGB [h, w, 3] for 16 (5-5-5, or the ``masks`` given), 24
    and 32 bits (``masks`` (R, G, B, A) bit fields for compression 3); an
    OS/2 (12-byte) or a Windows header of ``header`` bytes; compression 1 /
    2 for RLE8 / RLE4."""
    h, w = pixels.shape[:2]
    pad = 3 if header == 12 else 4
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if pad == 4:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if compression in (1, 2):
        data = rle_bmp(pixels, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        rows = pixels if top_down else pixels[::-1]
        if bits <= 8:
            bitsarr = ((rows[:, :, None].astype(np.int64) >> np.arange(bits - 1, -1, -1)) & 1)
            packed = np.packbits(bitsarr.reshape(h, -1).astype(np.uint8), axis=1)
        elif bits == 16:
            r, g, b = (rows[..., k].astype(np.int64) for k in range(3))
            if masks and masks[0] == 0xF800:
                v = (r >> 3) << 11 | (g >> 2) << 5 | (b >> 3)
            else:
                v = (r >> 3) << 10 | (g >> 3) << 5 | (b >> 3)
            packed = v.astype("<u2").view(np.uint8).reshape(h, -1)
        elif bits == 24:
            packed = np.ascontiguousarray(rows[:, :, ::-1]).reshape(h, -1)
        else:
            m = masks or (0xFF0000, 0xFF00, 0xFF, 0)
            v = np.zeros((h, w), np.int64)
            for k in range(4):
                if m[k]:
                    shift = (m[k] & -m[k]).bit_length() - 1
                    v |= rows[..., k].astype(np.int64) << shift
            packed = v.astype("<u4").view(np.uint8).reshape(h, -1)
        data = np.zeros((h, stride), np.uint8)
        data[:, :packed.shape[1]] = packed
        data = data.tobytes()
    n_colors = len(pal) // pad
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835,
                           n_colors if colors_field is None else colors_field, 0)
        extra = b""
        if compression == 3:
            fields = struct.pack("<4I", *(tuple(masks) + (0,) * (4 - len(masks))))
            if header >= 52:
                info += fields[:16 if header >= 56 else 12]
            else:
                extra = fields[:12]
        info += bytes(header - len(info))
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + extra
            + pal + data)


def jpeg_lossless_bytes(samples: np.ndarray, predictor: int = 1, pt: int = 0,
                        interleave: bool = True, adobe=None) -> bytes:
    """[H, W, N] uint8 -> a lossless (SOF3) Huffman JPEG: predictor 1-7,
    point transform ``pt``, the components in one interleaved scan or one
    scan each; JFIF, or an Adobe marker of transform ``adobe``."""
    h, w, n = samples.shape
    bits_table = [0, 0, 0, 0, 17] + [0] * 11           # 17 codes of 5 bits: SSSS 0..16
    codes = _codes(bits_table, list(range(17)))

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    def diffs(plane):
        v = plane.astype(np.int64) >> pt
        out = np.zeros_like(v)
        for y in range(h):
            for x in range(w):
                if y == 0:
                    pred = (1 << (8 - pt - 1)) if x == 0 else v[y, x - 1]
                elif x == 0:
                    pred = v[y - 1, x]
                else:
                    ra, rb, rc = v[y, x - 1], v[y - 1, x], v[y - 1, x - 1]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                out[y, x] = ((v[y, x] - pred + 32768) & 0xFFFF) - 32768
        return out

    def scan(comp_ids, d):
        stream = []
        for y in range(h):
            for x in range(w):
                for ci in comp_ids:
                    v = int(d[ci][y, x])
                    size = 16 if v == -32768 else abs(v).bit_length()
                    code, length = codes[size]
                    stream.append(format(code, f"0{length}b"))
                    if 0 < size < 16:
                        stream.append(format(v if v >= 0 else v + (1 << size) - 1, f"0{size}b"))
        s = "".join(stream)
        s += "1" * (-len(s) % 8)
        data = bytearray()
        for i in range(0, len(s), 8):
            b = int(s[i:i + 8], 2)
            data += bytes([b, 0]) if b == 0xFF else bytes([b])
        sos = seg(0xDA, bytes([len(comp_ids)]) + b"".join(bytes([c + 1, 0x00]) for c in comp_ids)
                  + bytes([predictor, 0, pt]))
        return sos + bytes(data)

    d = [diffs(samples[:, :, c]) for c in range(n)]
    scans = scan(list(range(n)), d) if interleave else b"".join(scan([c], d) for c in range(n))
    app = (seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") if adobe is None
           else seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)))
    comps = b"".join(bytes([c + 1, 0x11, 0]) for c in range(n))
    return (b"\xff\xd8" + app + seg(0xC3, struct.pack(">BHHB", 8, h, w, n) + comps)
            + seg(0xC4, b"\x00" + bytes(bits_table) + bytes(range(17))) + scans + b"\xff\xd9")


# ---- arithmetic-coded JPEG (jcarith.c) ----------------------------------------

def _aritab():
    import srrg2_proslam_tpu_torch.io.images_plain as plain
    return plain._ARITAB


class _ArithEncoder:
    """jcarith.c's arith_encode and its termination."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct, self.sc, self.zc, self.buffer = 0, 0x10000, 11, 0, 0, -1
        self.tab = _aritab()

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nm, nl, sw = self.tab[sv & 0x7F]
        nl |= sw << 7
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _shift(v: int, al: int) -> int:
    """A coefficient's point transform: its magnitude shifted, toward 0."""
    return (v >> al) if v >= 0 else -((-v) >> al)


def jpeg_arith_bytes(samples: np.ndarray, factors, quality: int = 75, progressive=False,
                     restart_mcus: int = 0, dac=None) -> bytes:
    """[H, W, N] uint8 component samples (1 gray, 3 YCbCr under JFIF) -> an
    arithmetic-coded JPEG: sequential (SOF9) or progressive (SOF10: DC first
    at Al 1, AC 1-5 and 6-63 first at Al 1, DC and AC refinements at Al 0);
    ``restart_mcus`` > 0 puts a restart marker every that many MCUs; ``dac``
    {(class, table): value} writes a DAC conditioning segment."""
    h_img, w_img, n = samples.shape
    x = samples.astype(np.float64)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = np.clip((_LUM_Q * scale + 50) // 100, 1, 255)
    nn = np.arange(8)
    basis = np.cos((2 * nn[None, :] + 1) * nn[:, None] * np.pi / 16) * np.where(
        nn[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    zz = _zigzag()
    coef = []                                   # per component: {(by, bx): zigzag ints}
    for ci, (fh, fv) in enumerate(factors):
        sx, sy = hmax // fh, vmax // fv
        pw, ph = mcux * 8 * hmax, mcuy * 8 * vmax
        full = np.pad(x[..., ci], ((0, ph - h_img), (0, pw - w_img)), mode="edge")
        plane = full.reshape(ph // sy, sy, pw // sx, sx).mean(axis=(1, 3))
        blocks = {}
        for by in range(plane.shape[0] // 8):
            for bx in range(plane.shape[1] // 8):
                blk = plane[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] - 128
                c = np.round(basis @ blk @ basis.T / q.reshape(8, 8)).astype(int)
                blocks[(by, bx)] = [int(v) for v in c.reshape(-1)[zz]]
        coef.append(blocks)
    dac = dac or {}
    dc_l = [dac.get((0, t), 0x10) & 15 for t in range(4)]
    dc_u = [dac.get((0, t), 0x10) >> 4 for t in range(4)]
    ac_k = [dac.get((1, t), 5) for t in range(4)]

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    def blocks_of_scan(comps):
        """Each MCU's blocks (component, (by, bx)) in scan order."""
        if len(comps) == 1:
            ci = comps[0]
            fh, fv = factors[ci]
            wib = -(-(-(-w_img * fh // hmax)) // 8)
            hib = -(-(-(-h_img * fv // vmax)) // 8)
            return [[(ci, (by, bx))] for by in range(hib) for bx in range(wib)]
        return [[(ci, (my * factors[ci][1] + v, mx * factors[ci][0] + u))
                 for ci in comps for v in range(factors[ci][1]) for u in range(factors[ci][0])]
                for my in range(mcuy) for mx in range(mcux)]

    def scan(comps, ss, se, ah, al):
        mcus = blocks_of_scan(comps)
        out, enc = bytearray(), None
        dc_stats, ac_stats, last, ctx = {}, {}, {}, {}
        fixed = [113]
        for i, mcu in enumerate(mcus):
            if restart_mcus and i % restart_mcus == 0 and i:
                out += enc.finish() + bytes([0xFF, 0xD0 + (i // restart_mcus - 1) % 8])
                enc = None
            if enc is None:
                enc = _ArithEncoder()
                dc_stats = {0: [0] * 64}
                ac_stats = {0: [0] * 256}
                last = {ci: 0 for ci in comps}
                ctx = {ci: 0 for ci in comps}
            for ci, key in mcu:
                zzc = coef[ci][key]
                if ss == 0 and ah == 0:                      # DC (sequential or first)
                    v0 = zzc[0] >> al
                    diff, st0 = v0 - last[ci], ctx[ci]
                    stats = dc_stats[0]
                    if diff == 0:
                        enc.encode(stats, st0, 0)
                        ctx[ci] = 0
                    else:
                        last[ci] = v0
                        enc.encode(stats, st0, 1)
                        if diff > 0:
                            enc.encode(stats, st0 + 1, 0)
                            st, ctx[ci], v = st0 + 2, 4, diff
                        else:
                            enc.encode(stats, st0 + 1, 1)
                            st, ctx[ci], v = st0 + 3, 8, -diff
                        m, v = 0, v - 1
                        if v:
                            enc.encode(stats, st, 1)
                            m, v2, st = 1, v, 20
                            v2 >>= 1
                            while v2:
                                enc.encode(stats, st, 1)
                                m <<= 1
                                st += 1
                                v2 >>= 1
                        enc.encode(stats, st, 0)
                        if m < (1 << dc_l[0]) >> 1:
                            ctx[ci] = 0
                        elif m > (1 << dc_u[0]) >> 1:
                            ctx[ci] += 8
                        st += 14
                        m >>= 1
                        while m:
                            enc.encode(stats, st, 1 if m & v else 0)
                            m >>= 1
                    if progressive:
                        continue
                if ss == 0 and ah:                           # DC refinement
                    enc.encode(fixed, 0, (zzc[0] >> al) & 1)
                    continue
                lo, hi = (1, 63) if not progressive else (ss, se)
                stats = ac_stats[0]
                vals = [_shift(v, al) for v in zzc]
                ke = hi
                while ke > 0 and ke >= lo and not vals[ke]:
                    ke -= 1
                if ah == 0:                                  # sequential / AC first
                    k = lo
                    while k <= ke:
                        st = 3 * (k - 1)
                        enc.encode(stats, st, 0)
                        while not vals[k]:
                            enc.encode(stats, st + 1, 0)
                            st += 3
                            k += 1
                        v = vals[k]
                        enc.encode(stats, st + 1, 1)
                        enc.encode(fixed, 0, 0 if v > 0 else 1)
                        v = abs(v)
                        st += 2
                        m, v = 0, v - 1
                        if v:
                            enc.encode(stats, st, 1)
                            m, v2 = 1, v >> 1
                            if v2:
                                enc.encode(stats, st, 1)
                                m <<= 1
                                st = 189 if k <= ac_k[0] else 217
                                v2 >>= 1
                                while v2:
                                    enc.encode(stats, st, 1)
                                    m <<= 1
                                    st += 1
                                    v2 >>= 1
                        enc.encode(stats, st, 0)
                        st += 14
                        m >>= 1
                        while m:
                            enc.encode(stats, st, 1 if m & v else 0)
                            m >>= 1
                        k += 1
                    if k <= hi:
                        enc.encode(stats, 3 * (k - 1), 1)
                else:                                        # AC refinement
                    prev = [_shift(v, ah) for v in zzc]
                    kex = ke
                    while kex > 0 and not prev[kex]:
                        kex -= 1
                    k = lo
                    while k <= ke:
                        st = 3 * (k - 1)
                        if k > kex:
                            enc.encode(stats, st, 0)
                        while True:
                            v = abs(vals[k])
                            if v:
                                if v >> 1:
                                    enc.encode(stats, st + 2, v & 1)
                                else:
                                    enc.encode(stats, st + 1, 1)
                                    enc.encode(fixed, 0, 0 if vals[k] > 0 else 1)
                                break
                            enc.encode(stats, st + 1, 0)
                            st += 3
                            k += 1
                        k += 1
                    if k <= hi:
                        enc.encode(stats, 3 * (k - 1), 1)
        out += enc.finish()
        sos = seg(0xDA, bytes([len(comps)]) + b"".join(bytes([ci + 1, 0x00]) for ci in comps)
                  + bytes([ss, se, (ah << 4) | al]))
        return sos + bytes(out)

    if progressive:
        scans = [scan(list(range(n)), 0, 0, 0, 1)]
        scans += [scan([ci], 1, 5, 0, 1) for ci in range(n)]
        scans += [scan([ci], 6, 63, 0, 1) for ci in range(n)]
        scans += [scan(list(range(n)), 0, 0, 1, 0)]
        scans += [scan([ci], 1, 63, 1, 0) for ci in range(n)]
    else:
        scans = [scan(list(range(n)), 0, 63, 0, 0)]
    comps = b"".join(bytes([i + 1, (fh << 4) | fv, 0]) for i, (fh, fv) in enumerate(factors))
    head = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    head += seg(0xDB, b"\x00" + bytes(int(v) for v in q[zz]))
    head += seg(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, h_img, w_img, n) + comps)
    if dac:
        head += seg(0xCC, b"".join(bytes([(c << 4) | t, v]) for (c, t), v in dac.items()))
    if restart_mcus:
        head += seg(0xDD, struct.pack(">H", restart_mcus))
    return head + b"".join(scans) + b"\xff\xd9"


# ---- TIFF: old-style LZW, YCbCr data units, JPEG strips, BigTIFF ----------------

def lzw_tiff_compat(data: bytes) -> bytes:
    """Old-style TIFF LZW (libtiff's LZWDecodeCompat): LSB-first codes, 9 to
    12 bits, the width growing when the next code reaches it, a clear code
    first and before the table fills."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = reset()
    put(256, width)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt >= 4094:
            put(256, width)
            table, nxt, width = reset()
        elif nxt > 1 << width:
            width += 1
        w = bytes([byte])
    if w:
        put(table[w], width)
        nxt += 1
        if nxt > 1 << width and width < 12:
            width += 1
    put(257, width)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def ycbcr_units(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> bytes:
    """YCbCr samples -> TIFF data units: per hs x vs block its luma samples
    (zeros past the image), then Cb and Cr; ``cb`` / ``cr`` hold one sample
    a block."""
    h, w = y.shape
    out = bytearray()
    for by in range(0, h, vs):
        for bx in range(0, w, hs):
            for yy in range(vs):
                for xx in range(hs):
                    inside = by + yy < h and bx + xx < w
                    out.append(int(y[by + yy, bx + xx]) if inside else 0)
            out += bytes([int(cb[by // vs, bx // hs]), int(cr[by // vs, bx // hs])])
    return bytes(out)


def tiff_chunks_bytes(width: int, height: int, chunks, entries, big_endian: bool = False,
                      tile=None, rows_per_strip=None, bigtiff: bool = False) -> bytes:
    """A one-image (Big)TIFF from already coded strips or tiles and the
    other tags ((tag, type, values); type 3 SHORT, 4 LONG, 5 RATIONAL as
    (numerator, denominator) pairs, 7 UNDEFINED as bytes)."""
    e = ">" if big_endian else "<"
    head = (b"MM\0+" if big_endian else b"II+\0") + struct.pack(e + "HH", 8, 0) if bigtiff \
        else (b"MM\0*" if big_endian else b"II*\0")
    data = bytearray(head) + bytes(8 if bigtiff else 4)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    counts = [len(c) for c in chunks]
    entries = [(256, 4, [width]), (257, 4, [height])] + list(entries)
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, offsets),
                    (325, 4, counts)]
    else:
        entries += [(273, 4, offsets), (278, 4, [rows_per_strip or height]), (279, 4, counts)]
    entries.sort(key=lambda t: t[0])
    ifd = len(data)
    if bigtiff:
        data[8:16] = struct.pack(e + "Q", ifd)
    else:
        data[4:8] = struct.pack(e + "I", ifd)
    inline, entry_size = (8, 20) if bigtiff else (4, 12)
    body = bytearray(struct.pack(e + ("Q" if bigtiff else "H"), len(entries)))
    spill = bytearray()
    spill_at = ifd + (8 if bigtiff else 2) + entry_size * len(entries) + inline
    for tag, kind, values in entries:
        if kind == 7:
            raw, count = bytes(values), len(values)
        elif kind == 5:
            raw, count = b"".join(struct.pack(e + "II", *v) for v in values), len(values)
        else:
            raw, count = struct.pack(f"{e}{len(values)}{'H' if kind == 3 else 'I'}", *values), \
                len(values)
        if len(raw) <= inline:
            value = raw + bytes(inline - len(raw))
        else:
            value = struct.pack(e + ("Q" if bigtiff else "I"), spill_at + len(spill))
            spill += raw
            if len(spill) % 2:
                spill += b"\0"
        body += struct.pack(e + ("HHQ" if bigtiff else "HHI"), tag, kind, count) + value
    return bytes(data + body + bytes(inline) + spill)


def split_jpeg_tables(jpeg: bytes):
    """A JPEG -> (JPEGTables: SOI, its DQT and DHT segments, EOI; the stream
    without them), as libtiff's JPEG codec stores a strip."""
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        if marker == 0xDA:
            rest += jpeg[pos:]
            break
        length = struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        seg = jpeg[pos:pos + 2 + length]
        (tables if marker in (0xDB, 0xC4) else rest).extend(seg)
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(rest)


# ---- JPEG 2000: PIL's codestreams rewritten, JP2 boxes ------------------------------

def j2k_segments(cs: bytes):
    """A codestream -> (main header [(marker, body)], tile-parts [[SOT body,
    [(marker, body)], data]]); SOC and EOC are implied."""
    def header(pos, stop):
        segs = []
        while int.from_bytes(cs[pos:pos + 2], "big") != stop:
            marker, length = struct.unpack(">HH", cs[pos:pos + 4])
            segs.append((marker, cs[pos + 4:pos + 2 + length]))
            pos += 2 + length
        return segs, pos

    main, pos = header(2, 0xFF90)
    parts = []
    while int.from_bytes(cs[pos:pos + 2], "big") == 0xFF90:
        sot = cs[pos + 4:pos + 12]
        psot = int.from_bytes(sot[2:6], "big")
        end = pos + psot if psot else len(cs) - 2
        head, body = header(pos + 12, 0xFF93)
        parts.append([sot, head, cs[body + 2:end]])
        pos = end
    return main, parts


def j2k_join(main, parts) -> bytes:
    """``j2k_segments``' parts -> a codestream, each Psot recomputed."""
    def segs(items):
        return b"".join(struct.pack(">HH", m, len(body) + 2) + body for m, body in items)

    out = b"\xff\x4f" + segs(main)
    for sot, head, data in parts:
        rest = segs(head) + b"\xff\x93" + data
        out += (b"\xff\x90\x00\x0a" + sot[:2] + struct.pack(">I", 12 + len(rest)) + sot[6:8]
                + rest)
    return out + b"\xff\xd9"


def _plt_lengths(head) -> list:
    """The packet lengths in a tile-part header's PLT segments."""
    lengths = []
    for m, body in head:
        if m == 0xFF58:
            value = 0
            for byte in body[1:]:
                value = (value << 7) | (byte & 0x7F)
                if not byte & 0x80:
                    lengths.append(value)
                    value = 0
    return lengths


class _HeaderBits:
    """Packet-header bits (T.800 B.10.1): a byte after 0xFF gives seven."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.byte, self.left = data, pos, 0, 0

    def bit(self) -> int:
        if not self.left:
            self.left = 7 if self.byte == 0xFF else 8
            self.byte = self.data[self.pos]
            self.pos += 1
        self.left -= 1
        return (self.byte >> self.left) & 1

    def bits(self, n: int) -> int:
        return sum(self.bit() << k for k in range(n - 1, -1, -1))

    def passes(self) -> int:
        if not self.bit():
            return 1
        if not self.bit():
            return 2
        n = self.bits(2)
        if n < 3:
            return 3 + n
        n = self.bits(5)
        return 6 + n if n < 31 else 37 + self.bits(7)

    def end(self) -> int:
        """Where the header ends: past a stuffed byte after a last 0xFF."""
        return self.pos + (self.byte == 0xFF)


class _TagTreeReader:
    """A tag tree over w x h leaves (T.800 B.10.2)."""

    def __init__(self, w: int, h: int):
        self.widths = [w]
        while w * h > 1:
            w, h = (w + 1) // 2, (h + 1) // 2
            self.widths.append(w)
        self.value = [{} for _ in self.widths]
        self.low = [{} for _ in self.widths]

    def below(self, bits: _HeaderBits, leaf: int, t: int) -> bool:
        """Whether the leaf's value is below ``t``, reading the bits that says."""
        x, y = leaf % self.widths[0], leaf // self.widths[0]
        low = 0
        for k in range(len(self.widths) - 1, -1, -1):
            node = (y >> k) * self.widths[k] + (x >> k)
            low = max(low, self.low[k].get(node, 0))
            while low < t and low < self.value[k].get(node, t):
                if bits.bit():
                    self.value[k][node] = low
                else:
                    low += 1
            self.low[k][node] = low
        return self.value[0].get(leaf, t) < t


def j2k_packet_spans(cs: bytes) -> dict:
    """A codestream of one tile-part per tile, LRCP, no POC, no subsampling
    -> {tile: its packets as (header start, header end, body end) in its
    data}.  Each header is read (T.800 B.10: inclusion and zero bit-planes
    from tag trees, pass counts, lengths) to its end, the body is the
    code-blocks' lengths after it, and an SOP marker ahead of a packet is
    skipped.  Where PIL wrote PLT markers, each packet's length is checked
    against them."""
    main, parts = j2k_segments(cs)
    seg = dict(main)
    xsiz, ysiz, xo, yo, xt, yt, xto, yto = struct.unpack(">8I", seg[0xFF51][2:34])
    ncomp, cod = int.from_bytes(seg[0xFF51][34:36], "big"), seg[0xFF52]
    assert cod[1] == 0 and 0xFF5F not in seg and all(
        seg[0xFF51][37 + 3 * c:39 + 3 * c] == b"\1\1" for c in range(ncomp))
    layers, levels, xcb, ycb = int.from_bytes(cod[2:4], "big"), cod[5], cod[6] + 2, cod[7] + 2
    exps = [(b & 15, b >> 4) for b in cod[10:]] if cod[0] & 1 else [(15, 15)] * (levels + 1)

    def precincts(rect, r):
        """Resolution r's precincts: each one's (code-blocks across, down)
        in each non-empty band."""
        lev, (ex, ey) = levels - r, exps[r]
        rx0, ry0, rx1, ry1 = (-(-v // (1 << lev)) for v in rect)
        if rx0 == rx1 or ry0 == ry1:
            return []
        pw, ph = -(-rx1 // (1 << ex)) - (rx0 >> ex), -(-ry1 // (1 << ey)) - (ry0 >> ey)
        gx, gy = (rx0 >> ex) << ex, (ry0 >> ey) << ey
        bands = [((rx0, ry0, rx1, ry1), gx, gy, ex, ey)] if r == 0 else [
            (tuple(-(-(v - (o << lev)) // (2 << lev)) for v, o in zip(rect, (b & 1, b >> 1) * 2)),
             gx >> 1, gy >> 1, ex - 1, ey - 1) for b in (1, 2, 3)]
        out = []
        for k in range(pw * ph):
            grids = []
            for (bx0, by0, bx1, by1), ox, oy, bex, bey in bands:
                if bx0 >= bx1 or by0 >= by1:
                    continue
                px0, px1 = max(ox + (k % pw << bex), bx0), min(ox + (k % pw + 1 << bex), bx1)
                py0, py1 = max(oy + (k // pw << bey), by0), min(oy + (k // pw + 1 << bey), by1)
                cx, cy = min(xcb, bex), min(ycb, bey)
                empty = px0 >= px1 or py0 >= py1
                grids.append((0, 0) if empty else (-(-px1 // (1 << cx)) - (px0 >> cx),
                                                   -(-py1 // (1 << cy)) - (py0 >> cy)))
            out.append(grids)
        return out

    spans = {}
    for sot, head, data in parts:
        t = int.from_bytes(sot[:2], "big")
        p, q = t % -(-(xsiz - xto) // xt), t // -(-(xsiz - xto) // xt)
        rect = (max(xto + p * xt, xo), max(yto + q * yt, yo),
                min(xto + (p + 1) * xt, xsiz), min(yto + (q + 1) * yt, ysiz))
        grid = [precincts(rect, r) for r in range(levels + 1)]
        state, pos, spans[t] = {}, 0, []
        for layer, r in ((layer, r) for layer in range(layers) for r in range(levels + 1)):
            for c, (k, bands) in ((c, kb) for c in range(ncomp) for kb in enumerate(grid[r])):
                start = pos + 6 if data[pos:pos + 2] == b"\xff\x91" else pos
                bits, body = _HeaderBits(data, start), 0
                if bits.bit():
                    for b, (cw, ch) in enumerate(bands):
                        incl, zero, lblock = state.setdefault(
                            (r, c, k, b), (_TagTreeReader(cw, ch), _TagTreeReader(cw, ch), {}))
                        for n in range(cw * ch):
                            if not (bits.bit() if n in lblock else incl.below(bits, n, layer + 1)):
                                continue
                            if n not in lblock:
                                i = 1
                                while not zero.below(bits, n, i):
                                    i += 1
                                lblock[n] = 3
                            passes = bits.passes()
                            while bits.bit():
                                lblock[n] += 1
                            body += bits.bits(lblock[n] + passes.bit_length() - 1)
                spans[t].append((start, bits.end(), bits.end() + body))
                pos = bits.end() + body
        lengths = _plt_lengths(head)
        assert not lengths or lengths == [e - s for s, e in zip([0] + [e for *_, e in spans[t]],
                                                                [e for *_, e in spans[t]])]
    return spans


def j2k_with_sop(cs: bytes) -> bytes:
    """A codestream written with PLT markers -> the same packets, each behind
    an SOP marker (COD's Scod bit 1 set, the PLT segments dropped)."""
    main, parts = j2k_segments(cs)
    main = [(m, bytes([body[0] | 2]) + body[1:]) if m == 0xFF52 else (m, body)
            for m, body in main]
    count = {}
    for part in parts:
        lengths = _plt_lengths(part[1])
        data, pos, out = part[2], 0, b""
        tile = part[0][:2]
        for n in lengths:
            seq = count.get(tile, 0)
            count[tile] = seq + 1
            out += b"\xff\x91\x00\x04" + struct.pack(">H", seq & 0xFFFF) + data[pos:pos + n]
            pos += n
        part[1] = [(m, body) for m, body in part[1] if m != 0xFF58]
        part[2] = out + data[pos:]
    return j2k_join(main, parts)


def jp2_bytes(cs: bytes, nc: int, bpc: int, enumcs: int = 17, boxes=(), header_boxes=(),
              colr: bytes = None, long_codestream_box: bool = False,
              codestream_to_end: bool = False) -> bytes:
    """A JP2 file around codestream ``cs``: signature, ftyp, jp2h (ihdr from
    the SIZ, ``nc`` components of ``bpc`` (precision - 1, bit 7 signed),
    colr with ``enumcs`` or the raw ``colr`` body, then ``header_boxes``),
    ``boxes`` [(type, body)] and jp2c (with an XLBox, or of length 0 up to
    the file's end)."""
    def box(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", 8 + len(body)) + kind + body

    xsiz, ysiz, xo, yo = struct.unpack(">IIII", cs[8:24])
    ihdr = struct.pack(">IIHBBBB", ysiz - yo, xsiz - xo, nc, bpc, 7, 0, 0)
    colr = colr if colr is not None else struct.pack(">BBBI", 1, 0, 0, enumcs)
    head = box(b"ihdr", ihdr) + box(b"colr", colr) + b"".join(box(k, b) for k, b in header_boxes)
    if long_codestream_box:
        jp2c = struct.pack(">I", 1) + b"jp2c" + struct.pack(">Q", 16 + len(cs)) + cs
    elif codestream_to_end:
        jp2c = struct.pack(">I", 0) + b"jp2c" + cs
    else:
        jp2c = box(b"jp2c", cs)
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + box(b"jp2h", head)
            + b"".join(box(k, b) for k, b in boxes) + jp2c)


def j2k_with_eph(cs: bytes, spans) -> bytes:
    """A codestream of one tile-part per tile -> the same with an EPH marker
    after every packet header (COD's Scod bit 2 set, the PLT segments
    dropped); ``spans`` as ``j2k_packet_spans`` gives them."""
    main, parts = j2k_segments(cs)
    main = [(m, bytes([body[0] | 4]) + body[1:]) if m == 0xFF52 else (m, body)
            for m, body in main]
    for part in parts:
        part[1] = [(m, body) for m, body in part[1] if m != 0xFF58]
        data, out, pos = part[2], b"", 0
        for start, head_end, end in spans[int.from_bytes(part[0][:2], "big")]:
            out += data[pos:head_end] + b"\xff\x92"
            pos = head_end
        part[2] = out + data[pos:]
    return j2k_join(main, parts)


def j2k_with_packed_headers(cs: bytes, spans, where: str) -> bytes:
    """A codestream of one tile-part per tile -> the same with the packet
    headers moved out of the tile data into PPT segments of each tile-part
    header (``where="ppt"``) or PPM segments of the main header ("ppm"),
    split into segments of at most 1000 bytes (the PLT segments dropped);
    ``spans`` as ``j2k_packet_spans`` gives them."""
    main, parts = j2k_segments(cs)
    ppm = b""
    for part in parts:
        data = part[2]
        spans_t = spans[int.from_bytes(part[0][:2], "big")]
        heads = b"".join(data[start:head_end] for start, head_end, _ in spans_t)
        ends = [0] + [end for _, _, end in spans_t]     # an SOP marker stays with its body
        part[2] = b"".join(data[before:start] + data[head_end:end]
                           for before, (start, head_end, end) in zip(ends, spans_t))
        part[1] = [(m, body) for m, body in part[1] if m != 0xFF58]
        if where == "ppt":
            part[1] += [(0xFF61, bytes([z]) + heads[k:k + 1000])
                        for z, k in enumerate(range(0, len(heads), 1000))]
        else:
            ppm += struct.pack(">I", len(heads)) + heads
    if where == "ppm":
        main += [(0xFF60, bytes([z]) + ppm[k:k + 1000])
                 for z, k in enumerate(range(0, len(ppm), 1000))]
    return j2k_join(main, parts)


def j2k_merged(pieces, factors, geometry) -> bytes:
    """One codestream of single-component codestreams: ``pieces[t][c]`` is
    component c of tile t, written with PLT markers, one tile, one layer,
    one precinct per resolution, LRCP and the same number of resolutions,
    at the tile-component's own offset on its grid.  Component c is
    subsampled by ``factors[c]`` = (XRsiz, YRsiz); ``geometry`` is the
    SIZ's (Xsiz, Ysiz, XOsiz, YOsiz, XTsiz, YTsiz, XTOsiz, YTOsiz).  The COD
    is the first piece's (no colour transform), its QCD and a QCC per later
    component; each tile's packets are interleaved resolution by resolution
    as LRCP orders them."""
    def packets(cs):
        main, (part,) = j2k_segments(cs)
        offsets = np.cumsum([0] + _plt_lengths(part[1]))
        return dict(main), [part[2][a:b] for a, b in zip(offsets[:-1], offsets[1:])]

    tiles = [[packets(cs) for cs in tile] for tile in pieces]
    first = tiles[0][0][0]
    siz = first[0xFF51]
    comps = b"".join(bytes([siz[36], dx, dy]) for dx, dy in factors)
    main = [(0xFF51, siz[:2] + struct.pack(">8IH", *geometry, len(factors)) + comps),
            (0xFF52, first[0xFF52][:4] + b"\0" + first[0xFF52][5:]), (0xFF5C, first[0xFF5C])]
    main += [(0xFF5D, bytes([c]) + tiles[0][c][0][0xFF5C]) for c in range(1, len(factors))]
    parts = [[struct.pack(">HIBB", t, 0, 0, 1), [],
              b"".join(tile[c][1][r] for r in range(len(tile[0][1])) for c in range(len(tile)))]
             for t, tile in enumerate(tiles)]
    return j2k_join(main, parts)


# ---- DDS (DX10) and WebP chunks ------------------------------------------------------

# BC6H's mode field: the two-bit modes 00 and 01, then the five-bit ones (the
# last four of them reserved)
BC6H_MODE_BITS = [0b00, 0b01] + [0b00010 | k << 2 for k in range(8)] + [
    0b00011 | k << 2 for k in range(8)]


def dds_dx10_bytes(w: int, h: int, dxgi: int, data: bytes) -> bytes:
    """A DDS file with a DX10 header of format ``dxgi`` around ``data``."""
    return (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
            + struct.pack("<4I", 32, 4, int.from_bytes(b"DX10", "little"), 0) + bytes(16)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0) + struct.pack("<5I", dxgi, 3, 0, 0, 1)
            + data)


def bc6h_blocks(count: int, seed: int) -> bytes:
    """``count`` random BC6H blocks, block i of mode BC6H_MODE_BITS[i % 18]."""
    blocks = bytearray(np.random.default_rng(seed).integers(0, 256, 16 * count)
                       .astype(np.uint8).tobytes())
    for i in range(count):
        bits = BC6H_MODE_BITS[i % len(BC6H_MODE_BITS)]
        keep = ~3 if bits < 2 else ~31
        blocks[16 * i] = (blocks[16 * i] & keep & 0xFF) | bits
    return bytes(blocks)


def webp_chunks(blob: bytes) -> list:
    """A RIFF WebP file -> [[fourcc, payload], ...] (top-level chunks)."""
    pos, out = 12, []
    while pos + 8 <= len(blob):
        size = int.from_bytes(blob[pos + 4:pos + 8], "little")
        out.append([blob[pos:pos + 4], blob[pos + 8:pos + 8 + size]])
        pos += 8 + size + (size & 1)
    return out


def webp_bytes(chunks) -> bytes:
    """[[fourcc, payload], ...] -> a RIFF WebP file (each chunk padded)."""
    body = b"WEBP" + b"".join(name + struct.pack("<I", len(data)) + data + bytes(len(data) & 1)
                              for name, data in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body
