"""The plain Python/numpy twin of the second image library's decoders
(``csrc/image_extra.cpp``, ``csrc/image_tiff.cpp``, ``csrc/image_zstd.cpp``,
``csrc/image_gif_pnm.cpp``; ``images_plain_more.py`` twins
``csrc/image_ccitt.cpp``, ``csrc/image_tga.cpp`` and the identification,
``images_plain_j2k.py`` ``csrc/image_j2k.cpp``).

``decode`` reads the same files as ``images.decode`` (JPEG baseline,
progressive (block-smoothed when incomplete), lossless and
arithmetic-coded; PNG of every colour type, bit depth and interlace; BMP
raw, RLE and bit-field; TIFF and BigTIFF strips and tiles with PackBits,
LZW (old-style too), Deflate, CCITT, JPEG, LZMA or ZSTD (a Zstandard
frame decoder in Python), predictors 2 / 3, YCbCr,
either fill order and any orientation; GIF; PNM P1-P6 and PFM; TGA;
JPEG 2000),
refuses the same ones and returns the same ``Decoded`` samples:
entropy decoding and LZW in Python, libjpeg-turbo's integer IDCT, fancy
upsampling and fixed-point YCbCr -> RGB vectorised in int64 numpy.  The
tests and ``chip_smoke.py`` hold the library to it; nothing on the
readers' path calls it, and it is far slower than the library.
"""
from __future__ import annotations

import lzma
import re
import struct
import zlib

import numpy as np

from .datasets import _PNG_SIGNATURE, _unfilter
from . import images_plain_j2k as j2k
from . import images_plain_more as more
from .images_plain_more import MAX_PIXELS
from .images import Decoded


def decode(path: str) -> Decoded:
    """An image file PIL identifies as one of ``images.decode``'s formats ->
    its samples in PIL's mode; ValueError naming the file and the reason
    otherwise."""
    with open(path, "rb") as f:
        blob = f.read()
    decoders = {"JPEG": lambda b: _Jpeg(b).decode(), "PNG": _decode_png, "BMP": _decode_bmp,
                "TIFF": _decode_tiff, "GIF": _decode_gif, "PPM": _decode_pnm,
                "TGA": more.decode_tga, "SGI": more.decode_sgi, "PCX": more.decode_pcx,
                "DDS": more.decode_dds, "PSD": more.decode_psd, "ICO": more.decode_ico,
                "CUR": more.decode_cur, "QOI": more.decode_qoi, "IM": more.decode_im,
                "SUN": more.decode_sun, "MSP": more.decode_msp, "XBM": more.decode_xbm,
                "XPM": more.decode_xpm, "SPIDER": more.decode_spider, "WebP": more.decode_webp,
                "JPEG 2000": j2k.decode}
    try:
        return decoders[more.identify(blob)](blob)
    except (ValueError, IndexError, struct.error, zlib.error) as e:
        raise ValueError(f"cannot read {path}: {e}") from None


# ---- JPEG --------------------------------------------------------------------

def _zigzag() -> list:
    order = []
    for s in range(15):
        ys = range(min(s, 7), max(0, s - 7) - 1, -1) if s % 2 == 0 else range(max(0, s - 7),
                                                                              min(s, 7) + 1)
        order += [y * 8 + (s - y) for y in ys]
    return order + [63] * 16


NATURAL = _zigzag()   # zigzag index -> natural index, 16 guard entries of 63


def _huffman_lut(bits, vals) -> list:
    """16-bit window -> (code length << 8) | symbol; 0 for no code."""
    lut, code, k = [0] * 65536, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            n = 1 << (16 - length)
            lut[code << (16 - length):(code << (16 - length)) + n] = [(length << 8) | vals[k]] * n
            code += 1
            k += 1
        code <<= 1
    return lut


class _Bits:
    """The unstuffed bits of one restart interval; zeros past its end."""
    __slots__ = ("d", "pos")

    def __init__(self, data: bytes):
        self.d = data + bytes(64)
        self.pos = 0

    def peek16(self) -> int:
        p, d = self.pos, self.d
        i = p >> 3
        return (((d[i] << 16) | (d[i + 1] << 8) | d[i + 2]) >> (8 - (p & 7))) & 0xFFFF

    def huff(self, lut) -> int:
        e = lut[self.peek16()]
        if not e:
            raise ValueError("JPEG: corrupt Huffman data")
        self.pos += e >> 8
        return e & 0xFF

    def get(self, n: int) -> int:
        if not n:
            return 0
        v = self.peek16() >> (16 - n)
        self.pos += n
        return v


# T.81 Table D.2 (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS); entry 113
# is jdarith.c's fixed 0.5 estimate.
_ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080b, 4, 18, 0),
    (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0), (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0),
    (0x0036, 9, 30, 0), (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1), (0x3f25, 16, 36, 0),
    (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0), (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0),
    (0x0cef, 21, 43, 0), (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01b1, 28, 54, 0),
    (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0), (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0),
    (0x0068, 33, 62, 0), (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0), (0x2ef1, 40, 67, 0),
    (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0), (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0),
    (0x1177, 45, 73, 0), (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0), (0x04de, 52, 50, 0),
    (0x040f, 53, 50, 0), (0x0363, 54, 51, 0), (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0),
    (0x01f8, 57, 54, 0), (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0), (0x008f, 32, 61, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0), (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0),
    (0x2fe8, 69, 83, 0), (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0), (0x119c, 76, 74, 0),
    (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0), (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0),
    (0x5832, 81, 80, 1), (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0), (0x2516, 71, 86, 0),
    (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0), (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0),
    (0x3824, 93, 99, 0), (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0), (0x3c3d, 100, 104, 0),
    (0x375e, 93, 99, 0), (0x5231, 102, 105, 0), (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0),
    (0x415e, 99, 103, 0), (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1), (0x5522, 109, 112, 0),
    (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]
FIXED_BIN = 113


class _Arith:
    """jdarith.c's decoder over one restart interval's unstuffed bytes
    (zeros past their end, as libjpeg feeds at a marker)."""
    __slots__ = ("d", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.d, self.pos, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def decode(self, stats, i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                byte = self.d[self.pos] if self.pos < len(self.d) else 0
                self.pos += 1
                self.c = (self.c << 8) | byte
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = stats[i]
        qe, nm, nl, sw = _ARITAB[sv & 0x7F]
        nl |= sw << 7
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                self.a = qe
                stats[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ nm
        return sv >> 7


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _idct_1d(a: np.ndarray, shift: int) -> np.ndarray:
    """jidctint.c's 1-D stage along the last axis, descaled by ``shift``."""
    z2, z3 = a[..., 2], a[..., 6]
    z1 = (z2 + z3) * 4433
    tmp2, tmp3 = z1 + z3 * -15137, z1 + z2 * 6270
    tmp0, tmp1 = (a[..., 0] + a[..., 4]) * 8192, (a[..., 0] - a[..., 4]) * 8192
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = a[..., 7], a[..., 5], a[..., 3], a[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 = t0 * 2446 + z1 + z3
    t1 = t1 * 16819 + z2 + z4
    t2 = t2 * 25172 + z2 + z3
    t3 = t3 * 12299 + z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)
    return (out + (1 << (shift - 1))) >> shift


def _range_limit() -> np.ndarray:
    x = np.arange(1024)
    x = np.where(x < 512, x, x - 1024)
    return np.clip(x + 128, 0, 255)


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None
        self.coef_bits = [-1] * 64
        self.dc_tbl = self.ac_tbl = 0


class _Jpeg:
    def __init__(self, blob: bytes):
        self.f = blob
        self.qtables, self.dc, self.ac, self.dc_most = {}, {}, {}, {}
        self.comps, self.frame, self.progressive, self.lossless = [], False, False, False
        self.arith = False
        self.dac_l, self.dac_u, self.dac_k = [0] * 4, [1] * 4, [5] * 4
        self.jfif = self.adobe = False
        self.adobe_transform = -1
        self.restart_interval = 0
        self.color = "marked"   # or "ycc" / "none": libtiff's JPEGCOLORMODE_RGB / JCS_UNKNOWN

    # ---- markers ----
    def read_frame(self, p: bytes, marker: int):
        if self.frame:
            raise ValueError("JPEG: more than one frame")
        if p[0] != 8:
            raise ValueError(f"JPEG: sample precision {p[0]} is not supported (8-bit only)")
        self.height, self.width, nc = struct.unpack(">HHB", p[1:6])
        if not self.height or not self.width:
            raise ValueError("JPEG: zero image size (DNL is not supported)")
        if nc not in (1, 3, 4):
            raise ValueError(f"JPEG: {nc} components are not supported (gray, YCbCr / RGB, "
                             "CMYK / YCCK only)")
        self.progressive, self.lossless = marker in (0xC2, 0xCA), marker == 0xC3
        self.arith = marker in (0xC9, 0xCA)
        for i in range(nc):
            c = _Component(p[6 + 3 * i], p[7 + 3 * i] >> 4, p[7 + 3 * i] & 15, p[8 + 3 * i] & 3)
            if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                raise ValueError("JPEG: bad sampling factor")
            self.comps.append(c)
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError("JPEG: non-integral sampling ratios are not supported")
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.dw = -(-self.width * c.h // self.hmax)
            c.dh = -(-self.height * c.v // self.vmax)
            c.wib, c.hib = -(-c.dw // 8), -(-c.dh // 8)
            if self.lossless:
                if c.h != 1 or c.v != 1:
                    raise ValueError("JPEG: subsampled lossless files are not supported")
                c.undiff = np.zeros((self.height, self.width), np.int64)
            else:
                c.coef = [0] * (c.bw * c.bh * 64)
        self.frame = True

    def read_dqt(self, p: bytes):
        i = 0
        while i < len(p):
            pq, tq = p[i] >> 4, p[i] & 15
            if tq > 3:
                raise ValueError("JPEG: bad DQT table index")
            n = 64 * (2 if pq else 1)
            if i + 1 + n > len(p):
                raise ValueError("JPEG: short DQT")
            vals = (struct.unpack(">64H", p[i + 1:i + 1 + n]) if pq else p[i + 1:i + 1 + n])
            table = [0] * 64
            for k in range(64):
                table[NATURAL[k]] = vals[k]
            self.qtables[tq] = table
            i += 1 + n

    def read_dht(self, p: bytes):
        i = 0
        while i < len(p):
            if i + 17 > len(p):
                raise ValueError("JPEG: short DHT")
            tc, th = p[i] >> 4, p[i] & 15
            if tc > 1 or th > 3:
                raise ValueError("JPEG: bad DHT table index")
            bits = list(p[i + 1:i + 17])
            total = sum(bits)
            if total > 256 or i + 17 + total > len(p):
                raise ValueError("JPEG: bad DHT")
            (self.ac if tc else self.dc)[th] = _huffman_lut(bits, p[i + 17:i + 17 + total])
            if not tc:
                self.dc_most[th] = max(p[i + 17:i + 17 + total], default=0)
            i += 17 + total

    def check_dc_table(self, index: int, most: int):
        """jdhuff.c jpeg_make_d_derived_tbl: a DC table's symbols are bit counts."""
        if self.dc_most[index] > most:
            raise ValueError(f"JPEG: bad Huffman table (a DC symbol above {most})")

    def scan_intervals(self, pos: int):
        """The scan's unstuffed restart intervals and the position of the
        marker that ends it (restart markers after the last one skipped)."""
        f, out, cur = self.f, [], bytearray()
        while True:
            j = f.find(b"\xff", pos)
            if j < 0:
                raise ValueError("JPEG: the data ends inside a scan")
            cur += f[pos:j]
            k = j + 1
            while k < len(f) and f[k] == 0xFF:
                k += 1
            if k >= len(f):
                raise ValueError("JPEG: the data ends inside a scan")
            if f[k] == 0:
                cur.append(0xFF)
            elif 0xD0 <= f[k] <= 0xD7:
                out.append((bytes(cur), f[k] - 0xD0))
                cur = bytearray()
            else:
                out.append((bytes(cur), None))
                return out, k - 1
            pos = k + 1

    def read_scan(self, p: bytes, data_start: int) -> int:
        if not self.frame:
            raise ValueError("JPEG: SOS before SOF")
        ns = p[0]
        if not 1 <= ns <= 4 or len(p) < 4 + 2 * ns:
            raise ValueError("JPEG: bad SOS")
        sc = []
        for i in range(ns):
            c = next((c for c in self.comps if c.id == p[1 + 2 * i]), None)
            if c is None:
                raise ValueError("JPEG: SOS names an unknown component")
            c.dc_tbl, c.ac_tbl = p[2 + 2 * i] >> 4, p[2 + 2 * i] & 15
            if c.dc_tbl > 3 or c.ac_tbl > 3:
                raise ValueError("JPEG: bad table index in SOS")
            sc.append(c)
        ss, se, ah, al = p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns] >> 4, p[3 + 2 * ns] & 15
        if self.lossless:
            return self.read_lossless_scan(sc, ss, al, data_start)
        if self.progressive:
            if (ss > se or se > 63 or al > 13 or (ss == 0 and se != 0)
                    or (ss > 0 and ns != 1)):
                raise ValueError("JPEG: bad progressive scan parameters")
        else:
            ss, se, ah, al = 0, 63, 0, 0
        for c in sc:
            if c.qt is None:
                if c.tq not in self.qtables:
                    raise ValueError("JPEG: missing quantisation table")
                c.qt = list(self.qtables[c.tq])
            if not self.arith and ((ss == 0 and ah == 0 and c.dc_tbl not in self.dc)
                                   or (se > 0 and c.ac_tbl not in self.ac)):
                raise ValueError("JPEG: missing Huffman table")
            if not self.arith and ss == 0 and ah == 0:
                self.check_dc_table(c.dc_tbl, 15)
            for k in range(ss, se + 1):
                c.coef_bits[k] = al
        intervals, end = self.scan_intervals(data_start)
        if self.arith:
            self.arith_scan(sc, intervals, ss, se, ah, al)
            return end
        if ns == 1:
            ux, uy = sc[0].wib, sc[0].hib
        else:
            ux, uy = self.mcux, self.mcuy
        total = ux * uy
        per = self.restart_interval or total
        for r, start in enumerate(range(0, total, per)):
            if r > 0 and intervals[r - 1][1] != (r - 1) & 7:
                raise ValueError("JPEG: restart marker out of sequence")
            data = intervals[r][0]
            bits = _Bits(data)
            last_dc, eobrun = [0] * ns, [0]
            for u in range(start, min(start + per, total)):
                x, y = u % ux, u // ux
                if ns == 1:
                    c = sc[0]
                    self.block(bits, c, (y * c.bw + x) * 64, last_dc, 0, eobrun, ss, se, ah, al)
                    continue
                for i, c in enumerate(sc):
                    for by in range(c.v):
                        for bx in range(c.h):
                            base = ((y * c.v + by) * c.bw + x * c.h + bx) * 64
                            self.block(bits, c, base, last_dc, i, eobrun, ss, se, ah, al)
        return end

    def arith_scan(self, sc, intervals, ss, se, ah, al):
        """jdarith.c: statistics zeroed per table at the scan's start and at
        each restart; sequential or the four progressive scan kinds."""
        ns = len(sc)
        ux, uy = (sc[0].wib, sc[0].hib) if ns == 1 else (self.mcux, self.mcuy)
        total = ux * uy
        per = self.restart_interval or total
        dc_stats = {c.dc_tbl: None for c in sc}
        ac_stats = {c.ac_tbl: None for c in sc}
        for r, start in enumerate(range(0, total, per)):
            if r > 0 and intervals[r - 1][1] != (r - 1) & 7:
                raise ValueError("JPEG: restart marker out of sequence")
            dec = _Arith(intervals[r][0])
            last_dc, context, state = [0] * ns, [0] * ns, {"error": False}
            for c in sc:
                if not self.progressive or (ss == 0 and ah == 0):
                    dc_stats[c.dc_tbl] = [0] * 64
                if not self.progressive or ss:
                    ac_stats[c.ac_tbl] = [0] * 256
            for u in range(start, min(start + per, total)):
                x, y = u % ux, u // ux
                for i, c in enumerate(sc):
                    nh, nv = (1, 1) if ns == 1 else (c.h, c.v)
                    for by in range(nv):
                        for bx in range(nh):
                            if state["error"]:
                                continue
                            if ns == 1:
                                base = (y * c.bw + x) * 64
                            else:
                                base = ((y * c.v + by) * c.bw + x * c.h + bx) * 64
                            dcs, acs = dc_stats[c.dc_tbl], ac_stats[c.ac_tbl]
                            if not self.progressive:
                                self.arith_dc(dec, c, dcs, base, last_dc, context, i, 0, state)
                                self.arith_ac_first(dec, c, acs, base, 1, 63, 0, state)
                            elif ss == 0 and ah == 0:
                                self.arith_dc(dec, c, dcs, base, last_dc, context, i, al, state)
                            elif ss == 0:
                                if dec.decode([FIXED_BIN], 0):
                                    c.coef[base] |= 1 << al
                            elif ah == 0:
                                self.arith_ac_first(dec, c, acs, base, ss, se, al, state)
                            else:
                                self.arith_ac_refine(dec, c, acs, base, ss, se, al, state)

    def arith_dc(self, dec, c, stats, base, last_dc, context, i, al, state):
        tbl = c.dc_tbl
        st = context[i]
        if dec.decode(stats, st) == 0:
            context[i] = 0
        else:
            sign = dec.decode(stats, st + 1)
            st += 2 + sign
            m = dec.decode(stats, st)
            if m:
                st = 20
                while dec.decode(stats, st):
                    m <<= 1
                    if m == 0x8000:
                        state["error"] = True
                        return
                    st += 1
            if m < (1 << self.dac_l[tbl]) >> 1:
                context[i] = 0
            elif m > (1 << self.dac_u[tbl]) >> 1:
                context[i] = 12 + sign * 4
            else:
                context[i] = 4 + sign * 4
            v = m
            st += 14
            m >>= 1
            while m:
                if dec.decode(stats, st):
                    v |= m
                m >>= 1
            v += 1
            last_dc[i] = (last_dc[i] + (-v if sign else v)) & 0xFFFF
        c.coef[base] = _int16(last_dc[i] << al)

    def arith_ac_first(self, dec, c, stats, base, ss, se, al, state):
        fixed, k = [FIXED_BIN], ss
        while k <= se:
            st = 3 * (k - 1)
            if dec.decode(stats, st):
                break
            while dec.decode(stats, st + 1) == 0:
                st += 3
                k += 1
                if k > se:
                    state["error"] = True
                    return
            sign = dec.decode(fixed, 0)
            st += 2
            m = dec.decode(stats, st)
            if m and dec.decode(stats, st):
                m <<= 1
                st = 189 if k <= self.dac_k[c.ac_tbl] else 217
                while dec.decode(stats, st):
                    m <<= 1
                    if m == 0x8000:
                        state["error"] = True
                        return
                    st += 1
            v = m
            st += 14
            m >>= 1
            while m:
                if dec.decode(stats, st):
                    v |= m
                m >>= 1
            v += 1
            c.coef[base + NATURAL[k]] = _int16((-v if sign else v) << al)
            k += 1

    def arith_ac_refine(self, dec, c, stats, base, ss, se, al, state):
        fixed, coef, nat = [FIXED_BIN], c.coef, NATURAL
        p1, m1 = 1 << al, -(1 << al)
        kex = se
        while kex > 0 and not coef[base + nat[kex]]:
            kex -= 1
        k = ss
        while k <= se:
            st = 3 * (k - 1)
            if k > kex and dec.decode(stats, st):
                break
            while True:
                at = base + nat[k]
                if coef[at]:
                    if dec.decode(stats, st + 2):
                        coef[at] += m1 if coef[at] < 0 else p1
                    break
                if dec.decode(stats, st + 1):
                    coef[at] = m1 if dec.decode(fixed, 0) else p1
                    break
                st += 3
                k += 1
                if k > se:
                    state["error"] = True
                    return
            k += 1

    def read_lossless_scan(self, sc, psv, pt, data_start) -> int:
        """jdlhuff.c / jdlossls.c: Huffman-coded differences from predictor
        ``psv``; samples mod 2^16, shifted left by ``pt`` on output."""
        if not 1 <= psv <= 7 or pt > 7:
            raise ValueError("JPEG: bad lossless scan parameters")
        if self.restart_interval:
            raise ValueError("JPEG: restart markers in a lossless file are not supported")
        for c in sc:
            if c.dc_tbl not in self.dc:
                raise ValueError("JPEG: missing Huffman table")
            self.check_dc_table(c.dc_tbl, 16)
            c.qt, c.point_transform = [], pt
        intervals, end = self.scan_intervals(data_start)
        bits = _Bits(intervals[0][0])
        h, w = self.height, self.width
        u = [c.undiff for c in sc]
        luts = [self.dc[c.dc_tbl] for c in sc]
        for y in range(h):
            for x in range(w):
                for k in range(len(sc)):
                    s = bits.huff(luts[k])
                    diff = 0 if s == 0 else 32768 if s == 16 else _extend(bits.get(s), s)
                    a = u[k]
                    if y == 0:
                        pred = (1 << (7 - pt)) if x == 0 else a[y, x - 1]
                    elif x == 0:
                        pred = a[y - 1, x]
                    else:
                        ra, rb, rc = a[y, x - 1], a[y - 1, x], a[y - 1, x - 1]
                        pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                                rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
                    a[y, x] = (diff + pred) & 0xFFFF
        return end

    def block(self, bits, c, base, last_dc, i, eobrun, ss, se, ah, al):
        coef, nat = c.coef, NATURAL
        if not self.progressive:
            s = bits.huff(self.dc[c.dc_tbl])
            last_dc[i] += _extend(bits.get(s), s) if s else 0
            coef[base] = _int16(last_dc[i])
            lut = self.ac[c.ac_tbl]
            k = 1
            while k < 64:
                rs = bits.huff(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    coef[base + nat[k]] = _extend(bits.get(s), s)
                elif r != 15:
                    break
                else:
                    k += 15
                k += 1
            return
        if ss == 0:
            if ah == 0:
                s = bits.huff(self.dc[c.dc_tbl])
                last_dc[i] += _extend(bits.get(s), s) if s else 0
                coef[base] = _int16(last_dc[i] << al)
            elif bits.get(1):
                coef[base] |= 1 << al
            return
        lut = self.ac[c.ac_tbl]
        if ah == 0:
            if eobrun[0] > 0:
                eobrun[0] -= 1
                return
            k = ss
            while k <= se:
                rs = bits.huff(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    coef[base + nat[k]] = _int16(_extend(bits.get(s), s) << al)
                elif r == 15:
                    k += 15
                else:
                    eobrun[0] = (1 << r) + bits.get(r) - 1
                    break
                k += 1
            return
        p1, m1 = 1 << al, -(1 << al)
        k = ss
        if eobrun[0] == 0:
            while k <= se:
                rs = bits.huff(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if bits.get(1) else m1
                elif r != 15:
                    eobrun[0] = (1 << r) + bits.get(r)
                    break
                while True:
                    at = base + nat[k]
                    if coef[at] != 0:
                        if bits.get(1) and not coef[at] & p1:
                            coef[at] += p1 if coef[at] >= 0 else m1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if s:
                    coef[base + nat[k]] = s
                k += 1
        if eobrun[0] > 0:
            while k <= se:
                at = base + nat[k]
                if coef[at] != 0 and bits.get(1) and not coef[at] & p1:
                    coef[at] += p1 if coef[at] >= 0 else m1
                k += 1
            eobrun[0] -= 1

    def parse(self):
        f, pos = self.f, 2
        while True:
            while pos < len(f) and f[pos] != 0xFF:
                pos += 1
            while pos < len(f) and f[pos] == 0xFF:
                pos += 1
            if pos >= len(f):
                break
            m = f[pos]
            pos += 1
            if m == 0xD9:
                break
            if m == 0x01 or 0xD0 <= m <= 0xD7:
                continue
            if pos + 2 > len(f):
                raise ValueError("JPEG: truncated marker segment")
            n = (f[pos] << 8) | f[pos + 1]
            if n < 2 or pos + n > len(f):
                raise ValueError("JPEG: truncated marker segment")
            p = f[pos + 2:pos + n]
            if m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
                self.read_frame(p, m)
            elif m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
                raise ValueError("JPEG: hierarchical JPEG is not supported")
            elif m == 0xCB:
                raise ValueError("JPEG: arithmetic-coded lossless JPEG is not supported")
            elif m == 0xCC:
                for i in range(0, len(p) - 1, 2):
                    tc, tb, v = p[i] >> 4, p[i] & 15, p[i + 1]
                    if tb > 3:
                        raise ValueError("JPEG: bad DAC table index")
                    if tc == 0:
                        self.dac_l[tb], self.dac_u[tb] = v & 15, v >> 4
                        if self.dac_l[tb] > self.dac_u[tb]:
                            raise ValueError("JPEG: bad DAC value")
                    else:
                        if not 1 <= v <= 63:
                            raise ValueError("JPEG: bad DAC value")
                        self.dac_k[tb] = v
            elif m == 0xC4:
                self.read_dht(p)
            elif m == 0xDB:
                self.read_dqt(p)
            elif m == 0xDD:
                if len(p) < 2:
                    raise ValueError("JPEG: short DRI")
                self.restart_interval = (p[0] << 8) | p[1]
            elif m == 0xDA:
                pos = self.read_scan(p, pos + n)
                continue
            elif m == 0xE0 and p[:5] == b"JFIF\x00":
                self.jfif = True
            elif m == 0xEE and len(p) >= 12 and p[:5] == b"Adobe":
                self.adobe, self.adobe_transform = True, p[11]
            elif m == 0xDC:
                raise ValueError("JPEG: DNL is not supported")
            pos += n
        if not self.frame:
            raise ValueError("JPEG: no frame")
    # ---- samples ----
    def smoothing_ok(self) -> bool:
        """jdcoefct.c smoothing_ok (see ``smooth``)."""
        if not self.progressive:
            return False
        for c in self.comps:
            if c.qt is None or any(c.qt[k] == 0 for k in _SMOOTH_POS) or c.coef_bits[0] < 0:
                return False
        return any(b != 0 for c in self.comps for b in c.coef_bits[1:10])

    def smooth(self, c, blocks: np.ndarray) -> None:
        """jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1) on ``blocks``
        [bh, bw, 64] in place: each image block's missing low-frequency AC
        coefficients (and with no AC bit known, its DC) estimated from the DC
        values of the 5 x 5 blocks around it."""
        hib, wib = c.hib, c.wib
        rows = _smooth_rows(hib, c.v, self.mcuy)
        cols = np.clip(np.arange(wib)[:, None] + np.arange(-2, 3)[None, :], 0, wib - 1)
        dc = blocks[:, :, 0]
        d = dc[rows[:, None, :, None], cols[None, :, None, :]].reshape(hib, wib, 25)
        DC = [None] + [d[..., i] for i in range(25)]   # DC[1]..DC[25], libjpeg's names
        cb = c.coef_bits
        change_dc = all(b == -1 for b in cb[1:10])
        q = c.qt
        ws = blocks[:hib, :wib].copy()

        def estimate(num, qk, al, limit=True):
            mag = np.where(num >= 0, (qk * 128 + num) // (qk * 256), (qk * 128 - num) // (qk * 256))
            if limit and al > 0:
                mag = np.minimum(mag, (1 << al) - 1)
            return np.where(num >= 0, mag, -mag)

        def put(k, pos, terms):
            al = cb[k]
            if al == 0:
                return
            num = q[0] * sum(w * DC[i] for w, i in terms)
            ws[..., pos] = np.where(ws[..., pos] == 0, estimate(num, q[pos], al), ws[..., pos])

        if change_dc:
            put(1, 1, [(-1, 1), (-1, 2), (1, 4), (1, 5), (-3, 6), (13, 7), (-13, 9), (3, 10),
                       (-3, 11), (38, 12), (-38, 14), (3, 15), (-3, 16), (13, 17), (-13, 19),
                       (3, 20), (-1, 21), (-1, 22), (1, 24), (1, 25)])
            put(2, 8, [(-1, 1), (-3, 2), (-3, 3), (-3, 4), (-1, 5), (-1, 6), (13, 7), (38, 8),
                       (13, 9), (-1, 10), (1, 16), (-13, 17), (-38, 18), (-13, 19), (1, 20),
                       (1, 21), (3, 22), (3, 23), (3, 24), (1, 25)])
            put(3, 16, [(1, 3), (2, 7), (7, 8), (2, 9), (-5, 12), (-14, 13), (-5, 14), (2, 17),
                        (7, 18), (2, 19), (1, 23)])
            put(4, 9, [(-1, 1), (1, 5), (9, 7), (-9, 9), (-9, 17), (9, 19), (1, 21), (-1, 25)])
            put(5, 2, [(2, 7), (-5, 8), (2, 9), (1, 11), (7, 12), (-14, 13), (7, 14), (1, 15),
                       (2, 17), (-5, 18), (2, 19)])
            put(6, 3, [(1, 7), (-1, 9), (2, 12), (-2, 14), (1, 17), (-1, 19)])
            put(7, 10, [(1, 7), (-3, 8), (1, 9), (-1, 17), (3, 18), (-1, 19)])
            put(8, 17, [(1, 7), (-1, 9), (-3, 12), (3, 14), (1, 17), (-1, 19)])
            put(9, 24, [(1, 7), (2, 8), (1, 9), (-1, 17), (-2, 18), (-1, 19)])
            num = q[0] * sum(w * DC[i] for w, i in zip(
                (-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6,
                 -2, -6, -8, -6, -2), range(1, 26)))
            ws[..., 0] = estimate(num, q[0], 0, limit=False)
        else:
            put(1, 1, [(-7, 11), (50, 12), (-50, 14), (7, 15)])
            put(2, 8, [(-7, 3), (50, 8), (-50, 18), (7, 23)])
            put(3, 16, [(-1, 3), (13, 8), (-24, 13), (13, 18), (-1, 23)])
            put(4, 9, [(1, 10), (1, 16), (-10, 17), (10, 19), (-1, 2), (-1, 20), (1, 22),
                       (-1, 24), (1, 4), (-1, 6), (10, 7), (-10, 9)])
            put(5, 2, [(-1, 11), (13, 12), (-24, 13), (13, 14), (-1, 15)])
        blocks[:hib, :wib] = ws

    def plane(self, c, smooth: bool = False) -> np.ndarray:
        if c.qt is None:
            raise ValueError("JPEG: a component is in no scan")
        if self.lossless:
            return (c.undiff << c.point_transform) & 0xFF
        blocks = np.array(c.coef, np.int64).reshape(c.bh, c.bw, 64)
        if smooth:
            self.smooth(c, blocks)
        blocks = blocks.reshape(c.bh, c.bw, 8, 8)
        x = blocks * np.array(c.qt, np.int64).reshape(8, 8)
        ws = _idct_1d(x.swapaxes(-1, -2), 11).swapaxes(-1, -2)   # columns
        out = _range_limit()[_idct_1d(ws, 18) & 1023]            # rows
        return out.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)

    def upsample(self, plane: np.ndarray, c) -> np.ndarray:
        w, h = self.width, self.height
        hx, vx = self.hmax // c.h, self.vmax // c.v
        x, y = np.arange(w), np.arange(h)
        odd_x, odd_y = (x & 1).astype(bool), (y & 1).astype(bool)
        if hx == 1 and vx == 1:
            return plane[:h, :w]
        if hx == 2 and vx == 1 and c.dw > 2:
            i = x >> 1
            nb = np.where(odd_x, np.minimum(i + 1, c.dw - 1), np.maximum(i - 1, 0))
            return (plane[:h, i] * 3 + plane[:h, nb] + np.where(odd_x, 2, 1)) >> 2
        if hx == 1 and vx == 2:
            i = y >> 1
            far = np.where(odd_y, np.minimum(i + 1, c.dh - 1), np.maximum(i - 1, 0))
            return (plane[i, :w] * 3 + plane[far, :w] + np.where(odd_y, 2, 1)[:, None]) >> 2
        if hx == 2 and vx == 2 and c.dw > 2:
            i = y >> 1
            far = np.where(odd_y, np.minimum(i + 1, c.dh - 1), np.maximum(i - 1, 0))
            cs = plane[i, :c.dw] * 3 + plane[far, :c.dw]
            j = x >> 1
            nb = np.where(odd_x, np.minimum(j + 1, c.dw - 1), np.maximum(j - 1, 0))
            return (cs[:, j] * 3 + cs[:, nb] + np.where(odd_x, 7, 8)) >> 4
        return plane[(y // vx)[:, None], (x // hx)[None, :]]

    def decode(self) -> Decoded:
        if self.f[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG file")
        self.parse()
        smooth = self.smoothing_ok()
        planes = [(self.plane(c) if self.lossless else self.upsample(self.plane(c, smooth), c))
                  .astype(np.int64) for c in self.comps]
        if len(planes) == 1:
            return Decoded(planes[0].astype(np.uint8)[:, :, None], "L")
        if len(planes) == 4:     # CMYK, or YCCK after an Adobe marker; PIL inverts ("CMYK;I")
            k = 255 - planes[3]
            if self.lossless and self.adobe and self.adobe_transform != 0:
                raise ValueError("JPEG: a lossless YCCK file is not supported")
            if self.adobe and self.adobe_transform != 0:
                cmy = _ycc_to_rgb(*planes[:3])
            else:
                cmy = 255 - np.stack(planes[:3], -1)
            return Decoded(np.concatenate([cmy, k[..., None]], -1).astype(np.uint8), "CMYK")
        ids = [c.id for c in self.comps]
        if self.color != "marked":
            ycc = self.color == "ycc"
        elif self.jfif:
            ycc = True
        elif self.adobe:
            ycc = self.adobe_transform != 0
        else:
            ycc = ids != [82, 71, 66]
        if not ycc:
            return Decoded(np.stack(planes, -1).astype(np.uint8), "RGB")
        if self.lossless:         # libjpeg-turbo converts no colours in a lossless file
            raise ValueError("JPEG: a lossless YCbCr file is not supported")
        return Decoded(_ycc_to_rgb(*planes).astype(np.uint8), "RGB")


_SMOOTH_POS = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)   # DC and the first nine AC, natural order


def _smooth_rows(hib: int, v: int, mcuy: int) -> np.ndarray:
    """[hib, 5]: the block rows libjpeg's smoothing reads two above to two
    below each image block row.  It numbers the rows by each iMCU row's
    block count, so a short last iMCU row sees fewer rows above and the
    rows before it may reach into the padding rows below the image."""
    out = []
    for row in range(hib):
        imcu, br = divmod(row, v)
        n = v if imcu < mcuy - 1 else (hib % v or v)
        at, count = imcu * n + br, n * mcuy
        prev = row - 1 if at > 0 else row
        nxt = row + 1 if at < count - 1 else row
        out.append([row - 2 if at > 1 else prev, prev, row, nxt,
                    row + 2 if at < count - 2 else nxt])
    return np.array(out)


def _ycc_to_rgb(yy, cb, cr) -> np.ndarray:
    """jdcolor.c's fixed-point YCbCr -> RGB (its tables), clipped."""
    fix = lambda v: int(v * 65536.0 + 0.5)   # noqa: E731
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + 32768) >> 16
    cb_b = (fix(1.77200) * x + 32768) >> 16
    cr_g, cb_g = -fix(0.71414) * x, -fix(0.34414) * x + 32768
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255)


def _int16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


# ---- PNG ---------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _decode_png(blob: bytes) -> Decoded:
    pos, idat, plte, header = 8, [], b"", None
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        if pos + 12 + n > len(blob):
            raise ValueError("PNG: truncated chunk")
        chunk = blob[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            if n != 13:
                raise ValueError("PNG: bad IHDR")
            header = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"PLTE":
            plte = chunk
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not header[0] or not header[1]:
        raise ValueError("PNG: no image header")
    width, height, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        raise ValueError(f"PNG: unknown colour type {color}")
    if depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"PNG: bad bit depth {depth}")
    if interlace > 1:
        raise ValueError("PNG: unknown interlace method")
    if color == 3 and not plte:
        raise ValueError("PNG: palette image without PLTE")
    nch = _PNG_CHANNELS[color]
    bits_pp = nch * depth
    bpp = max(1, bits_pp // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    s = np.zeros((height, width, nch), np.int64)
    off = 0
    for x0, y0, dx, dy in passes:
        if width <= x0 or height <= y0:
            continue
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        stride = (pw * bits_pp + 7) // 8
        size = ph * (stride + 1)
        if off + size > raw.size:
            raise ValueError("PNG: corrupt image data")
        rows = _unfilter(raw[off:off + size], ph, stride, bpp)
        off += size
        if depth == 16:
            vals = rows.view(">u2")[:, :pw * nch].astype(np.int64)
        elif depth == 8:
            vals = rows[:, :pw * nch].astype(np.int64)
        else:
            bits = np.unpackbits(rows, axis=1)[:, :pw * nch * depth].reshape(ph, -1, depth)
            vals = (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(-1)
        s[y0::dy, x0::dx] = vals.reshape(ph, pw, nch)
    if off != raw.size:
        raise ValueError("PNG: corrupt image data")
    if color == 0 and depth == 16:
        return Decoded(s.astype(np.uint16), "I;16")
    if color == 0:
        scale = 1 if depth == 1 else 255 // ((1 << depth) - 1)
        return Decoded((s * scale).astype(np.uint8), "1" if depth == 1 else "L")
    if color == 3:
        pal = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)
        return Decoded(s.astype(np.uint8), "P", pal)
    if color == 4 and depth == 8:
        return Decoded(s.astype(np.uint8), "LA")
    if color == 4:   # 16-bit gray + alpha opens as RGBA of the high bytes
        hi = s >> 8
        return Decoded(np.stack([hi[..., 0]] * 3 + [hi[..., 1]], -1).astype(np.uint8), "RGBA")
    return Decoded((s >> (8 if depth == 16 else 0)).astype(np.uint8),
                   "RGB" if color == 2 else "RGBA")


# ---- BMP ---------------------------------------------------------------------

_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BMP_LAYOUTS32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                  (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                  (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                  (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]


def _bmp_rle(blob: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """BmpRleDecoder: the indices in file row order, [h, w]."""
    data, want, x = bytearray(), w * h, 0
    while len(data) < want:
        if pos + 2 > len(blob):
            break
        n, byte = blob[pos], blob[pos + 1]
        pos += 2
        if n:
            n = max(0, w - x) if x + n > w else n
            if rle4:
                data += bytes((byte >> 4) if i % 2 == 0 else (byte & 15) for i in range(n))
            else:
                data += bytes([byte]) * n
            x += n
        elif byte == 0:
            data += bytes(-len(data) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > len(blob):
                break
            pos += 2                       # PIL reads the delta from the next two bytes
            if pos + 2 > len(blob):
                raise ValueError("BMP: truncated RLE delta")
            right, up = blob[pos], blob[pos + 1]
            pos += 2
            data += bytes(right + up * w)
            x = len(data) % w
        else:
            count = byte // 2 if rle4 else byte
            got = blob[pos:pos + count]
            pos += len(got)
            data += bytes(v for b in got for v in (b >> 4, b & 15)) if rle4 else got
            if len(got) < count:
                break
            x += byte
            pos += pos % 2
    if len(data) < want:
        raise ValueError("BMP: not enough RLE image data")
    return np.frombuffer(bytes(data[:want]), np.uint8).reshape(h, w)


def _decode_bmp(blob: bytes) -> Decoded:
    if len(blob) < 18:
        raise ValueError("BMP: truncated header")
    offset, hsize = struct.unpack("<II", blob[10:18])
    if hsize not in _BMP_HEADERS:
        raise ValueError(f"BMP: header size {hsize} is not supported")
    if 14 + hsize > len(blob):
        raise ValueError("BMP: truncated header")
    hd, pal_at, padding = blob[18:14 + hsize], 14 + hsize, 4
    compression, colors, masks, top_down = 0, 0, (0, 0, 0, 0), False
    if hsize == 12:
        width, height, _, bits = struct.unpack("<HHHH", hd[:8])
        padding = 3
    else:
        top_down = hd[7] == 0xFF
        width, height, _, bits, compression = struct.unpack("<iIHHI", hd[:16])
        height = 2 ** 32 - height if top_down else height
        colors = struct.unpack("<I", hd[28:32])[0]
        if compression == 3:
            if hsize >= 52:
                masks = struct.unpack("<4I" if hsize >= 56 else "<3I", hd[36:52 if hsize >= 56
                                                                       else 48])
            else:
                if pal_at + 12 > len(blob):
                    raise ValueError("BMP: truncated bit fields")
                masks = struct.unpack("<3I", blob[pal_at:pal_at + 12])
                pal_at += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    if width <= 0 or height <= 0 or width * height > MAX_PIXELS:
        raise ValueError("BMP: bad size")
    w, h = width, height
    colors = colors or (1 << bits if bits < 32 else 0)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits in (1, 4, 8):
        mode, raw = "P", "P"
    elif bits in (16, 24, 32):
        mode, raw = "RGB", {16: "BGR;15", 24: "BGR", 32: "BYTES4"}[bits]
    else:
        raise ValueError(f"BMP: {bits}-bit pixels are not supported")
    order, rawbits = [2, 1, 0, -1], bits
    if compression == 3:
        ok = False
        if bits == 32 and masks in _BMP_LAYOUTS32:
            ok = True
            if masks == (0, 0, 0, 0):
                order = [2, 1, 0, 3]
            else:
                order = [next((k for k in range(4) if m == 0xFF << (8 * k)), -1) for m in masks]
            mode = "RGBA" if order[3] >= 0 else mode
        elif bits == 24:
            ok = masks[:3] == (0xFF0000, 0xFF00, 0xFF)
        elif bits == 16:
            if masks[:3] == (0xF800, 0x7E0, 0x1F):
                ok, raw = True, "BGR;16"
            else:
                ok = masks[:3] == (0x7C00, 0x3E0, 0x1F)
        if not ok:
            raise ValueError("BMP: this bit-field layout is not supported")
    elif compression in (1, 2):
        if bits > 8:
            raise ValueError("BMP: RLE needs a palette file")
    elif compression != 0:
        raise ValueError(f"BMP: compression {compression} is not supported")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError("BMP: bad palette size")
        pal = blob[pal_at:pal_at + padding * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = all(pal[i * padding:i * padding + 3] == bytes([v]) * 3 for i, v in enumerate(ramp))
        if gray:
            mode, rawbits = ("1", 1) if colors == 2 else ("L", 8)
        else:
            n = min(len(pal) // padding, 256)
            entries = np.frombuffer(pal[:n * padding], np.uint8).reshape(n, padding)
            palette = np.ascontiguousarray(entries[:, 2::-1])
    if compression in (1, 2):
        if mode == "1":
            raise ValueError("BMP: RLE with a black / white palette is not supported")
        rows = _bmp_rle(blob, offset, w, h, compression == 2)
        rows = rows if top_down else rows[::-1]
        return Decoded(np.ascontiguousarray(rows[:, :, None]), mode, palette)
    stride = ((w * bits + 31) >> 3) & ~3
    if (w * rawbits + 7) // 8 > stride:   # PIL reads 8 bits per pixel on past each row
        raise ValueError(f"BMP: a {bits}-bit file whose palette is the gray ramp is not "
                         "supported")
    if offset > len(blob) or offset + stride * h > len(blob):
        raise ValueError("BMP: truncated pixel data")
    rows = np.frombuffer(blob, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if mode in ("P", "L", "1"):
        if rawbits == 8:
            px = rows[:, :w]
        else:
            bitsarr = np.unpackbits(rows, axis=1)[:, :w * rawbits].reshape(h, w, rawbits)
            px = (bitsarr.astype(np.int64) << np.arange(rawbits - 1, -1, -1)).sum(-1)
        return Decoded(np.ascontiguousarray(px[:, :, None], dtype=np.uint8), mode, palette)
    if raw in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * w].copy().view("<u2").astype(np.int64)
        if raw == "BGR;15":
            r, g = (v >> 10) & 31, (v >> 5) & 31
            rgb = [r * 255 // 31, g * 255 // 31]
        else:
            r, g = (v >> 11) & 31, (v >> 5) & 63
            rgb = [r * 255 // 31, g * 255 // 63]
        rgb.append((v & 31) * 255 // 31)
        return Decoded(np.stack(rgb, -1).astype(np.uint8), "RGB")
    if raw == "BGR":
        px = rows[:, :3 * w].reshape(h, w, 3)
        return Decoded(np.ascontiguousarray(px[:, :, ::-1]), "RGB")
    px = rows[:, :4 * w].reshape(h, w, 4)
    chans = order if mode == "RGBA" else order[:3]
    return Decoded(np.ascontiguousarray(px[:, :, chans]), mode)


# ---- TIFF --------------------------------------------------------------------

_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("B", 1), 7: ("B", 1), 8: ("H", 2),
               9: ("I", 4), 13: ("I", 4), 16: ("Q", 8), 17: ("Q", 8), 18: ("Q", 8),
               2: (None, 1), 5: (None, 8), 10: (None, 8), 11: (None, 4), 12: (None, 8)}
_TIFF_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32946, 32773, 34925, 50000)


def _tiff_tags(blob: bytes):
    """-> (byte order, BigTIFF, {tag: (type, count, position of the values)})."""
    if blob[:2] not in (b"II", b"MM"):
        raise ValueError("not a TIFF file")
    e = ">" if blob[:2] == b"MM" else "<"
    if len(blob) < 8:
        raise ValueError("TIFF: truncated header")
    magic = struct.unpack(e + "H", blob[2:4])[0]
    if magic not in (42, 43):
        raise ValueError("not a TIFF file")
    big = magic == 43     # BigTIFF: 8-byte offsets and counts, 20-byte entries
    if big and e == ">":  # PIL tells BigTIFF by the third byte: "MM\0+" fails there
        raise ValueError("BigTIFF: a big-endian BigTIFF is not supported (PIL reads none)")
    if big and struct.unpack(e + "HH", blob[4:8]) != (8, 0):
        raise ValueError("BigTIFF: bad header")
    ifd = struct.unpack(e + "Q", blob[8:16])[0] if big else struct.unpack(e + "I", blob[4:8])[0]
    first, entry, inline = (ifd + 8, 20, 8) if big else (ifd + 2, 12, 4)
    if first > len(blob):
        raise ValueError("TIFF: truncated file")
    n = struct.unpack(e + ("Q" if big else "H"), blob[ifd:first])[0]
    if n > len(blob) // entry:
        raise ValueError("TIFF: truncated file")
    tags = {}
    for i in range(n):
        at = first + entry * i
        if at + entry > len(blob):
            raise ValueError("TIFF: truncated file")
        tag, kind = struct.unpack(e + "HH", blob[at:at + 4])
        count = struct.unpack(e + ("Q" if big else "I"), blob[at + 4:at + 4 + inline])[0]
        if kind not in _TIFF_TYPES:
            continue
        if count > len(blob):
            raise ValueError("TIFF: truncated file")
        nbytes = _TIFF_TYPES[kind][1] * count
        value_at = at + 4 + inline
        pos = value_at if nbytes <= inline else struct.unpack(
            e + ("Q" if big else "I"), blob[value_at:value_at + inline])[0]
        if pos + nbytes > len(blob):
            raise ValueError("TIFF: truncated file")
        if tag not in tags:
            tags[tag] = (kind, count, pos)
    return e, big, tags


def _tiff_floats(blob: bytes, e: str, field) -> list:
    """A RATIONAL / FLOAT / SHORT / LONG tag as the float32 values libtiff
    stores for its float tags."""
    kind, count, pos = field
    if kind == 5:
        pairs = struct.unpack(f"{e}{2 * count}I", blob[pos:pos + 8 * count])
        return [np.float32(0.0) if a == 0 or b == 0 else np.float32(a / b)
                for a, b in zip(pairs[::2], pairs[1::2])]
    if kind == 11:
        return list(np.frombuffer(blob[pos:pos + 4 * count], e + "f4").astype(np.float32))
    if kind in (3, 4):
        code = "H" if kind == 3 else "I"
        return [np.float32(v) for v in struct.unpack(f"{e}{count}{code}",
                                                      blob[pos:pos + _TIFF_TYPES[kind][1] * count])]
    raise ValueError("TIFF: a float tag has an unexpected type")


def _tiff_layout(photo, sf, bps, extra, big, fill2=False, planar2=False):
    """PIL's OPEN_INFO entry -> (kind, mode, invert, swapped when compressed,
    alpha); ``fill2`` asks for the layouts PIL has a fill-order-2 entry for."""
    n, b = len(bps), bps[0]
    what = (f"TIFF: photometric {photo}, sample format {sf}, {','.join(map(str, bps))}-bit "
            f"samples" + (f", extra samples {','.join(map(str, extra))}" if extra else "")
            + (", planar configuration 2" if planar2 else "") + (", fill order 2" if fill2 else ""))
    refuse = ValueError(what + " is not supported")
    if any(v != b for v in bps):
        raise refuse
    if fill2 and not (sf == 1 and not extra and (
            photo in (0, 1, 3) and n == 1 and b in (1, 2, 4, 8)
            or photo == 1 and n == 1 and b == 16 and not big or photo == 2 and n == 3 and b == 8)):
        raise refuse
    if photo in (0, 1) and n == 1 and not extra:
        inv = photo == 0
        if sf == 1 and b == 1:
            return "bilevel", "1", inv, False, 0
        if sf == 1 and b in (2, 4) or b == 8 and (sf == 1 or (sf == 2 and not inv)):
            return "gray", "L", inv, False, 0
        if sf == 1 and b == 12 and not inv and not big:
            return "u16", "I;16", False, False, 0
        if sf == 1 and b == 16 and not (big and inv):
            return "u16", "I;16B" if big else "I;16", False, False, 0
        if sf == 2 and b == 16 and not inv:
            return "i16s", "I", False, big, 0
        if (sf == 2 or sf == 1 and not big) and b == 32 and not inv:
            return "i32", "I", False, big, 0
        if sf == 3 and b == 32:
            return "f32", "F", False, big, 0
        raise refuse
    if photo == 1 and n == 2 and b == 8 and sf == 1 and extra == [2]:
        return "la", "LA", False, False, 0
    if photo == 2 and sf == 1 and b in (8, 16) and n >= 3 and n == 3 + len(extra):
        alpha = 0
        if n == 4 and not extra:
            alpha = 2
        elif extra:
            if any(extra[1:]) or not (n <= 6 if b == 8 else n == 4) or extra[0] > 2:
                raise refuse
            alpha = extra[0]
        return "rgb", "RGBA" if alpha else "RGB", False, False, alpha
    if photo == 3 and n == 1 and not extra and sf == 1 and b in (1, 2, 4, 8):
        return "palette", "P", False, False, 0
    if (photo == 5 and sf == 1 and n == 4 + len(extra) and not any(extra)
            and (b == 8 and len(extra) <= 2 or b == 16 and not extra)):
        return "cmyk", "CMYK", False, False, 0
    if photo == 8 and sf == 1 and n == 3 and b == 8 and not extra:
        return "lab", "LAB", False, False, 0
    raise refuse


def _unlzw_tiff(data: bytes, want: int) -> bytes:
    """libtiff's LZWDecode: MSB-first codes of 9 to 12 bits, the width
    growing one code early; 256 clears the table, 257 ends the strip.  A
    strip starting 0x00 then a byte with its low bit set is old-style LZW
    (LZWDecodeCompat): LSB-first codes, the width growing when the table
    reaches it."""
    compat = len(data) >= 2 and data[0] == 0 and data[1] & 1
    early = 0 if compat else 1
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    total, pos, width, old = len(data) * 8, 0, 9, None
    data = data + bytes(4)

    def code_at(p, k):
        i = p >> 3
        if compat:
            return (int.from_bytes(data[i:i + 3], "little") >> (p & 7)) & ((1 << k) - 1)
        return (int.from_bytes(data[i:i + 3], "big") >> (24 - k - (p & 7))) & ((1 << k) - 1)

    while len(out) < want:
        if pos + width > total:
            break
        code = code_at(pos, width)
        pos += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width = 9
            while code == 256:
                if pos + width > total:
                    code = -1
                    break
                code = code_at(pos, width)
                pos += width
            if code in (-1, 257):
                break
            if code > 256:
                raise ValueError("TIFF: corrupt LZW data")
            out += table[code]
            old = table[code]
            continue
        if old is None:
            raise ValueError("TIFF: corrupt LZW data (no clear code first)")
        n_free = len(table)
        if code > n_free or n_free >= 5120:
            raise ValueError("TIFF: corrupt LZW data")
        entry = table[code] if code < n_free else old + old[:1]
        table.append(old + entry[:1])
        out += entry
        if len(table) >= (1 << width) - early and width < 12:
            width += 1
        old = entry
    return bytes(out[:want])


def _unpack_bits(data: bytes, want: int) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n and len(out) < want:
        c = data[i] - 256 if data[i] > 127 else data[i]
        i += 1
        if c >= 0:
            out += data[i:i + c + 1]
            i += c + 1
        elif c != -128:
            if i >= n:
                break
            out += bytes([data[i]]) * (1 - c)
            i += 1
    return bytes(out[:want])


# ---- Zstandard (RFC 8878; csrc/image_zstd.cpp) -----------------------------------------

def _zstd_error(what: str):
    raise ValueError(f"TIFF: corrupt ZSTD data ({what})")


class _ZForward:
    """Least significant bit first, from the start (FSE table descriptions)."""

    def __init__(self, data: bytes):
        self.d, self.bit = data, 0

    def peek(self, count: int) -> int:
        lo = self.bit >> 3
        v = int.from_bytes(self.d[lo:lo + 6], "little") >> (self.bit & 7)
        return v & ((1 << count) - 1)

    def read(self, count: int) -> int:
        if (self.bit + count + 7) >> 3 > len(self.d):
            _zstd_error("a table description runs past the block")
        v = self.peek(count)
        self.bit += count
        return v


class _ZBackward:
    """From the last byte's highest set bit towards the first byte, most
    significant bit first; bits before the start read as zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            _zstd_error("a bitstream without its end mark")
        self.d = data
        self.left = 8 * len(data) - 8 + data[-1].bit_length() - 1

    def peek(self, count: int) -> int:
        if count == 0:
            return 0
        pos = self.left - count
        if pos >= 0:
            lo = pos >> 3
            v = int.from_bytes(self.d[lo:(self.left + 7) >> 3], "little") >> (pos & 7)
            return v & ((1 << count) - 1)
        top = self.left
        if top <= 0:
            return 0
        v = int.from_bytes(self.d[:(top + 7) >> 3], "little") & ((1 << top) - 1)
        return v << -pos

    def read(self, count: int) -> int:
        v = self.peek(count)
        self.left -= count
        return v


def _fse_build(counts: list, accuracy: int):
    """(symbol, base, bits) per state of an FSE decoding table."""
    size = 1 << accuracy
    symbol, base, bits = [0] * size, [0] * size, [0] * size
    nxt = [0] * len(counts)
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = max(c, 0)
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(counts):
        for _ in range(c):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        _zstd_error("an FSE table that does not fill")
    for i in range(size):
        state = nxt[symbol[i]]
        nxt[symbol[i]] += 1
        nb = accuracy - (state.bit_length() - 1)
        bits[i] = nb
        base[i] = (state << nb) - size
    return accuracy, symbol, base, bits


def _fse_read(data: bytes, max_log: int, max_symbol: int):
    """An FSE table description -> (table, bytes read)."""
    br = _ZForward(data)
    accuracy = br.read(4) + 5
    if accuracy > max_log:
        _zstd_error("an FSE accuracy above the limit")
    remaining, threshold, nb = (1 << accuracy) + 1, 1 << accuracy, accuracy + 1
    counts = []
    while remaining > 1:
        if len(counts) > max_symbol:
            _zstd_error("too many FSE symbols")
        biggest = 2 * threshold - 1 - remaining
        low = br.peek(nb - 1)
        if low & (threshold - 1) < biggest:
            value = low & (threshold - 1)
            br.read(nb - 1)
        else:
            value = br.read(nb)
            if value >= threshold:
                value -= biggest
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                repeat = br.read(2)
                counts += [0] * repeat
                if repeat != 3:
                    break
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        _zstd_error("a bad FSE table description")
    return _fse_build(counts, accuracy), (br.bit + 7) >> 3


def _huffman_build(weights: list):
    total = sum(1 << (w - 1) for w in weights if w > 0)
    if total == 0:
        _zstd_error("a Huffman tree without weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        _zstd_error("a Huffman tree that does not close")
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        _zstd_error("Huffman codes above 11 bits")
    symbol, length = [], []
    for weight in range(1, max_bits + 1):
        for s, w in enumerate(weights):
            if w == weight:
                span = 1 << (weight - 1)
                symbol += [s] * span
                length += [max_bits + 1 - weight] * span
    return max_bits, symbol, length


def _huffman_tree(data: bytes):
    """The tree description -> (table, bytes read)."""
    if not data:
        _zstd_error("a truncated Huffman tree")
    head = data[0]
    if head >= 128:
        count = head - 127
        used = 1 + (count + 1) // 2
        if used > len(data):
            _zstd_error("a truncated Huffman tree")
        weights = [(data[1 + i // 2] >> (0 if i % 2 else 4)) & 15 for i in range(count)]
    else:
        used = 1 + head
        if used > len(data):
            _zstd_error("a truncated Huffman tree")
        (log, symbol, base, bits), desc = _fse_read(data[1:used], 6, 255)
        if desc > head:
            _zstd_error("a truncated Huffman tree")
        br = _ZBackward(data[1 + desc:used])
        states = [br.read(log), br.read(log)]
        weights = []
        k = 0
        while True:
            if len(weights) > 254:
                _zstd_error("too many Huffman weights")
            s = states[k]
            weights.append(symbol[s])
            states[k] = base[s] + br.read(bits[s])
            if br.left < 0:
                weights.append(symbol[states[1 - k]])
                break
            k = 1 - k
    if any(w > 11 for w in weights):
        _zstd_error("a Huffman weight above 11")
    return _huffman_build(weights), used


def _huffman_stream(table, data: bytes, count: int) -> bytes:
    max_bits, symbol, length = table
    br = _ZBackward(data)
    out = bytearray(count)
    for i in range(count):
        idx = br.peek(max_bits)
        out[i] = symbol[idx]
        br.left -= length[idx]
    if br.left != 0:
        _zstd_error("a Huffman stream of the wrong length")
    return bytes(out)


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
               1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _zstd_table(mode, data, defaults, default_log, max_log, max_symbol, previous):
    """One table of the sequences section -> (table, bytes read)."""
    if mode == 0:
        return _fse_build(defaults, default_log), 0
    if mode == 1:
        if not data or data[0] > max_symbol:
            _zstd_error("a bad RLE symbol")
        return (0, [data[0]], [0], [0]), 1
    if mode == 2:
        return _fse_read(data, max_log, max_symbol)
    if previous is None:
        _zstd_error("a repeated table before any")
    return previous, 0


def _zstd_block(d: bytes, block_max: int, st: dict, out: bytearray):
    """One compressed block appended to ``out``; it may regenerate at most
    ``block_max`` bytes (libzstd's blockSizeMax)."""
    if not d:
        _zstd_error("an empty compressed block")
    block_start = len(out)
    ltype, fmt = d[0] & 3, (d[0] >> 2) & 3
    if ltype <= 1:
        if fmt in (0, 2):
            regen, head = d[0] >> 3, 1
        elif fmt == 1:
            regen, head = (d[0] >> 4) | (d[1] << 4), 2
        else:
            regen, head = (d[0] >> 4) | (d[1] << 4) | (d[2] << 12), 3
        if ltype == 0:
            if head + regen > len(d):
                _zstd_error("truncated raw literals")
            lit = d[head:head + regen]
            head += regen
        else:
            if head + 1 > len(d):
                _zstd_error("truncated RLE literals")
            lit = bytes([d[head]]) * regen
            head += 1
    else:
        bits = 10 if fmt <= 1 else (14 if fmt == 2 else 18)
        head = 3 if fmt <= 1 else (4 if fmt == 2 else 5)
        if len(d) < head:
            _zstd_error("a truncated literals header")
        h = int.from_bytes(d[:head], "little")
        regen = (h >> 4) & ((1 << bits) - 1)
        csize = (h >> (4 + bits)) & ((1 << bits) - 1)
        if head + csize > len(d):
            _zstd_error("truncated Huffman literals")
        body = d[head:head + csize]
        if ltype == 2:
            st["huf"], used = _huffman_tree(body)
            body = body[used:]
        elif st["huf"] is None:
            _zstd_error("treeless literals before any tree")
        if fmt == 0:
            lit = _huffman_stream(st["huf"], body, regen)
        else:
            if len(body) < 6:
                _zstd_error("a truncated jump table")
            s1, s2, s3 = (int.from_bytes(body[k:k + 2], "little") for k in (0, 2, 4))
            if 6 + s1 + s2 + s3 > len(body):
                _zstd_error("a bad jump table")
            seg = (regen + 3) // 4
            if 3 * seg > regen:
                _zstd_error("too few literals for four streams")
            cuts = [6, 6 + s1, 6 + s1 + s2, 6 + s1 + s2 + s3, len(body)]
            lit = b"".join(_huffman_stream(st["huf"], body[cuts[k]:cuts[k + 1]],
                                           seg if k < 3 else regen - 3 * seg) for k in range(4))
        head += csize
    if len(lit) > block_max:
        _zstd_error("more literals than a block holds")
    pos = head
    if pos >= len(d):
        _zstd_error("no sequences section")
    nseq = d[pos]
    if nseq < 128:
        pos += 1
    elif nseq < 255:
        nseq = ((nseq - 128) << 8) + d[pos + 1]
        pos += 2
    else:
        nseq = d[pos + 1] + (d[pos + 2] << 8) + 0x7F00
        pos += 3
    lit_pos = 0
    if nseq:
        modes = d[pos]
        pos += 1
        if modes & 3:
            _zstd_error("reserved bits in the compression modes")
        st["ll"], used = _zstd_table(modes >> 6, d[pos:], _LL_DEFAULT, 6, 9, 35, st["ll"])
        pos += used
        st["of"], used = _zstd_table((modes >> 4) & 3, d[pos:], _OF_DEFAULT, 5, 8, 31, st["of"])
        pos += used
        st["ml"], used = _zstd_table((modes >> 2) & 3, d[pos:], _ML_DEFAULT, 6, 9, 52, st["ml"])
        pos += used
        if pos > len(d):
            _zstd_error("truncated sequence tables")
        ll_t, of_t, ml_t = st["ll"], st["of"], st["ml"]
        br = _ZBackward(d[pos:])
        sll, sof, sml = br.read(ll_t[0]), br.read(of_t[0]), br.read(ml_t[0])
        rep = st["rep"]
        for i in range(nseq):
            ofc, llc, mlc = of_t[1][sof], ll_t[1][sll], ml_t[1][sml]
            if ofc > 31 or llc > 35 or mlc > 52:
                _zstd_error("a bad sequence code")
            ofv = (1 << ofc) + br.read(ofc)
            ml = _ML_BASE[mlc] + br.read(_ML_BITS[mlc])
            ll = _LL_BASE[llc] + br.read(_LL_BITS[llc])
            if ofv > 3:
                offset = ofv - 3
                rep[:] = [offset, rep[0], rep[1]]
            else:
                idx = ofv - 1 + (ll == 0)
                if idx == 0:
                    offset = rep[0]
                else:
                    offset = rep[0] - 1 if idx == 3 else rep[idx]
                    rep[:] = [offset, rep[0], rep[2] if idx == 1 else rep[1]]
            if i + 1 < nseq:
                sll = ll_t[2][sll] + br.read(ll_t[3][sll])
                sml = ml_t[2][sml] + br.read(ml_t[3][sml])
                sof = of_t[2][sof] + br.read(of_t[3][sof])
            if lit_pos + ll > len(lit):
                _zstd_error("a sequence past the literals")
            if len(out) - block_start + ll + ml > block_max:
                _zstd_error("a block above its maximum")
            out += lit[lit_pos:lit_pos + ll]
            lit_pos += ll
            if offset == 0 or offset > len(out):
                _zstd_error("an offset before the frame")
            start = len(out) - offset
            if offset >= ml:
                out += out[start:start + ml]
            else:
                for k in range(ml):
                    out.append(out[start + k])
        if br.left != 0:
            _zstd_error("a sequence bitstream of the wrong length")
    if len(out) - block_start + len(lit) - lit_pos > block_max:
        _zstd_error("a block above its maximum")
    out += lit[lit_pos:]


_XXP1, _XXP2, _XXP3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_XXP4, _XXP5, _M64 = 9650029242287828579, 2870177450012600261, (1 << 64) - 1


def _xxh64(data: bytes) -> int:
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & _M64

    def rnd(acc, lane):
        return rotl((acc + lane * _XXP2) & _M64, 31) * _XXP1 & _M64

    n, p = len(data), 0
    if n >= 32:
        v = [(_XXP1 + _XXP2) & _M64, _XXP2, 0, (-_XXP1) & _M64]
        while n - p >= 32:
            for k in range(4):
                v[k] = rnd(v[k], int.from_bytes(data[p + 8 * k:p + 8 * k + 8], "little"))
            p += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ rnd(0, x)) * _XXP1 + _XXP4) & _M64
    else:
        h = _XXP5
    h = (h + n) & _M64
    while n - p >= 8:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[p:p + 8], "little")), 27) * _XXP1
             + _XXP4) & _M64
        p += 8
    if n - p >= 4:
        h = (rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _XXP1 & _M64), 23) * _XXP2
             + _XXP3) & _M64
        p += 4
    while p < n:
        h = rotl(h ^ (data[p] * _XXP5 & _M64), 11) * _XXP1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _XXP2 & _M64
    h ^= h >> 29
    h = h * _XXP3 & _M64
    return h ^ (h >> 32)


def _unzstd(d: bytes, want: int) -> bytes:
    """The first frame of one ZSTD strip or tile -> its first ``want`` bytes,
    as libtiff reads them with ZSTD_decompressStream (which stops at a
    frame's end, a skippable one too; the checksum verified)."""
    out = bytearray()
    pos = 0
    magic = int.from_bytes(d[:4], "little") if len(d) >= 4 else None
    if magic is not None and magic & 0xFFFFFFF0 != 0x184D2A50:
        if magic != 0xFD2FB528:
            _zstd_error("no frame magic")
        pos += 4
        if pos >= len(d):
            _zstd_error("a truncated frame header")
        desc = d[pos]
        pos += 1
        fcs, single, checksum, dict_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
        if desc & 8:
            _zstd_error("a reserved frame header bit")
        window = 0
        if not single:
            if pos >= len(d):
                _zstd_error("a truncated frame header")
            window = 1 << (10 + (d[pos] >> 3))
            window += (window >> 3) * (d[pos] & 7)
            pos += 1
        nd = (0, 1, 2, 4)[dict_flag]
        if int.from_bytes(d[pos:pos + nd], "little"):
            raise ValueError("TIFF: a ZSTD frame with a dictionary is not supported")
        pos += nd
        fcs_bytes = 1 if fcs == 0 and single else (0, 2, 4, 8)[fcs]
        if pos + fcs_bytes > len(d):
            _zstd_error("a truncated frame header")
        content = int.from_bytes(d[pos:pos + fcs_bytes], "little") + (256 if fcs_bytes == 2 else 0)
        pos += fcs_bytes
        # libzstd's limits: a window of at most 128 MiB + 1 (its default),
        # the content size in a single segment; a block regenerates at most
        # the window and at most 128 KiB; the frame exactly its content size
        if single:
            window = content
        if window > (1 << 27) + 1:
            _zstd_error("a window above 128 MiB")
        block_max = min(window, 1 << 17)
        st = {"huf": None, "ll": None, "of": None, "ml": None, "rep": [1, 4, 8]}
        start = len(out)
        last = False
        while not last:
            if pos + 3 > len(d):
                _zstd_error("a truncated block header")
            bh = int.from_bytes(d[pos:pos + 3], "little")
            pos += 3
            last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
            if kind == 3:
                _zstd_error("a reserved block type")
            if size > block_max:
                _zstd_error("a block above its maximum")
            if kind == 1:
                if pos + 1 > len(d):
                    _zstd_error("a truncated RLE block")
                out += bytes([d[pos]]) * size
                pos += 1
            else:
                if size > len(d) - pos:
                    _zstd_error("a truncated block")
                if kind == 0:
                    out += d[pos:pos + size]
                else:
                    _zstd_block(d[pos:pos + size], block_max, st, out)
                pos += size
            if len(out) > want + (1 << 18):
                _zstd_error("more data than the strip holds")
            if fcs_bytes and len(out) - start > content:
                _zstd_error("more data than the content size")
        if fcs_bytes and len(out) - start != content:
            _zstd_error("less data than the content size")
        if checksum:
            if pos + 4 > len(d):
                _zstd_error("a truncated checksum")
            if _xxh64(bytes(out[start:])) & 0xFFFFFFFF != int.from_bytes(d[pos:pos + 4],
                                                                           "little"):
                raise ValueError("TIFF: ZSTD checksum mismatch")
            pos += 4
    if len(out) < want:
        raise ValueError("TIFF: not enough ZSTD data for the strip or tile")
    return bytes(out[:want])


def _inflate(data: bytes, want: int) -> bytes:
    d = zlib.decompressobj()
    try:
        return d.decompress(data, want)
    except zlib.error:
        raise ValueError("TIFF: corrupt Deflate data") from None


def _decode_tiff(blob: bytes) -> Decoded:
    e, bigtiff, fields = _tiff_tags(blob)
    try:
        return _decode_tiff_fields(blob, e, fields)
    except ValueError as err:
        if bigtiff:
            raise ValueError(f"BigTIFF: {err}") from None
        raise


def _decode_tiff_fields(blob: bytes, e: str, fields) -> Decoded:
    big = e == ">"

    def get(tag, default=None):
        if tag not in fields:
            return default
        kind, count, pos = fields[tag]
        code, size = _TIFF_TYPES[kind]
        if code is None:
            raise ValueError(f"TIFF: tag {tag} has a non-integer type")
        return list(struct.unpack(f"{e}{count}{code}", blob[pos:pos + size * count]))

    if 256 not in fields or 257 not in fields:
        raise ValueError("TIFF: missing dimensions")
    w, h = get(256)[0], get(257)[0]
    if not w or not h or w > MAX_PIXELS or h > MAX_PIXELS or w * h > MAX_PIXELS:
        raise ValueError("TIFF: bad image size")
    compression, photo = get(259, [1])[0], get(262, [0])[0]
    fill, orientation = get(266, [1])[0], get(274, [1])[0]
    planar, predictor = get(284, [1])[0], get(317, [1])[0]
    if 0xBC01 in fields:
        raise ValueError("TIFF: Windows Media Photo is not supported")
    ccitt, jpeg = compression in (2, 3, 4), compression == 7
    if compression == 6:
        raise ValueError("TIFF: compression 6 (old-style JPEG) is not supported")
    if compression not in _TIFF_COMPRESSIONS:
        raise ValueError(f"TIFF: compression {compression} is not supported (none, CCITT, LZW, "
                         "JPEG, Deflate, PackBits, LZMA and ZSTD only)")
    if fill not in (1, 2):
        raise ValueError(f"TIFF: fill order {fill} is not supported")
    if planar not in (1, 2):
        raise ValueError("TIFF: bad planar configuration")
    sfs = get(339, [])
    if len(sfs) > 1 and any(v != 1 for v in sfs):
        raise ValueError("TIFF: per-sample formats are not supported")
    sf = sfs[0] if sfs else 1
    bps, extra, spp = get(258, [1]) or [1], get(338, []), get(277, [1])[0]
    if not 1 <= spp <= 6:
        raise ValueError("TIFF: bad samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("TIFF: unknown data organization")
    ycbcr = photo == 6 and spp == 3
    kind, mode, inv, swapped, alpha = _tiff_layout(2 if ycbcr else (1 if photo == 6 else photo),
                                                   sf, bps, extra, big, fill == 2,
                                                   planar == 2 and spp > 1)
    if ycbcr and (extra or bps[0] != 8):
        raise ValueError("TIFF: photometric 6 (YCbCr) needs three 8-bit samples")
    b, raw = bps[0], compression == 1
    if planar == 2 and spp > 1 and b not in (8, 16):
        raise ValueError("TIFF: planar configuration 2 is supported for 8- and 16-bit samples "
                         "only")
    if ccitt and not (b == 1 and spp == 1):
        raise ValueError("TIFF: CCITT compression needs 1-bit samples")
    if jpeg and (b != 8 or planar == 2 and spp > 1 or photo not in (0, 1, 2, 6)):
        raise ValueError("TIFF: compression 7 (JPEG) is supported for 8-bit gray, RGB and "
                         "YCbCr only")
    if not raw and predictor == 2 and b not in (8, 16, 32):
        raise ValueError(f"TIFF: horizontal differencing at {b} bits is not supported")
    if not raw and predictor == 3 and not (sf == 3 and b == 32):
        raise ValueError("TIFF: the floating-point predictor needs 32-bit float samples")
    if not raw and predictor not in (1, 2, 3):
        raise ValueError(f"TIFF: predictor {predictor} is not supported")
    if (ccitt or jpeg) and predictor != 1:
        raise ValueError("TIFF: a predictor with CCITT or JPEG compression is not supported")
    if ycbcr and planar == 2:
        raise ValueError("TIFF: YCbCr in planar configuration 2 is not supported")
    hs = vs = 1
    ycc = None
    if ycbcr and not jpeg and not raw:
        sub = get(530, [])
        if len(sub) >= 2:
            hs, vs = sub[0], sub[1]
        if not (hs in (1, 2, 4) and vs in (1, 2, 4) and vs <= hs):
            raise ValueError(f"TIFF: YCbCr subsampling {hs}x{vs} is not supported")
        if predictor != 1:
            raise ValueError("TIFF: a predictor with YCbCr samples is not supported")
        ycc = more.YCbCrToRGB(*[_tiff_floats(blob, e, fields[t]) if t in fields else []
                                for t in (529, 532)])
    tables = b""
    if jpeg and 347 in fields and _TIFF_TYPES[fields[347][0]][1] == 1:
        _, count, pos = fields[347]
        tables = blob[pos:pos + count]
    t4 = get(293 if compression == 4 else 292, [0])[0]
    tiled = 324 in fields
    if tiled:
        cw, ch = get(322, [0])[0], get(323, [0])[0]
        if not cw or not ch or cw * ch > MAX_PIXELS:
            raise ValueError("TIFF: bad tile size")
        offsets, counts = get(324), get(325, [])
    else:
        if 273 not in fields:
            raise ValueError("TIFF: no strips or tiles")
        cw, ch = w, get(278, [h])[0]
        offsets, counts = get(273), get(279, [])
        if ch == 0 or ch > h:
            ch = h
    planes, nsamp = (spp, 1) if planar == 2 else (1, spp)
    across, down = -(-w // cw), -(-h // ch)
    per_plane = across * down
    if len(offsets) < per_plane * planes:
        raise ValueError("TIFF: too few strip or tile offsets")
    if not raw and len(counts) < per_plane * planes:
        raise ValueError("TIFF: missing byte counts")
    rowbytes = (cw * nsamp * b + 7) // 8
    per_row = cw * nsamp
    byte_planes = raw and planar == 2 and spp > 1 and b == 16   # PIL's 8-bit band unpacker
    vals = np.zeros((h, w, spp), np.uint32)
    for pl in range(planes):
        for ci in range(per_plane):
            x0, y0 = (ci % across) * cw, (ci // across) * ch
            rows = ch if tiled else min(ch, h - y0)
            want = rows * rowbytes
            off = offsets[pl * per_plane + ci]
            order = e
            if raw:
                rows, cols = min(rows, h - y0), min(cw, w - x0)
                stride = rowbytes
                if ycbcr:       # PIL's raw "RGBX": four bytes a pixel
                    stride = cw * 4 if x0 + cw > w else cols * 4
                elif byte_planes:
                    stride = cw * 2 if x0 + cw > w else cols
                data = blob[off:off + rows * stride]
                if off > len(blob) or len(data) < rows * stride:
                    raise ValueError("TIFF: photometric 6 (YCbCr) uncompressed: PIL reads it as "
                                     "RGBX and the file is truncated" if ycbcr
                                     else "TIFF: truncated image data")
                if fill == 2:
                    data = data.translate(_REVERSED_BITS)
                if ycbcr or byte_planes:
                    src = np.frombuffer(data, np.uint8).reshape(rows, stride)
                    packed = np.zeros((rows, rowbytes), np.uint8)
                    if ycbcr:
                        packed[:, :3 * cols] = src[:, :4 * cols].reshape(rows, cols, 4)[
                            :, :, :3].reshape(rows, -1)
                    else:       # big-endian 16-bit values whose high byte is the plane's byte
                        packed[:, 0:2 * cols:2] = src[:, :cols]
                        order = ">"
                    data = packed.tobytes()
            else:
                cnt = counts[pl * per_plane + ci]
                if off > len(blob) or off + cnt > len(blob):
                    raise ValueError("TIFF: truncated image data")
                src = blob[off:off + cnt]
                if fill == 2:
                    src = src.translate(_REVERSED_BITS)
                coded = (-(-cw // hs) * -(-rows // vs) * (hs * vs + 2)) if ycc else want
                if compression == 5:
                    data = _unlzw_tiff(src, coded)
                elif compression == 32773:
                    data = _unpack_bits(src, coded)
                elif compression == 34925:      # libtiff's xz streams, through the stdlib
                    try:
                        data = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(src, coded)
                    except lzma.LZMAError:
                        raise ValueError("TIFF: corrupt LZMA data") from None
                elif compression == 50000:
                    data = _unzstd(src, coded)
                elif ccitt:
                    px = more.decode_ccitt(src, cw, rows, compression, t4)
                    bits = np.zeros((rows, rowbytes * 8), np.uint8)
                    bits[:, :cw] = px
                    data = np.packbits(bits, axis=1).tobytes()
                elif jpeg:
                    part = _jpeg_chunk(tables, src, photo == 6)
                    ph, pw, pc = part.shape
                    if pc != spp or pw < cw or ph < min(rows, h - y0):
                        raise ValueError("TIFF: a JPEG strip or tile does not match the image")
                    buf = np.zeros((rows, rowbytes), np.uint8)
                    buf[:min(rows, ph)] = part[:rows, :cw].reshape(min(rows, ph), -1)
                    data = buf.tobytes()
                else:
                    data = _inflate(src, coded)
                if len(data) < coded:
                    raise ValueError("TIFF: not enough image data in a strip or tile")
                if ycc:
                    data = ycc.units_to_rgb(data, cw, rows, hs, vs).tobytes()
            buf = np.frombuffer(data, np.uint8, rows * rowbytes).reshape(rows, rowbytes)
            if not raw and predictor == 3:
                acc = buf.astype(np.uint64)
                for lane in range(nsamp):
                    acc[:, lane::nsamp] = np.cumsum(acc[:, lane::nsamp], axis=1)
                planes_b = (acc & 0xFF).astype(np.uint32).reshape(rows, 4, -1)
                chunk = ((planes_b[:, 0] << 24) | (planes_b[:, 1] << 16) | (planes_b[:, 2] << 8)
                         | planes_b[:, 3])[:, :per_row]
            else:
                if b == 8:
                    chunk = buf.astype(np.uint32)
                elif b in (16, 32):
                    chunk = buf.view(f"{order}u{b // 8}").astype(np.uint32)
                else:
                    bits = np.unpackbits(buf, axis=1)[:, :per_row * b].reshape(rows, per_row, b)
                    chunk = (bits.astype(np.uint32) << np.arange(b - 1, -1, -1,
                                                                 dtype=np.uint32)).sum(-1)
                chunk = chunk[:, :per_row].astype(np.uint64)
                if not raw and predictor == 2:
                    for lane in range(nsamp):
                        chunk[:, lane::nsamp] = np.cumsum(chunk[:, lane::nsamp], axis=1)
                    chunk &= (1 << b) - 1
                chunk = chunk.astype(np.uint32)
            if swapped and not raw:     # PIL reads libtiff's host order as big-endian
                chunk = chunk.astype(f"<u{b // 8}").view(f">u{b // 8}").astype(np.uint32)
            keep_rows, keep_cols = min(rows, h - y0), min(cw, w - x0)
            block = chunk[:keep_rows].reshape(keep_rows, cw, nsamp)[:, :keep_cols]
            if planar == 2:
                vals[y0:y0 + keep_rows, x0:x0 + keep_cols, pl] = block[..., 0]
            else:
                vals[y0:y0 + keep_rows, x0:x0 + keep_cols] = block
    out = _tiff_samples(vals, kind, mode, inv, alpha, b, get)
    return more.orient(out, orientation)


_REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _jpeg_chunk(tables: bytes, src: bytes, ycc: bool) -> np.ndarray:
    """One JPEG strip or tile of a compression-7 TIFF -> [h, w, c] uint8:
    the JPEGTables' segments ahead of the strip, converted from YCbCr to RGB
    (libtiff's JPEGCOLORMODE_RGB) for photometric 6 and not at all else."""
    if len(tables) >= 4 and src[:2] == b"\xff\xd8":
        src = tables[:-2] + src[2:]
    dec = _Jpeg(src)
    dec.color = "ycc" if ycc else "none"
    try:
        return dec.decode().samples
    except ValueError as err:
        raise ValueError(f"TIFF: compression 7 (JPEG): {err}") from None


def _tiff_samples(vals, kind, mode, inv, alpha, b, get) -> Decoded:
    v = vals.astype(np.int64)
    if kind == "bilevel":
        return Decoded((1 - v if inv else v).astype(np.uint8), "1")
    if kind == "gray":
        v = v * {2: 85, 4: 17, 8: 1}[b]
        return Decoded((255 - v if inv else v).astype(np.uint8), "L")
    if kind in ("la", "lab"):
        return Decoded(v.astype(np.uint8), mode)
    if kind == "palette":
        cmap = get(320, [])
        if not cmap or len(cmap) % 3:
            raise ValueError("TIFF: palette image without a colour map")
        pal = (np.array(cmap, np.int64).reshape(3, -1).T >> 8).astype(np.uint8)
        return Decoded(v.astype(np.uint8), "P", np.ascontiguousarray(pal))
    if kind == "u16":
        return Decoded(v.astype(np.uint16), mode)
    if kind == "i16s":
        return Decoded(v.astype(np.uint16).view(np.int16).astype(np.int32), "I")
    if kind == "i32":
        return Decoded(vals.view(np.int32).copy(), "I")
    if kind == "f32":
        return Decoded(vals.view(np.float32).copy(), "F")
    out = (v >> (8 if b == 16 else 0))[:, :, :4 if kind == "cmyk" or alpha else 3]
    if alpha == 1:     # Unpack.c unpackRGBa: associated alpha divided out
        a = out[:, :, 3:]
        out = np.concatenate([np.where(a == 0, 0, np.minimum(out[:, :, :3] * 255
                                                             // np.maximum(a, 1), 255)), a], -1)
    return Decoded(out.astype(np.uint8), mode)


# ---- GIF -----------------------------------------------------------------------

def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p), 3))


def _interlaced_rows(h: int) -> list:
    return [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for y in range(start, h, step)]


def _unlzw_gif(data: bytes, bits: int, want: int) -> bytes:
    """GifDecode.c: LSB-first codes from the initial size + 1 up to 12 bits."""
    if not 1 <= bits <= 11:
        raise ValueError("GIF: bad LZW code size")
    clear, eoi = 1 << bits, (1 << bits) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, out = list(base), bytearray()
    pos, total, width, old = 0, len(data) * 8, bits + 1, None
    data = data + bytes(4)
    while len(out) < want and pos + width <= total:
        i = pos >> 3
        code = (int.from_bytes(data[i:i + 3], "little") >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table, width, old = list(base), bits + 1, None
            continue
        if code == eoi:
            break
        if old is None:
            if code >= clear:
                raise ValueError("GIF: corrupt LZW data")
            out += table[code]
            old = code
            continue
        n = len(table)
        if code > n or (code == n and n >= 4096):
            raise ValueError("GIF: corrupt LZW data")
        entry = table[code] if code < n else table[old] + table[old][:1]
        if n < 4096:
            table.append(table[old] + entry[:1])
            if len(table) == 1 << width and width < 12:
                width += 1
        out += entry
        old = code
    return bytes(out[:want])


def _decode_gif(blob: bytes) -> Decoded:
    if len(blob) < 13 or blob[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    sw, sh, flags = blob[6] | blob[7] << 8, blob[8] | blob[9] << 8, blob[10]
    pos, palette = 13, None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(blob):
            raise ValueError("GIF: truncated colour table")
        palette = blob[pos:pos + n] if _palette_needed(blob[pos:pos + n]) else None
        pos += n
    transparency = None
    while True:
        if pos >= len(blob):
            raise ValueError("GIF: no image in the file")
        s = blob[pos]
        pos += 1
        if s == ord("!"):
            if pos >= len(blob):
                raise ValueError("GIF: truncated extension")
            label, first = blob[pos], True
            pos += 1
            while pos < len(blob) and blob[pos]:
                n = blob[pos]
                if pos + 1 + n > len(blob):
                    raise ValueError("GIF: truncated extension")
                if label == 0xF9 and first and n >= 4 and blob[pos + 1] & 1:
                    transparency = blob[pos + 4]
                first = False
                pos += 1 + n
            pos += 1
        elif s == ord(","):
            break
        elif s == ord(";"):
            raise ValueError("GIF: no image in the file")
    if pos + 9 > len(blob):
        raise ValueError("GIF: truncated image descriptor")
    x0, y0, fw, fh = struct.unpack("<HHHH", blob[pos:pos + 8])
    lflags = blob[pos + 8]
    pos += 9
    if lflags & 128:
        n = 3 << ((lflags & 7) + 1)
        if pos + n > len(blob):
            raise ValueError("GIF: truncated colour table")
        palette = blob[pos:pos + n] if _palette_needed(blob[pos:pos + n]) else None
        pos += n
    if pos >= len(blob):
        raise ValueError("GIF: truncated image data")
    bits, data = blob[pos], bytearray()
    pos += 1
    while pos < len(blob) and blob[pos]:
        n = blob[pos]
        if pos + 1 + n > len(blob):
            raise ValueError("GIF: truncated image data")
        data += blob[pos + 1:pos + 1 + n]
        pos += 1 + n
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError("GIF: bad image size")
    px = _unlzw_gif(bytes(data), bits, fw * fh)
    if len(px) < fw * fh:
        raise ValueError("GIF: truncated image data")
    canvas = np.full((h, w), transparency or 0, np.uint8)
    frame = np.frombuffer(px, np.uint8).reshape(fh, fw)
    rows = _interlaced_rows(fh) if lflags & 64 else list(range(fh))
    canvas[[y0 + r for r in rows], x0:x0 + fw] = frame
    if palette is None:
        return Decoded(canvas[:, :, None], "L")
    return Decoded(canvas[:, :, None], "P", np.frombuffer(palette, np.uint8).reshape(-1, 3))


# ---- PNM / PFM -------------------------------------------------------------------

_PNM_SPACE = b" \t\n\r\v\f"


def _pnm_token(blob: bytes, pos: int):
    """PpmImagePlugin._read_token -> (token, position past its whitespace)."""
    tok = bytearray()
    while len(tok) <= 10 and pos < len(blob):
        c = blob[pos]
        pos += 1
        if c in _PNM_SPACE:
            if not tok:
                continue
            break
        if c == ord("#"):
            while pos < len(blob) and blob[pos] not in b"\r\n":
                pos += 1
            pos += pos < len(blob)
            continue
        tok.append(c)
    if not tok:
        raise ValueError("PNM: the header ends early")
    if len(tok) > 10:
        raise ValueError("PNM: token too long in the header")
    return bytes(tok), pos


def _pnm_int(tok: bytes) -> int:
    if not tok.lstrip(b"+-").isdigit():
        raise ValueError("PNM: bad number in the header")
    return int(tok)


def _strip_comments(body: bytes) -> bytes:
    return re.sub(rb"#[^\r\n]*(\r|\n)?", b"", body)


def _decode_pnm(blob: bytes) -> Decoded:
    pos, magic = 0, bytearray()
    while pos < len(blob) and len(magic) < 6 and blob[pos] not in _PNM_SPACE:
        magic.append(blob[pos])
        pos += 1
    if pos < len(blob) and len(magic) < 6:
        pos += 1
    if bytes(magic) not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf"):
        raise ValueError(f"PNM: magic {bytes(magic).decode('latin-1')} is not supported")
    tok, pos = _pnm_token(blob, pos)
    w = _pnm_int(tok)
    tok, pos = _pnm_token(blob, pos)
    h = _pnm_int(tok)
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError("PNM: bad image size")
    kind = chr(magic[1])
    if kind == "f":
        tok, pos = _pnm_token(blob, pos)
        try:
            scale = float(tok)
        except ValueError:
            scale = 0.0
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("PFM: the scale must be finite and non-zero")
        if pos + 4 * w * h > len(blob):
            raise ValueError("PFM: truncated image data")
        data = np.frombuffer(blob, "<f4" if scale < 0 else ">f4", w * h, pos).reshape(h, w)
        return Decoded(np.ascontiguousarray(data[::-1, :, None], np.float32), "F")
    if kind == "4":
        stride = (w + 7) // 8
        if pos + stride * h > len(blob):
            raise ValueError("PBM: truncated image data")
        rows = np.frombuffer(blob, np.uint8, stride * h, pos).reshape(h, stride)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return Decoded((1 - bits)[:, :, None].astype(np.uint8), "1")
    if kind == "1":
        body = bytes(c for c in _strip_comments(blob[pos:]) if c not in _PNM_SPACE)
        if body.strip(b"01"):
            raise ValueError("PBM: invalid token in the data")
        if len(body) < w * h:
            raise ValueError("PBM: truncated image data")
        bits = np.frombuffer(body[:w * h], np.uint8).reshape(h, w) == ord("0")
        return Decoded(bits[:, :, None].astype(np.uint8), "1")
    tok, pos = _pnm_token(blob, pos)
    maxval = _pnm_int(tok)
    if not 0 < maxval < 65536:
        raise ValueError("PNM: maxval must be in 1..65535")
    bands = 3 if kind in "36" else 1
    wide = bands == 1 and maxval > 255
    out_max, count = (65535 if wide else 255), w * h * bands
    if kind in "23":
        tokens = _strip_comments(blob[pos:]).split()[:count]
        if any(len(t) > 10 for t in tokens):
            raise ValueError("PNM: token too long in the data")
        v = np.array([_pnm_int(t) for t in tokens], np.int64)
        if (v < 0).any() or (v > maxval).any():
            raise ValueError("PNM: sample out of range")
        if len(v) < count:
            raise ValueError("PNM: truncated image data")
        vals = np.rint(v / maxval * out_max).astype(np.int64)
    else:
        two = maxval > 255
        if pos + count * (2 if two else 1) > len(blob):
            raise ValueError("PNM: truncated image data")
        v = np.frombuffer(blob, ">u2" if two else np.uint8, count, pos).astype(np.int64)
        if maxval == 255 or (wide and maxval == 65535):
            vals = v
        else:
            vals = np.minimum(out_max, np.rint(v / maxval * out_max)).astype(np.int64)
    vals = vals.reshape(h, w, bands)
    if wide:
        return Decoded(vals.astype(np.int32), "I")
    return Decoded(vals.astype(np.uint8), "RGB" if bands == 3 else "L")
