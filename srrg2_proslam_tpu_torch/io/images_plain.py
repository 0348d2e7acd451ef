"""The plain Python/numpy twin of ``csrc/image_extra.cpp``'s decoders.

``decode`` reads the same files as ``images.decode`` (JPEG baseline and
progressive Huffman, PNG of every colour type, bit depth and interlace,
uncompressed 8/24/32-bit BMP), refuses the same ones and returns the same
``Decoded`` samples: entropy decoding in Python, libjpeg-turbo's integer
IDCT, fancy upsampling and fixed-point YCbCr -> RGB vectorised in int64
numpy.  The tests and ``chip_smoke.py`` hold the library to it; nothing on
the readers' path calls it, and it is far slower than the library.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .datasets import _PNG_SIGNATURE, _unfilter
from .images import Decoded


def decode(path: str) -> Decoded:
    """A JPEG, PNG or BMP file -> its samples in PIL's mode; ValueError
    naming the file and the reason otherwise."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        if blob[:3] == b"\xff\xd8\xff":
            return _Jpeg(blob).decode()
        if blob[:8] == _PNG_SIGNATURE:
            return _decode_png(blob)
        if blob[:2] == b"BM":
            return _decode_bmp(blob)
        raise ValueError("not a JPEG, PNG or BMP file")
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
        self.qtables, self.dc, self.ac = {}, {}, {}
        self.comps, self.frame, self.progressive = [], False, False
        self.jfif = self.adobe = False
        self.adobe_transform = -1
        self.restart_interval = 0

    # ---- markers ----
    def read_frame(self, p: bytes, marker: int):
        if self.frame:
            raise ValueError("JPEG: more than one frame")
        if p[0] != 8:
            raise ValueError(f"JPEG: sample precision {p[0]} is not supported (8-bit only)")
        self.height, self.width, nc = struct.unpack(">HHB", p[1:6])
        if not self.height or not self.width:
            raise ValueError("JPEG: zero image size (DNL is not supported)")
        if nc not in (1, 3):
            raise ValueError(f"JPEG: {nc} components are not supported (gray or YCbCr/RGB "
                             "only; CMYK and YCCK are refused)")
        self.progressive = marker == 0xC2
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
            i += 17 + total

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
            if ((ss == 0 and ah == 0 and c.dc_tbl not in self.dc)
                    or (se > 0 and c.ac_tbl not in self.ac)):
                raise ValueError("JPEG: missing Huffman table")
            for k in range(ss, se + 1):
                c.coef_bits[k] = al
        intervals, end = self.scan_intervals(data_start)
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
            if m in (0xC0, 0xC1, 0xC2):
                self.read_frame(p, m)
            elif m in (0xC3, 0xC5, 0xC6, 0xC7):
                raise ValueError("JPEG: lossless and hierarchical JPEG are not supported")
            elif 0xC9 <= m <= 0xCF and m != 0xC4:
                raise ValueError("JPEG: arithmetic coding is not supported")
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
        if self.progressive:
            dc_known = all(c.coef_bits[0] >= 0 for c in self.comps)
            ac_missing = any(b != 0 for c in self.comps for b in c.coef_bits[1:10])
            if dc_known and ac_missing:
                raise ValueError("JPEG: a progressive file whose first AC coefficients are "
                                 "incomplete (block smoothing) is not supported")

    # ---- samples ----
    def plane(self, c) -> np.ndarray:
        if c.qt is None:
            raise ValueError("JPEG: a component is in no scan")
        blocks = np.array(c.coef, np.int64).reshape(c.bh, c.bw, 8, 8)
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
        planes = [self.upsample(self.plane(c), c).astype(np.int64) for c in self.comps]
        if len(planes) == 1:
            return Decoded(planes[0].astype(np.uint8)[:, :, None], "L")
        ids = [c.id for c in self.comps]
        if self.jfif:
            ycc = True
        elif self.adobe:
            ycc = self.adobe_transform != 0
        else:
            ycc = ids != [82, 71, 66]
        if not ycc:
            return Decoded(np.stack(planes, -1).astype(np.uint8), "RGB")
        yy, cb, cr = planes
        fix = lambda v: int(v * 65536.0 + 0.5)   # noqa: E731
        x = np.arange(256, dtype=np.int64) - 128
        cr_r = (fix(1.40200) * x + 32768) >> 16
        cb_b = (fix(1.77200) * x + 32768) >> 16
        cr_g, cb_g = -fix(0.71414) * x, -fix(0.34414) * x + 32768
        rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], -1)
        return Decoded(np.clip(rgb, 0, 255).astype(np.uint8), "RGB")


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

def _decode_bmp(blob: bytes) -> Decoded:
    if len(blob) < 54:
        raise ValueError("BMP: truncated header")
    offset, hsize = struct.unpack("<I", blob[10:14])[0], struct.unpack("<I", blob[14:18])[0]
    if hsize < 40:
        raise ValueError("BMP: OS/2 headers are not supported")
    width, height, _, bits, compression = struct.unpack("<iiHHI", blob[18:34])
    colors = struct.unpack("<I", blob[46:50])[0]
    if compression != 0:
        raise ValueError("BMP: compressed (RLE or bit-field) files are not supported")
    if bits not in (8, 24, 32):
        raise ValueError(f"BMP: {bits}-bit files are not supported")
    if width <= 0 or height == 0:
        raise ValueError("BMP: bad size")
    h = abs(height)
    stride = (width * bits + 31) // 32 * 4
    if offset + stride * h > len(blob):
        raise ValueError("BMP: truncated pixel data")
    rows = np.frombuffer(blob, np.uint8, stride * h, offset).reshape(h, stride)
    if height > 0:
        rows = rows[::-1]
    if bits != 8:
        px = rows[:, :width * bits // 8].reshape(h, width, bits // 8)
        return Decoded(np.ascontiguousarray(px[:, :, 2::-1]), "RGB")
    colors = colors or 256
    if colors > 256 or 14 + hsize + 4 * colors > len(blob):
        raise ValueError("BMP: bad palette")
    pal = np.frombuffer(blob, np.uint8, 4 * colors, 14 + hsize).reshape(colors, 4)
    ramp = np.array([0, 255]) if colors == 2 else np.arange(colors)
    gray = bool((pal[:, :3] == ramp[:, None]).all())
    if gray and colors == 2:
        raise ValueError("BMP: 8-bit two-colour files are not supported")
    samples = np.ascontiguousarray(rows[:, :width, None])
    return (Decoded(samples, "L") if gray
            else Decoded(samples, "P", np.ascontiguousarray(pal[:, 2::-1])))
