"""The plain Python/numpy twin of ``csrc/image_j2k.cpp``: JPEG 2000
codestreams and JP2 files as PIL 12 reads them through OpenJPEG 2.5.

The decoder follows OpenJPEG's arithmetic where the standard leaves room:
tier-1 reconstructs at the middle of the last decoded interval (values are
held doubled, as OpenJPEG holds them), the reversible path halves them with
C's truncating division, the irreversible path multiplies by half the
band's step size in float32; the 9/7 synthesis scales by K and 1.625732422
first
and runs its four lifting steps in float32 in OpenJPEG's order; the ICT
and the rounding (``lrintf``, half to even) and clipping after the DC
shift are OpenJPEG's.  PIL then unpacks the components into its mode
(``Jpeg2KDecode.c``): L or I;16 (one component, by precision), LA, RGB,
RGBA, CMYK, or P for a JP2 palette, shifting a precision other than 8 (16 for
I;16), offsetting a signed one and converting sYCC with its integer YCbCr
tables.  ``images_plain.decode`` uses ``decode``; the tests hold the
library to it.
"""
from __future__ import annotations

import numpy as np

from .images import Decoded
from .images_plain_more import MAX_PIXELS

# ---- the MQ decoder (ITU-T T.800 Annex C, OpenJPEG's mqc.c) ------------------------

# (Qe, next index after an MPS, after an LPS, switch)
_MQ_TABLE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0)]

# contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run length, 18 uniform
_CTX_RL, _CTX_UNI = 17, 18


class _MQ:
    """OpenJPEG's MQ decoder over one code-block segment (two 0xFF bytes
    appended, as opj_mqc_init_dec appends them)."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + b"\xff\xff"
        self.index = [0] * 19
        self.mps = [0] * 19
        self.index[_CTX_UNI], self.index[_CTX_RL], self.index[0] = 46, 3, 4
        self.bp = 0
        self.c = (self.data[0] << 16) if data else 0xFF << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        d, bp = self.data, self.bp
        if d[bp] == 0xFF:
            if d[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += d[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += d[bp + 1] << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        i = self.index[cx]
        qe, nmps, nlps, switch = _MQ_TABLE[i]
        mps = self.mps[cx]
        a = self.a - qe
        if (self.c >> 16) < qe:
            if a < qe:
                d = mps
                self.index[cx] = nmps
            else:
                d = 1 - mps
                if switch:
                    self.mps[cx] = d
                self.index[cx] = nlps
            a = qe
        else:
            self.c -= qe << 16
            if a & 0x8000:
                self.a = a
                return mps
            if a < qe:
                d = 1 - mps
                if switch:
                    self.mps[cx] = d
                self.index[cx] = nlps
            else:
                d = mps
                self.index[cx] = nmps
        while True:                       # RENORMD
            if self.ct == 0:
                self._bytein()
            a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if a & 0x8000:
                break
        self.a = a
        return d


# ---- tier-1 (EBCOT, T.800 Annex D) -----------------------------------------------------

def _zc_table(orient: int) -> list:
    """Zero-coding context by (h, v, d) neighbour counts; HL swaps h and v."""
    out = [0] * 45
    for h in range(3):
        for v in range(3):
            for d in range(5):
                hh, vv = (v, h) if orient == 1 else (h, v)
                if orient == 3:
                    hv = hh + vv
                    if d >= 3:
                        n = 8
                    elif d == 2:
                        n = 7 if hv >= 1 else 6
                    elif d == 1:
                        n = 5 if hv >= 2 else (4 if hv == 1 else 3)
                    else:
                        n = 2 if hv >= 2 else hv
                elif hh == 2:
                    n = 8
                elif hh == 1:
                    n = 7 if vv >= 1 else (6 if d >= 1 else 5)
                elif vv == 2:
                    n = 4
                elif vv == 1:
                    n = 3
                else:
                    n = 2 if d >= 2 else d
                out[(h * 3 + v) * 5 + d] = n
    return out


_ZC = [_zc_table(o) for o in range(4)]
# sign context and the bit it is XORed with, by clipped (H, V) contributions
_SC = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0), (0, 0): (9, 0),
       (0, -1): (10, 1), (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}


def _t1_decode(data: bytes, passes: int, numbps: int, orient: int, w: int, h: int) -> list:
    """One code-block's coefficients (row-major, doubled as OpenJPEG holds
    them) from its segment's bytes and pass count."""
    stride = w + 2
    size = stride * (h + 2)
    sig, neg, visited, refined = [0] * size, [0] * size, [0] * size, [0] * size
    val = [0] * size
    if passes == 0:
        return [0] * (w * h)
    mq = _MQ(data)
    zc = _ZC[orient]
    dec = mq.decode

    def zc_ctx(i):
        hh = sig[i - 1] + sig[i + 1]
        vv = sig[i - stride] + sig[i + stride]
        dd = sig[i - stride - 1] + sig[i - stride + 1] + sig[i + stride - 1] + sig[i + stride + 1]
        return zc[(hh * 3 + vv) * 5 + dd]

    def contrib(j):
        return (1 - 2 * neg[j]) if sig[j] else 0

    def sign_decode(i, oph):
        hc = contrib(i - 1) + contrib(i + 1)
        vc = contrib(i - stride) + contrib(i + stride)
        ctx, xor = _SC[(max(-1, min(1, hc)), max(-1, min(1, vc)))]
        s = dec(ctx) ^ xor
        neg[i] = s
        sig[i] = 1
        val[i] = -oph if s else oph

    def neighbours(i):
        return (sig[i - 1] or sig[i + 1] or sig[i - stride] or sig[i + stride]
                or sig[i - stride - 1] or sig[i - stride + 1] or sig[i + stride - 1]
                or sig[i + stride + 1])

    bpno, kind = numbps, 2
    for _ in range(passes):
        one = 1 << bpno if bpno >= 0 else 0
        half = one >> 1
        oph = one | half
        for k in range(0, h, 4):
            rows = range(k, min(k + 4, h))
            for x in range(w):
                base = stride * (k + 1) + x + 1
                if kind == 0:                      # significance propagation
                    for y in rows:
                        i = base + stride * (y - k)
                        if not sig[i] and neighbours(i):
                            if dec(zc_ctx(i)):
                                sign_decode(i, oph)
                            visited[i] = 1
                elif kind == 1:                    # magnitude refinement
                    for y in rows:
                        i = base + stride * (y - k)
                        if sig[i] and not visited[i]:
                            ctx = 16 if refined[i] else (15 if neighbours(i) else 14)
                            bit = dec(ctx)
                            val[i] += half if bit ^ (val[i] < 0) else -half
                            refined[i] = 1
                else:                              # cleanup
                    start = k
                    if k + 4 <= h and all(not sig[base + stride * r] and not visited[
                            base + stride * r] and not neighbours(base + stride * r)
                            for r in range(4)):
                        if not dec(_CTX_RL):
                            continue
                        r = dec(_CTX_UNI) << 1
                        r |= dec(_CTX_UNI)
                        sign_decode(base + stride * r, oph)
                        start = k + r + 1
                    for y in range(start, min(k + 4, h)):
                        i = base + stride * (y - k)
                        if not sig[i] and not visited[i]:
                            if dec(zc_ctx(i)):
                                sign_decode(i, oph)
                    for y in rows:
                        visited[base + stride * (y - k)] = 0
        kind += 1
        if kind == 3:
            kind = 0
            bpno -= 1
    return [val[stride * (y + 1) + x + 1] for y in range(h) for x in range(w)]


# ---- tier-2 (T.800 Annex B) -------------------------------------------------------------

class _Bits:
    """opj_bio: packet-header bits, a byte after 0xFF giving seven."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = 0
        self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < self.end:
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """opj_bio_inalign; the position after the header."""
        if (self.buf & 0xFF) == 0xFF:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < self.end:
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct = 0
        return self.pos


class _TagTree:
    """opj_tgt: a tag tree over w x h leaves."""

    def __init__(self, w: int, h: int):
        self.parent = []
        levels = []
        lw, lh = w, h
        while True:
            levels.append((lw, lh))
            if lw * lh <= 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        starts = [0]
        for lw, lh in levels:
            starts.append(starts[-1] + lw * lh)
        self.parent = [-1] * starts[-1]
        for li, (lw, lh) in enumerate(levels[:-1]):
            pw = levels[li + 1][0]
            for y in range(lh):
                for x in range(lw):
                    self.parent[starts[li] + y * lw + x] = starts[li + 1] + (y >> 1) * pw + (x >> 1)
        self.value = [999] * starts[-1]
        self.low = [0] * starts[-1]

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceilpow2(a: int, e: int) -> int:
    return -((-a) >> e)


class _Block:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "lenbits", "passes", "data", "included")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps, self.lenbits, self.passes = 0, 3, 0
        self.data = bytearray()
        self.included = False


class _Band:
    def __init__(self, orient, x0, y0, x1, y1, numbps, stepsize):
        self.orient = orient
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps, self.stepsize = numbps, stepsize
        self.precincts = []   # per precinct: (code-blocks, inclusion tree, zero bit-plane tree)

    def empty(self) -> bool:
        return self.x0 >= self.x1 or self.y0 >= self.y1


class _Res:
    def __init__(self, x0, y0, x1, y1, pdx, pdy):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pdx, self.pdy = pdx, pdy
        px0, py0 = (x0 >> pdx) << pdx, (y0 >> pdy) << pdy
        px1, py1 = _ceilpow2(x1, pdx) << pdx, _ceilpow2(y1, pdy) << pdy
        self.pw = 0 if x0 == x1 else (px1 - px0) >> pdx
        self.ph = 0 if y0 == y1 else (py1 - py0) >> pdy
        self.px0, self.py0 = px0, py0
        self.bands = []


class _Style:
    """A component's coding style (COD / COC) and quantisation (QCD / QCC)."""

    def __init__(self):
        self.levels, self.xcb, self.ycb, self.cblksty, self.qmfbid = 5, 6, 6, 0, 1
        self.precincts = None   # [(ppx, ppy)] per resolution, or None (15, 15)
        self.qntsty, self.guard, self.steps = 0, 2, []
        self.roishift = 0


def _refuse(feature: str):
    raise ValueError(f"JPEG 2000: {feature} is not supported")


class _Codestream:
    """The main header, the tile-parts and the tiles of a codestream."""

    def __init__(self, cs: bytes):
        self.cs = cs
        if cs[:4] != b"\xff\x4f\xff\x51":
            raise ValueError("JPEG 2000: no SOC and SIZ at the codestream's start")
        pos = 4
        lsiz = int.from_bytes(cs[pos:pos + 2], "big")
        siz = cs[pos:pos + lsiz]
        if len(siz) < 38 + 3:
            raise ValueError("JPEG 2000: truncated SIZ")
        self.rsiz = int.from_bytes(siz[2:4], "big")
        (self.xsiz, self.ysiz, self.xosiz, self.yosiz, self.xtsiz, self.ytsiz, self.xtosiz,
         self.ytosiz) = (int.from_bytes(siz[4 + 4 * k:8 + 4 * k], "big") for k in range(8))
        self.ncomp = int.from_bytes(siz[36:38], "big")
        if self.rsiz & 0x4000:
            _refuse("HTJ2K (Part 15)")
        if not 1 <= self.ncomp <= 4 or len(siz) < 38 + 3 * self.ncomp:
            raise ValueError(f"JPEG 2000: {self.ncomp} components")
        self.prec, self.sgnd, self.dx, self.dy = [], [], [], []
        for c in range(self.ncomp):
            ssiz, dx, dy = siz[38 + 3 * c:41 + 3 * c]
            if not dx or not dy:
                raise ValueError("JPEG 2000: bad component subsampling")
            self.prec.append((ssiz & 0x7F) + 1)
            self.sgnd.append(ssiz >> 7)
            self.dx.append(dx)
            self.dy.append(dy)
        if any(p > 31 for p in self.prec):
            _refuse("a precision above 31 bits")
        w, h = self.xsiz - self.xosiz, self.ysiz - self.yosiz
        if (self.xsiz <= self.xosiz or self.ysiz <= self.yosiz or not self.xtsiz
                or not self.ytsiz or self.xtosiz > self.xosiz or self.ytosiz > self.yosiz
                or self.xtosiz + self.xtsiz <= self.xosiz
                or self.ytosiz + self.ytsiz <= self.yosiz):
            raise ValueError("JPEG 2000: bad image or tile geometry")
        if w > MAX_PIXELS or h > MAX_PIXELS or w * h > MAX_PIXELS:
            raise ValueError("JPEG 2000: bad image size")
        self.tiles_x = _ceildiv(self.xsiz - self.xtosiz, self.xtsiz)
        self.tiles_y = _ceildiv(self.ysiz - self.ytosiz, self.ytsiz)
        if self.tiles_x * self.tiles_y > 65535:     # OpenJPEG's limit; Isot has 16 bits
            raise ValueError(f"JPEG 2000: a tile size giving {self.tiles_x} x {self.tiles_y} "
                             "tiles, above 65535")
        pos += lsiz
        self.main = self._header(pos, None)
        pos = self.main.pop("end")
        self.tile_data = {}
        self.tile_head = {}
        self.packed = {}      # tile -> its packed packet headers (PPM / PPT)
        ppm = b"".join(seg for _, seg in sorted(self.main["ppm"], key=lambda e: e[0]))
        ppm_pos = 0
        ppt = {}
        while pos + 2 <= len(cs):
            marker = int.from_bytes(cs[pos:pos + 2], "big")
            if marker == 0xFFD9:
                break
            if marker != 0xFF90:
                raise ValueError(f"JPEG 2000: marker {marker:04X} where SOT belongs")
            start = pos
            isot = int.from_bytes(cs[pos + 4:pos + 6], "big")
            psot = int.from_bytes(cs[pos + 6:pos + 10], "big")
            if isot >= self.tiles_x * self.tiles_y:
                raise ValueError("JPEG 2000: bad tile index")
            head = self._header(pos + 12, isot)
            body = head.pop("end")
            end = len(cs) if psot == 0 else start + psot
            if end > len(cs):
                end = len(cs)
            if isot not in self.tile_head:
                self.tile_head[isot] = head
            else:
                for key in ("cod", "coc", "qcd", "qcc"):
                    if head.get(key):
                        raise ValueError("JPEG 2000: coding style in a later tile-part")
                self.tile_head[isot]["poc"] += head["poc"]
            self.tile_data.setdefault(isot, bytearray()).extend(cs[body:end])
            if ppm and head["ppt"]:
                raise ValueError("JPEG 2000: both PPM and PPT")
            if ppm:     # Nppm, then that many bytes of Ippm, for each tile-part
                n = int.from_bytes(ppm[ppm_pos:ppm_pos + 4], "big")
                if ppm_pos + 4 + n > len(ppm):
                    raise ValueError("JPEG 2000: truncated PPM")
                self.packed.setdefault(isot, bytearray()).extend(ppm[ppm_pos + 4:ppm_pos + 4 + n])
                ppm_pos += 4 + n
            ppt.setdefault(isot, []).extend(head["ppt"])
            if psot == 0:
                break
            pos = end
        for isot, segs in ppt.items():
            if segs:
                self.packed[isot] = b"".join(seg for _, seg in sorted(segs, key=lambda e: e[0]))

    def _header(self, pos: int, tile):
        """Markers from ``pos`` to SOD (a tile-part) or the first SOT."""
        cs = self.cs
        out = {"cod": None, "coc": {}, "qcd": None, "qcc": {}, "poc": [], "ppm": [], "ppt": [],
               "rgn": {}}
        while True:
            if pos + 2 > len(cs):
                raise ValueError("JPEG 2000: truncated header")
            marker = int.from_bytes(cs[pos:pos + 2], "big")
            if tile is None and marker == 0xFF90 or tile is not None and marker == 0xFF93:
                out["end"] = pos + (2 if marker == 0xFF93 else 0)
                return out
            if marker < 0xFF30:
                raise ValueError(f"JPEG 2000: bad marker {marker:04X}")
            length = int.from_bytes(cs[pos + 2:pos + 4], "big")
            seg = cs[pos + 4:pos + 2 + length]
            if len(seg) != length - 2:
                raise ValueError("JPEG 2000: truncated marker segment")
            if marker == 0xFF52:
                out["cod"] = seg
            elif marker == 0xFF53:
                c = seg[0] if self.ncomp < 257 else int.from_bytes(seg[:2], "big")
                out["coc"][c] = seg
            elif marker == 0xFF5C:
                out["qcd"] = seg
            elif marker == 0xFF5D:
                c = seg[0] if self.ncomp < 257 else int.from_bytes(seg[:2], "big")
                out["qcc"][c] = seg
            elif marker == 0xFF5F:
                out["poc"].append(seg)
            elif marker == 0xFF5E:      # RGN: Crgn, Srgn (0: max-shift), SPrgn
                if len(seg) < 3:
                    raise ValueError("JPEG 2000: truncated RGN")
                if seg[1] != 0:
                    _refuse(f"region of interest style {seg[1]}")
                out["rgn"][seg[0]] = seg[2]
            elif marker in (0xFF60, 0xFF61) and seg:    # PPM, PPT: (Z index, the bytes)
                out["ppm" if marker == 0xFF60 else "ppt"].append((seg[0], seg[1:]))
            elif marker in (0xFF50, 0xFF59):
                _refuse("HTJ2K (Part 15)")
            elif marker not in (0xFF55, 0xFF57, 0xFF58, 0xFF63, 0xFF64):
                raise ValueError(f"JPEG 2000: marker {marker:04X} is not supported")
            pos += 2 + length

    # -- coding style -------------------------------------------------------------------

    def _styles(self, tile: int):
        """Per component: the style, the codestream's COD fields."""
        head = self.tile_head.get(tile, {"cod": None, "coc": {}, "qcd": None, "qcc": {},
                                         "rgn": {}})
        cod = head["cod"] or self.main["cod"]
        if cod is None:
            raise ValueError("JPEG 2000: no COD")
        qcd = head["qcd"] or self.main["qcd"]
        if qcd is None:
            raise ValueError("JPEG 2000: no QCD")
        scod, prog = cod[0], cod[1]
        layers, mct = int.from_bytes(cod[2:4], "big"), cod[4]
        styles = []
        for c in range(self.ncomp):
            st = _Style()
            spcod = (cod[5:], scod & 1)
            if head["cod"] is None and c in self.main["coc"]:
                spcod = self._spcoc(self.main["coc"][c])
            if c in head["coc"]:
                spcod = self._spcoc(head["coc"][c])
            self._read_spcod(st, *spcod)
            q = qcd
            if head["qcd"] is None and c in self.main["qcc"]:
                q = self.main["qcc"][c][1 if self.ncomp < 257 else 2:]
            if c in head["qcc"]:
                q = head["qcc"][c][1 if self.ncomp < 257 else 2:]
            self._read_quant(st, q)
            st.roishift = head["rgn"].get(c, self.main["rgn"].get(c, 0))
            styles.append(st)
        if scod & ~0x07:
            raise ValueError("JPEG 2000: bad coding style")
        return styles, scod, prog, layers, mct, head.get("poc") or self.main["poc"]

    def _spcoc(self, seg: bytes):
        """COC -> (its SPcoc, whether it gives precinct sizes)."""
        k = 1 if self.ncomp < 257 else 2
        return seg[k + 1:], seg[k] & 1

    def _read_spcod(self, st: _Style, sp: bytes, prec_flag: int):
        st.levels, xcb, ycb, st.cblksty, st.qmfbid = sp[0], sp[1], sp[2], sp[3], sp[4]
        if st.levels > 32:
            raise ValueError("JPEG 2000: too many decomposition levels")
        st.xcb, st.ycb = xcb + 2, ycb + 2
        if st.xcb > 10 or st.ycb > 10 or st.xcb + st.ycb > 12:
            raise ValueError("JPEG 2000: bad code-block size")
        if st.cblksty & 0x40:
            _refuse("HTJ2K (Part 15)")
        if st.cblksty:
            _refuse(f"code-block style {st.cblksty:#04x}")
        if st.qmfbid > 1:
            raise ValueError("JPEG 2000: bad wavelet transform")
        if prec_flag:
            if len(sp) < 5 + st.levels + 1:
                raise ValueError("JPEG 2000: truncated precinct sizes")
            st.precincts = [(b & 15, b >> 4) for b in sp[5:6 + st.levels]]
            for r, (ppx, ppy) in enumerate(st.precincts):
                if r and (ppx == 0 or ppy == 0):
                    raise ValueError("JPEG 2000: bad precinct size")
        else:
            st.precincts = None

    def _read_quant(self, st: _Style, q: bytes):
        st.qntsty, st.guard = q[0] & 0x1F, q[0] >> 5
        if st.qntsty == 0:
            st.steps = [(b >> 3, 0) for b in q[1:]]
        elif st.qntsty in (1, 2):
            raw = [int.from_bytes(q[1 + 2 * k:3 + 2 * k], "big") for k in range((len(q) - 1) // 2)]
            st.steps = [(v >> 11, v & 0x7FF) for v in raw]
        else:
            raise ValueError("JPEG 2000: bad quantisation style")
        nbands = 3 * st.levels + 1
        if st.qntsty == 1:
            if not st.steps:
                raise ValueError("JPEG 2000: no step size")
            e0, m0 = st.steps[0]
            st.steps = [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, nbands)]
        if len(st.steps) < nbands:
            raise ValueError("JPEG 2000: too few step sizes")

    # -- one tile ---------------------------------------------------------------------

    def tile_rect(self, t: int):
        p, q = t % self.tiles_x, t // self.tiles_x
        return (max(self.xtosiz + p * self.xtsiz, self.xosiz),
                max(self.ytosiz + q * self.ytsiz, self.yosiz),
                min(self.xtosiz + (p + 1) * self.xtsiz, self.xsiz),
                min(self.ytosiz + (q + 1) * self.ytsiz, self.ysiz))

    def decode_tile(self, t: int) -> list:
        """The tile's components after the DC shift and clipping, [h, w] int64 each."""
        styles, scod, prog, layers, mct, pocs = self._styles(t)
        tx0, ty0, tx1, ty1 = self.tile_rect(t)
        comps = []
        for c, st in enumerate(styles):
            nres = st.levels + 1
            res_list = []
            # the tile-component on its own grid
            tcx0, tcy0 = _ceildiv(tx0, self.dx[c]), _ceildiv(ty0, self.dy[c])
            tcx1, tcy1 = _ceildiv(tx1, self.dx[c]), _ceildiv(ty1, self.dy[c])
            for r in range(nres):
                lev = nres - 1 - r
                rx0, ry0 = _ceilpow2(tcx0, lev), _ceilpow2(tcy0, lev)
                rx1, ry1 = _ceilpow2(tcx1, lev), _ceilpow2(tcy1, lev)
                pdx, pdy = st.precincts[r] if st.precincts else (15, 15)
                res = _Res(rx0, ry0, rx1, ry1, pdx, pdy)
                if r == 0:
                    cbgx, cbgy, cbw, cbh = res.px0, res.py0, pdx, pdy
                else:
                    cbgx, cbgy = _ceilpow2(res.px0, 1), _ceilpow2(res.py0, 1)
                    cbw, cbh = pdx - 1, pdy - 1
                xcb, ycb = min(st.xcb, cbw), min(st.ycb, cbh)
                for b in ([0] if r == 0 else [1, 2, 3]):
                    if r == 0:
                        bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                        lev_b = lev
                    else:
                        xo, yo = b & 1, b >> 1
                        lev_b = lev + 1
                        bx0 = _ceilpow2(tcx0 - (xo << lev), lev_b)
                        by0 = _ceilpow2(tcy0 - (yo << lev), lev_b)
                        bx1 = _ceilpow2(tcx1 - (xo << lev), lev_b)
                        by1 = _ceilpow2(tcy1 - (yo << lev), lev_b)
                    step_i = 0 if r == 0 else 3 * (r - 1) + b
                    expn, mant = st.steps[step_i]
                    gain = 0 if st.qmfbid == 0 else (0, 1, 1, 2)[b]
                    numbps_img = self.prec[c] + gain
                    stepsize = np.float32((1.0 + mant / 2048.0) * 2.0 ** (numbps_img - expn))
                    band = _Band(b, bx0, by0, bx1, by1, expn + st.guard - 1, stepsize)
                    for pno in range(res.pw * res.ph):
                        gx0 = cbgx + (pno % res.pw) * (1 << cbw)
                        gy0 = cbgy + (pno // res.pw) * (1 << cbh)
                        px0, py0 = max(gx0, bx0), max(gy0, by0)
                        px1, py1 = min(gx0 + (1 << cbw), bx1), min(gy0 + (1 << cbh), by1)
                        sx, sy = (px0 >> xcb) << xcb, (py0 >> ycb) << ycb
                        cw = max(0, ((_ceilpow2(px1, xcb) << xcb) - sx) >> xcb)
                        ch = max(0, ((_ceilpow2(py1, ycb) << ycb) - sy) >> ycb)
                        if px0 >= px1 or py0 >= py1:
                            cw = ch = 0
                        blocks = []
                        for k in range(cw * ch):
                            cx0 = sx + (k % cw) * (1 << xcb)
                            cy0 = sy + (k // cw) * (1 << ycb)
                            blocks.append(_Block(max(cx0, px0), max(cy0, py0),
                                                 min(cx0 + (1 << xcb), px1),
                                                 min(cy0 + (1 << ycb), py1)))
                        band.precincts.append((blocks, _TagTree(cw, ch), _TagTree(cw, ch)))
                    res.bands.append(band)
                res_list.append(res)
            comps.append(res_list)
        self._tier2(t, comps, scod, prog, layers, pocs, (tx0, ty0, tx1, ty1))
        return self._reconstruct(comps, styles, mct)

    def _packets(self, comps, prog, layers, pocs, rect):
        """(layer, resolution, component, precinct) in opj_pi_next's order:
        the COD's progression, or one pass per POC entry (RSpoc, CSpoc,
        LYEpoc, REpoc, CEpoc (0: 256), Ppoc), each packet once."""
        nc, max_res = len(comps), max(len(r) for r in comps)
        entries = [(prog, 0, max_res, 0, nc, layers)]
        if pocs:
            entries = [(e[6], e[0], min(e[4], max_res), e[1], min(e[5] or 256, nc),
                        min(int.from_bytes(e[2:4], "big"), layers))
                       for seg in pocs for e in (seg[k:k + 7]
                                                 for k in range(0, len(seg) - 6, 7))]
        include = set()
        for order, r0, r1, c0, c1, l1 in entries:
            if order > 4:
                raise ValueError("JPEG 2000: bad progression order")
            yield from self._order(order, r0, r1, c0, c1, l1, comps, include, rect)

    def _order(self, order, r0, r1, c0, c1, l1, comps, include, rect):
        tx0, ty0, tx1, ty1 = rect

        def emit(l, r, c, p):
            key = (l, r, c, p)
            if key in include:
                return False
            include.add(key)
            return True

        if order in (0, 1):     # LRCP, RLCP
            outer = ((l, r) for l in range(l1) for r in range(r0, r1)) if order == 0 else \
                ((l, r) for r in range(r0, r1) for l in range(l1))
            for l, r in outer:
                for c in range(c0, c1):
                    if r >= len(comps[c]):
                        continue
                    res = comps[c][r]
                    for p in range(res.pw * res.ph):
                        if emit(l, r, c, p):
                            yield l, r, c, p
            return

        def precinct_at(c, r, x, y):
            res_list = comps[c]
            if r >= len(res_list):
                return None
            res = res_list[r]
            lev = len(res_list) - 1 - r
            sx, sy = self.dx[c] << lev, self.dy[c] << lev
            trx0, try0 = _ceildiv(tx0, sx), _ceildiv(ty0, sy)
            trx1, try1 = _ceildiv(tx1, sx), _ceildiv(ty1, sy)
            rpx, rpy = res.pdx + lev, res.pdy + lev
            if rpx >= 31 or rpy >= 31:
                return None
            if not (y % (self.dy[c] << rpy) == 0 or (y == ty0 and (try0 << lev) % (1 << rpy))):
                return None
            if not (x % (self.dx[c] << rpx) == 0 or (x == tx0 and (trx0 << lev) % (1 << rpx))):
                return None
            if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
                return None
            prci = (_ceildiv(x, sx) >> res.pdx) - (trx0 >> res.pdx)
            prcj = (_ceildiv(y, sy) >> res.pdy) - (try0 >> res.pdy)
            return prci + prcj * res.pw

        def steps(cs_):
            dx = dy = 0
            for c in cs_:
                for r, res in enumerate(comps[c]):
                    lev = len(comps[c]) - 1 - r
                    ddx, ddy = self.dx[c] << (res.pdx + lev), self.dy[c] << (res.pdy + lev)
                    dx = ddx if not dx else min(dx, ddx)
                    dy = ddy if not dy else min(dy, ddy)
            return dx, dy

        def positions(dx, dy):
            y = ty0
            while y < ty1:
                x = tx0
                while x < tx1:
                    yield x, y
                    x += dx - (x % dx)
                y += dy - (y % dy)

        if order == 2:          # RPCL
            dx, dy = steps(range(len(comps)))
            for r in range(r0, r1):
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(l1):
                            if emit(l, r, c, p):
                                yield l, r, c, p
        elif order == 3:        # PCRL
            dx, dy = steps(range(len(comps)))
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, len(comps[c]))):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(l1):
                            if emit(l, r, c, p):
                                yield l, r, c, p
        else:                   # CPRL
            for c in range(c0, c1):
                dx, dy = steps([c])
                for x, y in positions(dx, dy):
                    for r in range(r0, min(r1, len(comps[c]))):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(l1):
                            if emit(l, r, c, p):
                                yield l, r, c, p

    def _tier2(self, t, comps, scod, prog, layers, pocs, rect):
        """Packet headers (from the tile's data, or from its PPT / PPM
        packed headers) and the code-blocks' bytes."""
        data = bytes(self.tile_data.get(t, b""))
        packed = self.packed.get(t)
        hdr = data if packed is None else bytes(packed)
        pos, hpos, end = 0, 0, len(data)
        for l, r, c, p in self._packets(comps, prog, layers, pocs, rect):
            if pos >= end if packed is None else hpos >= len(hdr):
                break
            if scod & 2 and pos + 6 <= end and data[pos] == 0xFF and data[pos + 1] == 0x91:
                pos += 6
            if packed is None:
                hpos = pos
            res = comps[c][r]
            bits = _Bits(hdr, hpos, len(hdr))
            included = []
            if bits.bit():
                for band in res.bands:
                    if band.empty():
                        continue
                    blocks, incl, imsb = band.precincts[p]
                    for k, blk in enumerate(blocks):
                        if not blk.included:
                            inc = incl.decode(bits, k, l + 1)
                        else:
                            inc = bits.bit()
                        if not inc:
                            continue
                        if not blk.included:
                            i = 0
                            while not imsb.decode(bits, k, i):
                                i += 1
                            blk.numbps = band.numbps + 1 - i
                            blk.lenbits = 3
                            blk.included = True
                        n = self._numpasses(bits)
                        while bits.bit():
                            blk.lenbits += 1
                        length = bits.bits(blk.lenbits + (n.bit_length() - 1))
                        included.append((blk, n, length))
            hpos = bits.align()
            if scod & 4 and hdr[hpos:hpos + 2] == b"\xff\x92":
                hpos += 2
            if packed is None:
                pos = hpos
            for blk, n, length in included:
                if pos + length > end:
                    length = max(0, end - pos)
                blk.data += data[pos:pos + length]
                blk.passes += n
                pos += length

    @staticmethod
    def _numpasses(bits: _Bits) -> int:
        if not bits.bit():
            return 1
        if not bits.bit():
            return 2
        n = bits.bits(2)
        if n != 3:
            return 3 + n
        n = bits.bits(5)
        if n != 31:
            return 6 + n
        return 37 + bits.bits(7)

    def _reconstruct(self, comps, styles, mct) -> list:
        planes = []
        for c, (res_list, st) in enumerate(zip(comps, styles)):
            rev = st.qmfbid == 1
            bands_img = []
            for r, res in enumerate(res_list):
                per = []
                for band in res.bands:
                    arr = np.zeros((max(band.y1 - band.y0, 0), max(band.x1 - band.x0, 0)),
                                   np.int64 if rev else np.float32)
                    half = np.float32(0.5) * band.stepsize
                    for prec in band.precincts:
                        for blk in prec[0]:
                            w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
                            if w <= 0 or h <= 0:
                                continue
                            if blk.numbps + st.roishift >= 31:
                                raise ValueError("JPEG 2000: too many bit-planes")
                            vals = np.array(_t1_decode(bytes(blk.data), blk.passes,
                                                       blk.numbps + st.roishift, band.orient, w,
                                                       h), np.int64).reshape(h, w)
                            if st.roishift:     # max-shift: the region's magnitudes back down
                                mag = np.abs(vals)
                                vals = np.where(mag >= 1 << st.roishift,
                                                np.sign(vals) * (mag >> st.roishift), vals)
                            if rev:
                                out = np.where(vals < 0, -((-vals) // 2), vals // 2)
                            else:
                                out = vals.astype(np.float32) * half
                            arr[blk.y0 - band.y0:blk.y1 - band.y0,
                                blk.x0 - band.x0:blk.x1 - band.x0] = out
                    per.append(arr)
                bands_img.append(per)
            img = bands_img[0][0]
            for r in range(1, len(res_list)):
                res = res_list[r]
                hl, lh, hh = bands_img[r]
                synth = _synth53 if rev else _synth97
                top = synth(img, hl, res.x0 % 2)
                bottom = synth(lh, hh, res.x0 % 2)
                img = synth(top.T, bottom.T, res.y0 % 2).T
            planes.append(img)
        if mct and len(planes) >= 3:
            if planes[0].shape != planes[1].shape or planes[0].shape != planes[2].shape:
                raise ValueError("JPEG 2000: components of unequal size under a colour transform")
            if styles[0].qmfbid == 1:
                y, u, v = planes[:3]
                g = y - ((u + v) >> 2)
                planes[:3] = [v + g, g, u + g]
            else:
                y, u, v = planes[:3]
                r_ = y + v * np.float32(1.402)
                g_ = y - u * np.float32(0.34413) - v * np.float32(0.71414)
                b_ = y + u * np.float32(1.772)
                planes[:3] = [r_, g_, b_]
        out = []
        for c, (plane, st) in enumerate(zip(planes, styles)):
            prec, sgnd = self.prec[c], self.sgnd[c]
            lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
            shift = 0 if sgnd else 1 << (prec - 1)
            if st.qmfbid == 1:
                v = plane.astype(np.int64)
            else:
                f = plane.astype(np.float32)
                big = f > np.float32(2 ** 31 - 1)
                small = f < np.float32(-2 ** 31)
                v = np.rint(np.where(big | small, 0, f)).astype(np.int64)
                v = np.where(big, hi - shift, np.where(small, lo - shift, v))
            out.append(np.clip(v + shift, lo, hi))
        return out


def _synth53(lo: np.ndarray, hi: np.ndarray, cas: int) -> np.ndarray:
    """The reversible 5/3 synthesis along the last axis (T.800 F.3, as
    OpenJPEG's opj_idwt53_h / _v compute it)."""
    rows, sn = lo.shape
    dn = hi.shape[1]
    n = sn + dn
    if n == 0:
        return np.zeros((rows, 0), np.int64)
    y = np.empty((rows, n), np.int64)
    y[:, cas::2] = lo
    y[:, 1 - cas::2] = hi
    if n == 1:
        return y if not cas else np.where(y < 0, -((-y) // 2), y // 2)
    ypad = np.concatenate([y[:, 1:2], y, y[:, n - 2:n - 1]], axis=1)
    x = y.copy()
    p = np.arange(cas, n, 2)
    x[:, p] = y[:, p] - ((ypad[:, p] + ypad[:, p + 2] + 2) >> 2)
    xpad = np.concatenate([x[:, 1:2], x, x[:, n - 2:n - 1]], axis=1)
    q = np.arange(1 - cas, n, 2)
    x[:, q] = y[:, q] + ((xpad[:, q] + xpad[:, q + 2]) >> 1)
    return x


# the lifting steps' coefficients as the synthesis applies them (T.800's
# -delta, -gamma, -beta, -alpha)
_ALPHA, _BETA = np.float32(1.586134342), np.float32(0.052980118)
_GAMMA, _DELTA = np.float32(-0.882911075), np.float32(-0.443506852)
# OpenJPEG's scale factors: K for the low band, its 13318 / 8192 for the high one
_K, _C13318 = np.float32(1.230174105), np.float32(1.625732422)


def _lift(x: np.ndarray, t: int, cnt: int, m: int, c: np.float32):
    """opj_v8dwt_decode_step2: x[t + 2i] += (left + right) * c for i < m,
    the last target (without a right neighbour) += left * 2c."""
    upto = min(cnt, m)
    if upto > 0:
        idx = t + 2 * np.arange(upto)
        left = np.where(idx - 1 >= 0, idx - 1, 1 - t)
        x[:, idx] = x[:, idx] + (x[:, left] + x[:, idx + 1]) * c
    if m < cnt:
        i = t + 2 * m
        left = i - 1 if i - 1 >= 0 else 1 - t
        x[:, i] = x[:, i] + x[:, left] * (c + c)


def _synth97(lo: np.ndarray, hi: np.ndarray, cas: int) -> np.ndarray:
    """The irreversible 9/7 synthesis along the last axis in float32, as
    OpenJPEG's opj_v8dwt_decode computes each lane."""
    rows, sn = lo.shape
    dn = hi.shape[1]
    n = sn + dn
    x = np.empty((rows, n), np.float32)
    x[:, cas::2] = lo
    x[:, 1 - cas::2] = hi
    if cas == 0 and not (dn > 0 or sn > 1) or cas == 1 and not (sn > 0 or dn > 1):
        return x
    a, b = cas, 1 - cas
    x[:, a::2] *= _K
    x[:, b::2] *= _C13318
    _lift(x, a, sn, min(sn, dn - a), _DELTA)
    _lift(x, b, dn, min(dn, sn - b), _GAMMA)
    _lift(x, a, sn, min(sn, dn - a), _BETA)
    _lift(x, b, dn, min(dn, sn - b), _ALPHA)
    return x


# ---- JP2 boxes and PIL's modes ----------------------------------------------------------

_GRAY, _SRGB, _SYCC, _CMYK, _EYCC, _UNKNOWN = "gray", "srgb", "sycc", "cmyk", "eycc", None


def _boxes(blob: bytes, pos: int, end: int):
    while pos + 8 <= end:
        length = int.from_bytes(blob[pos:pos + 4], "big")
        kind = blob[pos + 4:pos + 8]
        head = 8
        if length == 1:
            length = int.from_bytes(blob[pos + 8:pos + 16], "big")
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError("JPEG 2000: bad JP2 box")
        yield kind, pos + head, pos + length
        pos += length


def _jp2(blob: bytes):
    """JP2 -> (codestream, size, mode, colour space) as PIL's
    _parse_jp2_header and OpenJPEG's jp2.c read them."""
    header = codestream = None
    for kind, start, end in _boxes(blob, 0, len(blob)):
        if kind == b"jp2h" and header is None:
            header = (start, end)
        elif kind == b"jp2c" and codestream is None:
            codestream = blob[start:end]
    if header is None or codestream is None:
        raise ValueError("JPEG 2000: no JP2 header or codestream box")
    size = mode = palette = None
    nc = 0
    enumcs = 0
    for kind, start, end in _boxes(blob, *header):
        if kind == b"ihdr":
            hgt, wid = int.from_bytes(blob[start:start + 4], "big"), int.from_bytes(
                blob[start + 4:start + 8], "big")
            nc, bpc = int.from_bytes(blob[start + 8:start + 10], "big"), blob[start + 10]
            size = (wid, hgt)
            mode = ("I;16" if bpc & 0x7F > 8 else "L") if nc == 1 else {
                2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
        elif kind == b"colr" and not enumcs:
            if blob[start] == 1:
                enumcs = int.from_bytes(blob[start + 3:start + 7], "big")
                if nc == 4 and enumcs == 12:
                    mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            palette, mode = _pclr(blob[start:end], mode)
    if size is None or mode is None:
        raise ValueError("JPEG 2000: malformed JP2 header")
    space = {16: _SRGB, 17: _GRAY, 18: _SYCC, 12: _CMYK, 24: _EYCC}.get(enumcs, _UNKNOWN)
    return codestream, size, mode, space, palette


def _pclr(body: bytes, mode: str):
    """PIL's reading of a pclr box: a palette (P) when no bit depth byte
    exceeds 8, the entries one byte a component, each new colour appended
    once (ImagePalette.getcolor); else none (the indices stay L)."""
    ne, npc = int.from_bytes(body[:2], "big"), body[2]
    if max(body[3:3 + npc], default=0) > 8:
        return None, mode
    if mode == "LA":
        _refuse("a palette with alpha (PA)")
    if npc != 3:
        _refuse(f"a palette of {npc} components")
    entries = body[3 + npc:3 + npc + 3 * ne]
    if len(entries) < 3 * ne:
        raise ValueError("JPEG 2000: truncated pclr")
    colours = list(dict.fromkeys(entries[3 * k:3 * k + 3] for k in range(ne)))
    if len(colours) > 256:
        raise ValueError("JPEG 2000: a palette of more than 256 colours")
    return np.frombuffer(b"".join(colours), np.uint8).reshape(-1, 3), "P"


# PIL's unpackers: (mode, colour space, components)
_UNPACKERS = {("L", _GRAY, 1), ("I;16", _GRAY, 1), ("LA", _GRAY, 2), ("P", _SRGB, 1),
              ("CMYK", _CMYK, 4),
              *((mode, space, n) for mode in ("RGB", "RGBA") for space in (_SRGB, _SYCC)
                for n in (3, 4))}


def _ycc_table(c: float) -> np.ndarray:
    """A table of PIL's ConvertYCbCr.c: int(c * 64 * (i - 128) + 0.5), truncated."""
    return np.trunc(c * 64 * (np.arange(256) - 128) + 0.5).astype(np.int64)


_R_CR, _G_CB, _G_CR, _B_CB = (_ycc_table(c) for c in (1.402, -0.34414, -0.71414, 1.772))


def _sycc_to_rgb(rgb: np.ndarray) -> np.ndarray:
    """PIL's ImagingConvertYCbCr2RGB (j2ku_sycc_rgb after the sRGB unpack)."""
    y, cb, cr = (rgb[..., k].astype(np.int64) for k in range(3))
    out = [y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6), y + (_B_CB[cb] >> 6)]
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def decode(blob: bytes) -> Decoded:
    """A JPEG 2000 codestream or JP2 file -> its samples in PIL's mode."""
    if blob[:4] == b"\xff\x4f\xff\x51":
        cs = _Codestream(blob)
        nc, prec0 = cs.ncomp, cs.prec[0]
        mode = ("I;16" if prec0 > 8 else "L") if nc == 1 else {2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        space, size, palette = _UNKNOWN, (cs.xsiz - cs.xosiz, cs.ysiz - cs.yosiz), None
    else:
        codestream, size, mode, space, palette = _jp2(blob)
        if size[0] > MAX_PIXELS or size[1] > MAX_PIXELS or size[0] * size[1] > MAX_PIXELS:
            raise ValueError("JPEG 2000: bad image size")
        cs = _Codestream(codestream)
    if space == _UNKNOWN:       # PIL's guess: sYCC for subsampled chroma (components 1, 2)
        chroma = cs.dx[0] == cs.dy[0] == 1 and any(d != 1 for d in cs.dx[1:3] + cs.dy[1:3])
        space = _SYCC if cs.ncomp in (3, 4) and chroma else _GRAY if cs.ncomp <= 2 else _SRGB
    if space == _EYCC:
        _refuse("the e-sYCC colour space")
    if (mode, space, cs.ncomp) not in _UNPACKERS:
        raise ValueError(f"JPEG 2000: PIL has no unpacker for {cs.ncomp} components as {mode}")
    wid, hgt = size
    subsampled = any(d != 1 for d in cs.dx + cs.dy)
    if subsampled and mode not in ("RGB", "RGBA", "CMYK"):
        _refuse(f"a subsampled component in mode {mode}")
    bits = 16 if mode == "I;16" else 8
    channels = {"L": 1, "P": 1, "I;16": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    out = np.zeros((hgt, wid, channels), np.uint16 if bits == 16 else np.uint8)
    used = min(cs.ncomp, channels)
    csiz = [4 if (p + 7) >> 3 == 3 else (p + 7) >> 3 for p in cs.prec]
    for t in range(cs.tiles_x * cs.tiles_y):
        tx0, ty0, tx1, ty1 = cs.tile_rect(t)
        x0, y0, w, h = tx0 - cs.xosiz, ty0 - cs.yosiz, tx1 - tx0, ty1 - ty0
        if tx0 >= tx1 or ty0 >= ty1 or x0 + w > wid or y0 + h > hgt:
            raise ValueError("JPEG 2000: a tile outside the image")
        planes = cs.decode_tile(t)
        # PIL's tile buffer: OpenJPEG's tile data (each component's samples
        # in csiz bytes), then zeros up to w * h * (the sum of csiz) bytes
        # (Jpeg2KDecode.c zeroes that much for each tile).  PIL finds
        # component n at the sum of the earlier ones' csiz * (w / dx) *
        # (h / dy) and sample (x, y) of it at (y / dy) * (w / dx) + x / dx,
        # in integer division, which can reach past the data
        data = np.frombuffer(b"".join(
            (plane & ((1 << (8 * n)) - 1)).astype(f"<u{n}").tobytes()
            for plane, n in zip(planes, csiz)), np.uint8)
        buf = np.zeros(max(len(data), w * h * sum(csiz)), np.int64)
        buf[:len(data)] = data
        start = 0
        for k in range(used):
            dx, dy, n = cs.dx[k], cs.dy[k], csiz[k]
            at = start + n * ((np.arange(h)[:, None] // dy) * (w // dx)
                              + np.arange(w)[None, :] // dx)
            word = sum(buf[at + b] << (8 * b) for b in range(n))
            start += n * (w // dx) * (h // dy)
            prec, sgnd = cs.prec[k], cs.sgnd[k]
            shift = bits - prec
            offset = (1 << (prec - 1)) if sgnd else 0
            if shift < 0:
                offset += 1 << (-shift - 1)
            v = (word + offset) & 0xFFFFFFFF
            v = (v >> -shift) if shift < 0 else ((v << shift) & 0xFFFFFFFF)
            out[y0:y0 + h, x0:x0 + w, k] = v & ((1 << bits) - 1)
        if mode == "RGBA" and cs.ncomp == 3:
            out[y0:y0 + h, x0:x0 + w, 3] = 255
        if space == _SYCC:
            tile = out[y0:y0 + h, x0:x0 + w]
            tile[..., :3] = _sycc_to_rgb(tile)
    return Decoded(out, mode, palette)
