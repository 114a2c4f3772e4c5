"""A JPEG decoder in numpy and Python that gives the pixels libjpeg-turbo
gives ``cv2.imread`` with its default settings, bit for bit.

What it decodes: baseline and extended sequential (SOF0, SOF1) and
progressive (SOF2) Huffman-coded files with 8-bit samples, one (grey) or
three (YCbCr) components, any integer ratio of sampling factors (4:4:4,
4:2:2, 4:4:0, 4:2:0, 4:1:1), restart intervals, sizes that are no multiple of
the MCU and optimized Huffman tables.  What it refuses, with a ``ValueError``:
arithmetic coding, 12- and 16-bit samples, lossless and hierarchical files,
CMYK / YCCK and RGB-coded files (Adobe transform 0), and a progressive file
whose scans leave one of the first nine AC coefficients unrefined (libjpeg
then smooths the blocks, which is not reproduced).

The arithmetic is libjpeg's:

- the ``JDCT_ISLOW`` integer IDCT (``jidctint.c``): 13-bit constants, two
  passes (columns with ``PASS1_BITS`` 2 extra bits, then rows), ``DESCALE``
  rounding and the post-IDCT range limit;
- "fancy" chroma upsampling (``jdsample.c``): the h2v1, h1v2 and h2v2
  triangle filters with their alternating rounding biases, the image's edge
  rows and columns repeated; box replication for other integer ratios, and
  for h2 components two samples wide or less, as libjpeg does;
- the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 fraction bits).

Two implementations of the pixel path, bit for bit the same: the native one
(``csrc/host/jpeg.cpp`` through ``data.native``, the default: the Huffman
scans, the IDCT and the upsampling and colour conversion in C++, the GIL
released) and the plain one here, which ``native.plain_image_ops`` selects
per stage ("jpeg_entropy", "jpeg_idct", "jpeg_color"): the entropy decoding
in Python, the Huffman codes through a table of every 16-bit window (code,
run and, where they fit, the coefficient's bits decoded at once); the IDCT,
upsampling and colour conversion vectorised over all blocks in numpy.  The
marker parse, the tables and the Exif orientation are Python in both.
``coefficients`` gives the components' quantized coefficients (int16, as
libjpeg's ``JCOEF``), ``decode`` the components at their own sizes before
upsampling; ``read_jpeg`` gives RGB or grey uint8."""

from __future__ import annotations

import re
import struct

import numpy as np

from leftrefill_torch.data import native

# zigzag position -> natural (row-major) index in the 8x8 block
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63], np.int64)
_NAT = NATURAL.tolist()

_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
                0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded",
                0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}
_PAD = 16  # zero bytes after each entropy-coded segment (libjpeg reads zeros past a segment's end)
_SMOOTHED_COEFS = 10  # libjpeg-turbo's SAVED_COEFS: block smoothing looks at coefficients 1..9


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "coef", "width", "height")


def _canonical(counts) -> list[tuple[int, int]]:
    """(length, code) of each symbol of a DHT table in order: codes
    consecutive within a length, shifted left between lengths."""
    out, code, prev = [], 0, 1
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code <<= length - prev
            prev = length
            if code >= 1 << length:
                raise ValueError("JPEG: a bad Huffman table")
            out.append((length, code))
            code += 1
    return out


def _huffman_lut(counts, symbols, ac: bool) -> list:
    """A table over every 16-bit window of the bit stream: (bits consumed,
    run, value, pending size).  DC tables (``ac`` False): run 0 and the
    decoded difference.  AC tables: run -1 for an end of block (EOB0), and
    the run and coefficient otherwise (ZRL: run 15, value 0).  Where the
    code and the value's bits together pass 16 bits, only the code is
    consumed and ``pending size`` says how many value bits to read.  A
    window that starts no code gives None."""
    lut = [None] * 65536
    for (length, c), sym in zip(_canonical(counts), symbols):
        if ac:
            run, size = sym >> 4, sym & 15
            if size == 0 and run != 15:
                run = -1  # EOB (EOBn in progressive scans, handled by their own decoder)
        else:
            run, size = 0, sym
        lo, n = c << (16 - length), 1 << (16 - length)
        if size == 0:
            lut[lo:lo + n] = [(length, run, 0, 0)] * n
        elif length + size <= 16:
            rest = 16 - length - size
            for extra in range(1 << size):
                v = extra if extra >= (1 << (size - 1)) else extra - (1 << size) + 1
                a = lo + (extra << rest)
                lut[a:a + (1 << rest)] = [(length + size, run, v, 0)] * (1 << rest)
        else:
            lut[lo:lo + n] = [(length, run, 0, size)] * n
    return lut


def _raw_lut(counts, symbols) -> list:
    """(code length, symbol) for every 16-bit window, None where no code
    starts (the progressive scans' decoder)."""
    lut = [None] * 65536
    for (length, code), sym in zip(_canonical(counts), symbols):
        lo = code << (16 - length)
        lut[lo:lo + (1 << (16 - length))] = [(length, sym)] * (1 << (16 - length))
    return lut


def _windows(segment: bytes) -> list:
    """40-bit big-endian windows at every byte offset of a de-stuffed
    segment (padded with zeros), as Python ints."""
    d = np.frombuffer(segment + b"\x00" * _PAD, np.uint8).astype(np.int64)
    n = len(segment) + 8
    w = (d[:n] << 32) | (d[1:n + 1] << 24) | (d[2:n + 2] << 16) | (d[3:n + 3] << 8) | d[4:n + 4]
    return w.tolist()


def _destuff(seg: bytes) -> bytes:
    """0xFF (any fill 0xFFs) 0x00 -> the data byte 0xFF."""
    return re.sub(rb"\xff+\x00", b"\xff", seg) if b"\xff" in seg else seg


def _entropy_segments(data: bytes, start: int) -> tuple[list, int]:
    """The scan's entropy-coded data from ``start``, split at its restart
    markers and de-stuffed, and the offset of the marker that ends it."""
    segments, cur, i, n = [], start, start, len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0:
            segments.append(_destuff(data[cur:]))
            return segments, n
        k = j + 1
        while k < n and data[k] == 0xFF:  # fill bytes
            k += 1
        if k < n and data[k] == 0x00:  # a stuffed data byte
            i = k + 1
            continue
        segments.append(_destuff(data[cur:j]))
        if k < n and 0xD0 <= data[k] <= 0xD7:  # RSTn
            cur = i = k + 1
            continue
        return segments, j


def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 of Exif data (the TIFF
    structure after an APP1 segment's "Exif\\0\\0", or a PNG eXIf chunk);
    1 where there is none."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        p = ifd + 2 + 12 * i
        if p + 12 > len(tiff):
            break
        tag, kind, n = struct.unpack(e + "HHI", tiff[p:p + 8])
        if tag == 0x0112:
            if kind == 3:
                return struct.unpack(e + "H", tiff[p + 8:p + 10])[0]
            if kind == 4:
                return struct.unpack(e + "I", tiff[p + 8:p + 12])[0]
            return 1
    return 1


class JPEGInfo:
    """What the markers say: size, components, orientation."""

    def __init__(self):
        self.width = self.height = 0
        self.progressive = False
        self.components: list[_Component] = []
        self.orientation = 1
        self.adobe_transform = None
        self.jfif = False


def _huffman_spec(body: bytes, i: int, tc: int) -> tuple[list, list, int]:
    """(counts, symbols, offset of the next table) of the DHT table at
    ``body[i]``; refuses what libjpeg refuses (more than 256 symbols, codes
    that do not fit their lengths, DC symbols above 15) and a table cut
    short."""
    counts = list(body[i + 1:i + 17])
    total = sum(counts)
    symbols = list(body[i + 17:i + 17 + total])
    if len(counts) != 16 or total > 256 or len(symbols) != total or (tc == 0 and any(v > 15 for v in symbols)):
        raise ValueError("JPEG: a bad Huffman table")
    _canonical(counts)
    return counts, symbols, i + 17 + total


def _scan_tables(specs: dict, luts: dict, scomps: list, need_dc: bool, need_ac: bool) -> list:
    """Each scan component's (DC, AC) table the scan decodes with, as
    (counts, symbols) from ``specs`` or, where ``luts`` holds the plain
    version's tables, as those; None where the scan needs none."""
    out = []
    for _, td, ta in scomps:
        pair = []
        for need, key in ((need_dc, (0, td)), (need_ac, (1, ta))):
            if not need:
                pair.append(None)
            elif key not in specs:
                raise ValueError(f"JPEG: a scan refers to a missing Huffman table ({'DC' if key[0] == 0 else 'AC'} {key[1]})")
            else:
                pair.append(luts[key] if luts is not None else specs[key])
        out.append(tuple(pair))
    return out


def coefficients(data: bytes) -> tuple[list[_Component], JPEGInfo, dict]:
    """A JPEG file's components with their quantized coefficients
    (``coef``: int16 [bh, bw, 64], natural order within a block), its
    :class:`JPEGInfo` and its quantization tables."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    use_native = native.active("jpeg_entropy")  # one choice for the whole file
    info = JPEGInfo()
    qt: dict[int, np.ndarray] = {}
    specs: dict[tuple, tuple] = {}  # (class, id) -> (counts, symbols)
    luts: dict | None = None if use_native else {}  # the plain version's tables of the same keys
    restart = 0
    pos, n = 2, len(data)
    comps: list[_Component] = []
    coef_bits = None
    mcux = mcuy = hmax = vmax = 0
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        seg_end = pos + length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = struct.unpack(">64H", body[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(body[i + 1:i + 65])
                    i += 65
                table = np.zeros(64, np.int64)
                table[NATURAL] = vals
                qt[tq] = table
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts, symbols, i = _huffman_spec(body, i, tc)
                specs[(tc, th)] = counts, symbols
                if luts is not None:
                    luts[(tc, th)] = (_huffman_lut(counts, symbols, tc != 0), _raw_lut(counts, symbols))
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit samples are not read (8-bit only)")
            if h == 0 or w == 0:
                raise ValueError("JPEG: a zero height (DNL) or width is not read")
            if nc not in (1, 3):
                raise ValueError(f"JPEG: {nc} components (CMYK / YCCK) are not read")
            info.width, info.height, info.progressive = w, h, marker == 0xC2
            for c in range(nc):
                comp = _Component()
                comp.cid, hv, comp.tq = body[6 + 3 * c], body[7 + 3 * c], body[8 + 3 * c]
                comp.h, comp.v = hv >> 4, hv & 15
                if not (1 <= comp.h <= 4 and 1 <= comp.v <= 4):
                    raise ValueError("JPEG: bad sampling factors")
                comps.append(comp)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            for comp in comps:
                if hmax % comp.h or vmax % comp.v:
                    raise ValueError("JPEG: sampling factors that are no integer ratio are not read")
            mcux = -(-w // (8 * hmax))
            mcuy = -(-h // (8 * vmax))
            for comp in comps:
                comp.width = -(-w * comp.h // hmax)
                comp.height = -(-h * comp.v // vmax)
                comp.bw, comp.bh = mcux * comp.h, mcuy * comp.v
                comp.coef = np.zeros((comp.bh, comp.bw, 64), np.int16) if use_native else [0] * (comp.bw * comp.bh * 64)
            coef_bits = [[-1] * 64 for _ in comps]
            info.components = comps
        elif marker in _SOF_REFUSED:
            raise ValueError(f"JPEG: {_SOF_REFUSED[marker]} files are not read")
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            info.orientation = exif_orientation(body[6:])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            info.jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            info.adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            if not comps:
                raise ValueError("JPEG: SOS before SOF")
            ns = body[0]
            if not 1 <= ns <= len(comps):
                raise ValueError(f"JPEG: a scan of {ns} components")
            scomps = []
            for c in range(ns):
                cid, tables = body[1 + 2 * c], body[2 + 2 * c]
                idx = next(i for i, comp in enumerate(comps) if comp.cid == cid)
                scomps.append((idx, tables >> 4, tables & 15))
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            ah, al = a >> 4, a & 15
            if info.progressive:
                if ss == 0 and se != 0:
                    raise ValueError("JPEG: a progressive DC scan with AC coefficients")
                if ss > se or se > 63:
                    raise ValueError(f"JPEG: a progressive scan over the band {ss}..{se}")
                if ss and ns != 1:
                    raise ValueError("JPEG: an interleaved progressive AC scan")
            per_mcu = 1 if ns == 1 else sum(comps[i].h * comps[i].v for i, _, _ in scomps)
            need_dc, need_ac = (True, True) if not info.progressive else (ss == 0 and ah == 0, ss > 0)
            tables = _scan_tables(specs, luts, scomps, need_dc, need_ac)
            if use_native:
                stream, offsets, pos = native.jpeg_segments(data, seg_end)
                slots = [(comps[i].h, comps[i].v, comps[i].bw, -(-comps[i].width // 8), -(-comps[i].height // 8))
                         for i, _, _ in scomps]
                native.jpeg_scan(stream, offsets, slots, [comps[i].coef for i, _, _ in scomps], tables, mcux, mcuy,
                                 restart * per_mcu, info.progressive, ss, se, ah, al)
            else:
                segments, pos = _entropy_segments(data, seg_end)
                blocks = _scan_blocks(comps, scomps, mcux, mcuy)
                try:
                    if not info.progressive:
                        _baseline_scan(comps, scomps, blocks, segments, restart * per_mcu, tables)
                    elif ss == 0:
                        _dc_scan(comps, scomps, blocks, segments, restart * per_mcu, tables, ah, al)
                    else:
                        _ac_scan(comps[scomps[0][0]], blocks, segments, restart, tables[0][1][1], ss, se, ah, al)
                except IndexError:  # a read past the segment's table of windows
                    raise ValueError("JPEG: corrupt data (the scan runs past its data)") from None
            for idx, _, _ in scomps:
                for k in range(ss, se + 1):
                    coef_bits[idx][k] = al
            continue
        pos = seg_end
    if not comps:
        raise ValueError("JPEG: no frame (SOF) marker")
    if len(comps) == 3:
        ids = tuple(c.cid for c in comps)
        rgb = (info.adobe_transform == 0) if info.adobe_transform is not None and not info.jfif else \
            (not info.jfif and ids == (82, 71, 66))
        if rgb:
            raise ValueError("JPEG: RGB-coded files (Adobe transform 0) are not read")
    if info.progressive:
        for ci, bits in enumerate(coef_bits):
            if any(b != 0 for b in bits[1:_SMOOTHED_COEFS]):
                raise ValueError(f"JPEG: a progressive file whose scans leave component {ci}'s first AC "
                                 "coefficients unrefined (libjpeg smooths such blocks; not reproduced)")
    if not use_native:  # JCOEF: libjpeg keeps 16 bits
        for comp in comps:
            comp.coef = np.asarray(comp.coef, np.int64).astype(np.int16).reshape(comp.bh, comp.bw, 64)
    return comps, info, qt


def decode(data: bytes) -> tuple[list[np.ndarray], JPEGInfo]:
    """The component planes of a JPEG file's bytes at their own (downsampled)
    sizes, uint8, and its :class:`JPEGInfo`."""
    comps, info, qt = coefficients(data)
    planes = []
    for comp in comps:
        if comp.tq not in qt:
            raise ValueError(f"JPEG: quantization table {comp.tq} is missing")
        if native.active("jpeg_idct"):
            plane = native.jpeg_idct(comp.coef, qt[comp.tq])
        else:
            pix = idct_islow(comp.coef.reshape(comp.bh * comp.bw, 64), qt[comp.tq])
            plane = pix.reshape(comp.bh, comp.bw, 8, 8).transpose(0, 2, 1, 3).reshape(comp.bh * 8, comp.bw * 8)
        planes.append(plane[:comp.height, :comp.width])
    return planes, info


def _scan_blocks(comps, scomps, mcux: int, mcuy: int) -> list:
    """(component slot in the scan, offset of the block's 64 coefficients)
    of every block of the scan in its order: MCU by MCU, each component's
    h x v blocks in raster order (interleaved), or the component's own
    blocks in raster order over its size (one component)."""
    if len(scomps) == 1:
        comp = comps[scomps[0][0]]
        by, bx = -(-comp.height // 8), -(-comp.width // 8)
        off = (np.arange(by)[:, None] * comp.bw + np.arange(bx)[None, :]).reshape(-1) * 64
        return [(0, o) for o in off.tolist()]
    order = []
    for slot, (idx, _, _) in enumerate(scomps):
        comp = comps[idx]
        my, mx, vy, hx = np.meshgrid(np.arange(mcuy), np.arange(mcux), np.arange(comp.v), np.arange(comp.h),
                                     indexing="ij")
        off = ((my * comp.v + vy) * comp.bw + mx * comp.h + hx) * 64
        order.append((slot, off.reshape(mcuy * mcux, comp.v * comp.h)))
    per_mcu = np.concatenate([np.stack([np.full_like(o, s), o], -1) for s, o in order], axis=1)
    return [tuple(p) for p in per_mcu.reshape(-1, 2).tolist()]


def _intervals(blocks: list, segments: list, interval: int):
    """(segment, the blocks it codes) for each restart interval."""
    if interval <= 0:
        yield segments[0], blocks
        return
    for i, start in enumerate(range(0, len(blocks), interval)):
        if i >= len(segments):
            raise ValueError("JPEG: fewer restart intervals than the scan needs")
        yield segments[i], blocks[start:start + interval]


def _bad_code():
    raise ValueError("JPEG: corrupt data (a bad Huffman code)")


def _baseline_scan(comps, scomps, blocks, segments, interval, tables) -> None:
    """A sequential scan: for every block the DC difference and the AC run /
    size codes into the components' coefficient lists (zigzag -> natural)."""
    coefs = [comps[i].coef for i, _, _ in scomps]
    dcl = [dc[0] for dc, _ in tables]
    acl = [ac[0] for _, ac in tables]
    nat = _NAT
    for seg, blks in _intervals(blocks, segments, interval):
        w = _windows(seg)
        pos = 0
        pred = [0] * len(scomps)
        for slot, base in blks:
            e = dcl[slot][(w[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
            if e is None:
                _bad_code()
            adv, _, v, pend = e
            pos += adv
            if pend:
                v = (w[pos >> 3] >> (40 - pend - (pos & 7))) & ((1 << pend) - 1)
                if v < (1 << (pend - 1)):
                    v -= (1 << pend) - 1
                pos += pend
            pred[slot] += v
            c = coefs[slot]
            c[base] = pred[slot]
            lut = acl[slot]
            k = 1
            while k < 64:
                e = lut[(w[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
                if e is None:
                    _bad_code()
                adv, r, v, pend = e
                pos += adv
                if r < 0:
                    break
                k += r
                if pend:
                    v = (w[pos >> 3] >> (40 - pend - (pos & 7))) & ((1 << pend) - 1)
                    if v < (1 << (pend - 1)):
                        v -= (1 << pend) - 1
                    pos += pend
                if v:
                    if k > 63:
                        raise ValueError("JPEG: corrupt data (a coefficient past the block)")
                    c[base + nat[k]] = v
                k += 1


class _Bits:
    """A bit reader over one de-stuffed segment (the progressive scans)."""

    __slots__ = ("w", "pos")

    def __init__(self, seg: bytes):
        self.w, self.pos = _windows(seg), 0

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        return (self.w[p >> 3] >> (40 - n - (p & 7))) & ((1 << n) - 1)

    def huff(self, lut) -> int:
        p = self.pos
        e = lut[(self.w[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
        if e is None:
            _bad_code()
        self.pos = p + e[0]
        return e[1]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _wrap16(x: int) -> int:
    """``x`` as libjpeg's JCOEF stores it: 16 bits, wrapped (a progressive
    refinement reads the stored value's sign)."""
    return ((x + 32768) & 0xFFFF) - 32768


def _dc_scan(comps, scomps, blocks, segments, interval, tables, ah: int, al: int) -> None:
    """A progressive DC scan: the first (differences << Al) or a refinement
    (one bit, OR-ed in at Al)."""
    coefs = [comps[i].coef for i, _, _ in scomps]
    luts = [dc[1] if ah == 0 else None for dc, _ in tables]
    for seg, blks in _intervals(blocks, segments, interval):
        br = _Bits(seg)
        pred = [0] * len(scomps)
        for slot, base in blks:
            if ah == 0:
                s = br.huff(luts[slot])
                pred[slot] += _extend(br.bits(s), s)
                coefs[slot][base] = _wrap16(pred[slot] << al)
            elif br.bits(1):
                coefs[slot][base] = _wrap16(coefs[slot][base] | 1 << al)


def _ac_scan(comp, blocks, segments, interval, lut, ss: int, se: int, ah: int, al: int) -> None:
    """A progressive AC scan of one component over the band Ss..Se: the
    first (run / size codes and EOB runs) or a refinement (jdphuff.c's
    ``decode_mcu_AC_refine``: correction bits for the nonzero coefficients,
    new coefficients of +-1 << Al)."""
    c = comp.coef
    nat = _NAT
    p1, m1 = 1 << al, -1 << al  # the masks; what a refinement stores is wrapped
    p1w, m1w = _wrap16(p1), _wrap16(m1)
    for seg, blks in _intervals(blocks, segments, interval):
        br = _Bits(seg)
        eobrun = 0
        for _, base in blks:
            if ah == 0:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = br.huff(lut)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError("JPEG: corrupt data (a coefficient past the block)")
                        c[base + nat[k]] = _wrap16(_extend(br.bits(s), s) << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + br.bits(r) - 1
                        break
                    k += 1
                continue
            k = ss
            if eobrun == 0:
                while k <= se:
                    rs = br.huff(lut)
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1w if br.bits(1) else m1w
                    elif r != 15:
                        eobrun = (1 << r) + br.bits(r)
                        break
                    while k <= se:
                        i = base + nat[k]
                        if c[i]:
                            if br.bits(1) and not (c[i] & p1):
                                c[i] = _wrap16(c[i] + (p1 if c[i] >= 0 else m1))
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s and k <= se:
                        c[base + nat[k]] = s
                    k += 1
            if eobrun > 0:
                while k <= se:
                    i = base + nat[k]
                    if c[i] and br.bits(1) and not (c[i] & p1):
                        c[i] = _wrap16(c[i] + (p1 if c[i] >= 0 else m1))
                    k += 1
                eobrun -= 1


# ---------------------------------------------------------------------------
# IDCT (jidctint.c, JDCT_ISLOW)

_CONST_BITS, _PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """``IDCT_range_limit``: the output sample of an IDCT value x (before
    the +128 level shift) is table[x & 1023] (jdmaster.c's
    ``prepare_range_limit_table``)."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7, shift: int):
    """One 8-point pass of jpeg_idct_islow on int64 arrays; ``shift`` is the
    pass's DESCALE."""
    z1 = (s2 + s6) * FIX_0_541196100
    tmp2 = z1 + s6 * -FIX_1_847759065
    tmp3 = z1 + s2 * FIX_0_765366865
    tmp0 = (s0 + s4) << _CONST_BITS
    tmp1 = (s0 - s4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(tmp10 + t3, shift), _descale(tmp11 + t2, shift), _descale(tmp12 + t1, shift),
            _descale(tmp13 + t0, shift), _descale(tmp13 - t0, shift), _descale(tmp12 - t1, shift),
            _descale(tmp11 - t2, shift), _descale(tmp10 - t3, shift)]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[N, 64] quantized coefficients (natural order) and their [64] table
    -> [N, 8, 8] uint8 samples: dequantize, the column pass into a work
    array scaled by 2^PASS1_BITS (``int`` in libjpeg: wrapped to 32 bits),
    the row pass, then the range limit."""
    d = (coef.astype(np.int64) * quant[None, :]).reshape(-1, 8, 8)  # [N, row u, column v]
    cols = _idct_1d(*[d[:, u, :] for u in range(8)], _CONST_BITS - _PASS1_BITS)  # 8 x [N, column]
    ws = ((np.stack(cols, axis=1) + 2**31) % 2**32) - 2**31  # [N, row y, column v]
    rows = _idct_1d(*[ws[:, :, v] for v in range(8)], _CONST_BITS + _PASS1_BITS + 3)  # 8 x [N, row y]
    out = np.stack(rows, axis=2)  # [N, y, x]
    return _RANGE_LIMIT[out & 1023]


# ---------------------------------------------------------------------------
# upsampling (jdsample.c) and colour conversion (jdcolor.c)

def _h2v1_fancy(x: np.ndarray) -> np.ndarray:
    """Each sample becomes two: 3/4 of it and 1/4 of its left or right
    neighbour, biased 1 (left) and 2 (right); the first and last columns
    keep their own value outward."""
    x = x.astype(np.int32)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out.astype(np.uint8)


def _v_sums(x: np.ndarray):
    """The h1v2 / h2v2 filters' column sums: 3 x the row + the row above
    (for the upper output row) or below (the lower one), the image's edge
    rows repeated."""
    x = x.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    return 3 * x + above, 3 * x + below


def _h1v2_fancy(x: np.ndarray) -> np.ndarray:
    up, down = _v_sums(x)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (up + 1) >> 2
    out[1::2] = (down + 2) >> 2
    return out.astype(np.uint8)


def _h2v2_fancy(x: np.ndarray) -> np.ndarray:
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, s in enumerate(_v_sums(x)):
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * s + left + 8) >> 4
        out[r::2, 1::2] = (3 * s + right + 7) >> 4
        out[r::2, 0] = (4 * s[:, 0] + 8) >> 4
        out[r::2, -1] = (4 * s[:, -1] + 7) >> 4
    return out.astype(np.uint8)


def upsample(plane: np.ndarray, fh: int, fv: int, width: int, height: int) -> np.ndarray:
    """A component plane at its downsampled size -> the image's size, by
    the factors (fh, fv): libjpeg-turbo's choice of method (fancy triangle
    filters for 2x1, 1x2 and 2x2, except 2x1 and 2x2 on planes of two
    samples' width or less; box replication otherwise)."""
    if (fh, fv) == (1, 1):
        out = plane
    elif (fh, fv) == (2, 1) and plane.shape[1] > 2:
        out = _h2v1_fancy(plane)
    elif (fh, fv) == (1, 2):
        out = _h1v2_fancy(plane)
    elif (fh, fv) == (2, 2) and plane.shape[1] > 2:
        out = _h2v2_fancy(plane)
    else:
        out = np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
    return out[:height, :width]


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + _ONE_HALF) >> _SCALEBITS
    cb_b = (_fix(1.77200) * x + _ONE_HALF) >> _SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + _ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert``: [H, W] uint8 planes -> [H, W, 3] RGB."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def read_jpeg(data: bytes, grey: bool = False) -> tuple[np.ndarray, int]:
    """A JPEG file's bytes -> (uint8 image, its Exif orientation): [H, W, 3]
    RGB, or [H, W] for a one-component file; with ``grey`` the Y plane of a
    colour file (libjpeg's ``JCS_GRAYSCALE`` output: no chroma decoded into
    it)."""
    planes, info = decode(data)
    comps = info.components
    if len(comps) == 1:
        return planes[0], info.orientation
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    up, convert = (native.jpeg_upsample, native.jpeg_ycc_rgb) if native.active("jpeg_color") else (upsample, ycc_to_rgb)
    full = [up(p, hmax // c.h, vmax // c.v, info.width, info.height) for p, c in zip(planes[:1 if grey else 3], comps)]
    if grey:
        return full[0], info.orientation
    return convert(*full), info.orientation
