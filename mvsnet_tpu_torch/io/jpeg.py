"""Baseline JPEG in Python and numpy: the plain codec that the native one
(`mvsnet_tpu_torch/native/jpeg.cpp`) is held to, bit for bit.

The decoder reads what the data plane meets: baseline and extended
sequential Huffman JPEGs (SOF0/SOF1) of 8-bit samples, grayscale or YCbCr
at 4:4:4, 4:2:2 or 4:2:0, with or without restart intervals, at any
size; APPn and COM segments are skipped. It computes what libjpeg(-turbo)
computes with its default settings, all in integers: the `jpeg_idct_islow`
IDCT, the "fancy" triangle upsampling of the chroma planes (h2v1 and h2v2,
with libjpeg's rounding biases; plain replication where a chroma plane is
at most 2 samples wide, as libjpeg does), and libjpeg's fixed-point
YCbCr -> RGB tables. So a file decodes to the same bytes as through PIL
(libjpeg-turbo) or imageio. Progressive, arithmetic-coded, lossless,
hierarchical and 12-bit files, CMYK/YCCK, Adobe-transformed and RGB-coded
files and other chroma samplings raise a `ValueError` that names them:
they never decode to something else.

The encoder writes what libjpeg writes with `jpeg_set_quality(q, TRUE)`:
a JFIF APP0 header, the IJG tables scaled for the quality, the standard
Huffman tables, one interleaved baseline scan; the fixed-point RGB ->
YCbCr conversion, `h2v2_downsample` / `h2v1_downsample` with their
alternating biases, edge replication to whole blocks and libjpeg's dummy
blocks, `jpeg_fdct_islow`, and libjpeg-turbo's reciprocal quantizer.
imageio's default JPEG write is quality 75 at 4:2:0.

The Huffman decoding is a Python loop: seconds at 640x480. The drivers
use the native codec; this one is the specification and the tests' yard
stick.
"""

from __future__ import annotations

import struct

import numpy as np

# -- tables -------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
# natural position of the k-th coefficient; libjpeg pads the table with 63s
# so that a corrupt run past the block's end lands on the last coefficient
_NATURAL = ZIGZAG.tolist() + [63] * 16

STD_LUMINANCE_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMINANCE_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# the standard Huffman tables (ITU T.81 Annex K.3): code counts per length 1-16, values
_AC_LUMA_VALUES = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALUES = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFFMAN = {  # (class, table) -> (counts, values); class 0 DC, 1 AC
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUMA_VALUES),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHROMA_VALUES),
}

# sampling (h, v) of the first component with 1x1 chroma, by name
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}

# libjpeg's fixed-point constants (jidctint.c, jfdctint.c: CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172

# colour conversion (jdcolor.c, jccolor.c: SCALEBITS 16)
SCALEBITS, ONE_HALF = 16, 1 << 15


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def _ycc_rgb_tables():
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_rgb_tables()

_SOF_KINDS = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "hierarchical differential sequential (SOF5)",
    0xC6: "hierarchical differential progressive (SOF6)",
    0xC7: "hierarchical differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}


# -- parsing --------------------------------------------------------------------

class _Frame:
    """What the markers before and between the scans say."""

    def __init__(self):
        self.qt = {}                   # table id -> (64,) natural order
        self.huff = {}                 # (class, id) -> lookup
        self.restart = 0
        self.jfif = False
        self.adobe = False
        self.height = self.width = 0
        self.comps = []                # [id, h, v, tq]
        self.coef = None               # per component (rows, cols, 64) natural order


def _huffman_lookup(counts, values):
    """A 65536-entry table: the next 16 bits -> (code length << 8) | value;
    0 where no code of at most 16 bits matches."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("corrupt JPEG: bad Huffman table")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | values[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _segment(data, pos):
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    if length < 2 or pos + length > len(data):
        raise ValueError("corrupt JPEG: truncated marker segment")
    return data[pos + 2:pos + length], pos + length


def _parse_dqt(frame, body):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        if tq > 3:
            raise ValueError("corrupt JPEG: bad quantization table")
        if pos + (65 if pq == 0 else 129) > len(body):
            raise ValueError("corrupt JPEG: truncated marker segment")
        if pq == 0:
            vals = np.frombuffer(body, np.uint8, 64, pos + 1).astype(np.int64)
            pos += 65
        else:
            vals = np.frombuffer(body, ">u2", 64, pos + 1).astype(np.int64)
            pos += 129
        table = np.zeros(64, np.int64)
        table[ZIGZAG] = vals
        frame.qt[tq] = table


def _parse_dht(frame, body):
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise ValueError("corrupt JPEG: truncated marker segment")
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = tuple(body[pos + 1:pos + 17])
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
            raise ValueError("corrupt JPEG: bad Huffman table")
        frame.huff[(tc, th)] = _huffman_lookup(counts, body[pos + 17:pos + 17 + n])
        pos += 17 + n


def _parse_sof(frame, marker, body):
    precision, H, W, nf = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"unsupported JPEG: {precision}-bit samples "
                         f"(SOF{marker - 0xC0}); only 8-bit is decoded")
    if H == 0:
        raise ValueError("unsupported JPEG: height defined by a DNL marker")
    if nf == 4:
        raise ValueError("unsupported JPEG: 4 components (CMYK or YCCK)")
    if nf not in (1, 3):
        raise ValueError(f"unsupported JPEG: {nf} components")
    frame.height, frame.width = H, W
    frame.comps = [[body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                    body[8 + 3 * i]] for i in range(nf)]
    if nf == 3:
        if frame.adobe:
            raise ValueError("unsupported JPEG: Adobe APP14 colour transform")
        if not frame.jfif and [c[0] for c in frame.comps] == [82, 71, 66]:
            raise ValueError("unsupported JPEG: RGB-coded components ('R', 'G', 'B')")
    max_h = max(c[1] for c in frame.comps)
    max_v = max(c[2] for c in frame.comps)
    for c in frame.comps:
        if c[1] < 1 or c[2] < 1 or c[1] > 4 or c[2] > 4:
            raise ValueError("corrupt JPEG: bad sampling factors")
        if c[3] > 3:
            raise ValueError("corrupt JPEG: undefined quantization table")
        if nf == 3 and (max_h % c[1] or max_v % c[2]
                        or (max_h // c[1], max_v // c[2]) not in ((1, 1), (2, 1), (2, 2))):
            raise ValueError("unsupported JPEG: chroma sampling "
                             + ", ".join(f"{h}x{v}" for _, h, v, _ in frame.comps)
                             + " (only 4:4:4, 4:2:2 and 4:2:0 are decoded)")
    frame.coef = []
    for _, h, v, _ in frame.comps:
        rows = -(-H // (8 * max_v)) * v
        cols = -(-W // (8 * max_h)) * h
        frame.coef.append(np.zeros((rows, cols, 64), np.int64))


def _dims(frame, ci):
    """(height, width) in samples and in blocks of component ci."""
    max_h = max(c[1] for c in frame.comps)
    max_v = max(c[2] for c in frame.comps)
    _, h, v, _ = frame.comps[ci]
    dh = -(-frame.height * v // max_v)
    dw = -(-frame.width * h // max_h)
    return dh, dw, -(-dh // 8), -(-dw // 8)


# -- entropy decoding -------------------------------------------------------------

class _Bits:
    """MSB-first bits of one restart interval's unstuffed bytes; reads past
    the end give zeros, as libjpeg's do."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def _fill(self):
        while self.n <= 24:
            byte = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = ((self.acc << 8) | byte) & 0xFFFFFFFFFF
            self.n += 8

    def huff(self, table):
        if self.n < 16:
            self._fill()
        entry = table[(self.acc >> (self.n - 16)) & 0xFFFF]
        if entry == 0:
            raise ValueError("corrupt JPEG: bad Huffman code")
        self.n -= entry >> 8
        return entry & 0xFF

    def receive_extend(self, s):
        if s == 0:
            return 0
        if self.n < s:
            self._fill()
        self.n -= s
        v = (self.acc >> self.n) & ((1 << s) - 1)
        return v if v >= (1 << (s - 1)) else v - (1 << s) + 1


def _scan_intervals(data, pos):
    """The entropy-coded bytes after an SOS at `pos`, unstuffed and split at
    the RSTn markers, and the position of the marker that ends them."""
    segments, cur, n = [], bytearray(), len(data)
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0:
            cur += data[pos:]
            segments.append(bytes(cur))
            return segments, n
        cur += data[pos:nxt]
        j = nxt + 1
        while j < n and data[j] == 0xFF:
            j += 1
        if j >= n:
            segments.append(bytes(cur))
            return segments, n
        m = data[j]
        if m == 0:
            cur.append(0xFF)
            pos = j + 1
        elif 0xD0 <= m <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            pos = j + 1
        else:
            segments.append(bytes(cur))
            return segments, nxt


def _decode_block(bits, dc_table, ac_table, coef, pred):
    """One block's coefficients into `coef` (natural order); returns the new
    DC predictor."""
    s = bits.huff(dc_table)
    dc = pred + bits.receive_extend(s)
    coef[0] = ((dc + 32768) & 0xFFFF) - 32768          # stored as a 16-bit JCOEF
    k = 1
    while k < 64:
        rs = bits.huff(ac_table)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            coef[_NATURAL[k]] = bits.receive_extend(s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break
    return dc


def _decode_scan(frame, body, data, pos):
    ns = body[0]
    index = {c[0]: i for i, c in enumerate(frame.comps)}
    scan = []
    for i in range(ns):
        cid, tables = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in index:
            raise ValueError("corrupt JPEG: scan of an unknown component")
        ci = index[cid]
        if (0, tables >> 4) not in frame.huff or (1, tables & 15) not in frame.huff:
            raise ValueError("corrupt JPEG: scan uses an undefined Huffman table")
        scan.append((ci, frame.huff[(0, tables >> 4)], frame.huff[(1, tables & 15)]))
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    if ss != 0 or se != 63 or a != 0:
        raise ValueError("unsupported JPEG: a spectral-selection or successive-"
                         "approximation scan in a sequential frame")
    segments, end = _scan_intervals(data, pos)
    max_h = max(c[1] for c in frame.comps)
    max_v = max(c[2] for c in frame.comps)
    if ns == 1:                          # non-interleaved: one block an MCU
        ci = scan[0][0]
        _, _, bh, bw = _dims(frame, ci)
        units = [[(ci, y, x)] for y in range(bh) for x in range(bw)]
    else:
        mcu_rows = -(-frame.height // (8 * max_v))
        mcu_cols = -(-frame.width // (8 * max_h))
        units = []
        for my in range(mcu_rows):
            for mx in range(mcu_cols):
                unit = []
                for ci, _, _ in scan:
                    _, h, v, _ = frame.comps[ci]
                    unit += [(ci, my * v + by, mx * h + bx) for by in range(v) for bx in range(h)]
                units.append(unit)
    tables = {ci: (dc, ac) for ci, dc, ac in scan}
    per = frame.restart or len(units)
    for k in range(0, len(units), per):
        seg = k // per
        bits = _Bits(segments[seg] if seg < len(segments) else b"")
        pred = {ci: 0 for ci, _, _ in scan}
        for unit in units[k:k + per]:
            for ci, y, x in unit:
                dc, ac = tables[ci]
                pred[ci] = _decode_block(bits, dc, ac, frame.coef[ci][y, x], pred[ci])
    return end


def _parse(data: bytes):
    """The frame, with every scan's coefficients decoded."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    frame, pos, scans = _Frame(), 2, 0
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            break
        while j < len(data) and data[j] == 0xFF:
            j += 1
        if j >= len(data):
            break
        marker, pos = data[j], j + 1
        if marker == 0xD9:
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        if marker in _SOF_KINDS:
            raise ValueError(f"unsupported JPEG: {_SOF_KINDS[marker]}")
        if marker == 0xCC:
            raise ValueError("unsupported JPEG: arithmetic coding (DAC)")
        body, pos = _segment(data, pos)
        if marker in (0xC0, 0xC1):
            if frame.coef is not None:
                raise ValueError("corrupt JPEG: a second frame header")
            _parse_sof(frame, marker, body)
        elif marker == 0xC4:
            _parse_dht(frame, body)
        elif marker == 0xDB:
            _parse_dqt(frame, body)
        elif marker == 0xDD:
            (frame.restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDC:
            raise ValueError("unsupported JPEG: height defined by a DNL marker")
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            frame.jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            frame.adobe = True
            if frame.coef is not None and len(frame.comps) == 3:
                raise ValueError("unsupported JPEG: Adobe APP14 colour transform")
        elif marker == 0xDA:
            if frame.coef is None:
                raise ValueError("corrupt JPEG: a scan before the frame header")
            pos = _decode_scan(frame, body, data, pos)
            scans += 1
    if frame.coef is None or scans == 0:
        raise ValueError("corrupt JPEG: no frame or no scan")
    for c in frame.comps:
        if c[3] not in frame.qt:
            raise ValueError("corrupt JPEG: undefined quantization table")
    return frame


# -- sample reconstruction ----------------------------------------------------------

def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef, quant):
    """libjpeg's `jpeg_idct_islow` on (N, 64) natural-order coefficients:
    (N, 8, 8) samples, level shifted and range limited as libjpeg's table
    does (10-bit wrap, then clamp)."""
    q = quant.astype(np.int64)
    q = ((q + 32768) & 0xFFFF) - 32768              # ISLOW_MULT_TYPE is a short
    blk = (coef * q).reshape(-1, 8, 8)              # [n, row, col]

    def one_d(d, shift_out):
        # d[..., k]: the k-th input along the transformed axis
        z2, z3 = d[..., 2], d[..., 6]
        z1 = (z2 + z3) * FIX_0_541196100
        tmp2 = z1 + z3 * -FIX_1_847759065
        tmp3 = z1 + z2 * FIX_0_765366865
        z2, z3 = d[..., 0], d[..., 4]
        tmp0 = (z2 + z3) << CONST_BITS
        tmp1 = (z2 - z3) << CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
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
        out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
               tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
        return np.stack([_descale(o, shift_out) for o in out], axis=-1)

    # pass 1: columns (transform along rows index), into the int workspace
    ws = one_d(np.swapaxes(blk, 1, 2), CONST_BITS - PASS1_BITS)         # [n, col, row]
    ws = np.swapaxes(ws, 1, 2)                                          # [n, row, col]
    out = one_d(ws, CONST_BITS + PASS1_BITS + 3)                        # [n, row, col]
    x = ((out & 1023) ^ 512) - 512
    return np.clip(x + 128, 0, 255)


def _blocks_to_plane(blocks):
    rows, cols = blocks.shape[:2]
    return blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _edge(a, axis):
    """a's neighbours before and after along `axis`, the edges replicated."""
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    n = a.shape[axis]
    prev = np.concatenate([first, np.take(a, np.arange(n - 1), axis=axis)], axis=axis)
    nxt = np.concatenate([np.take(a, np.arange(1, n), axis=axis), last], axis=axis)
    return prev, nxt


def _interleave_cols(even, odd):
    out = np.empty(even.shape[:-1] + (even.shape[-1] * 2,), even.dtype)
    out[..., 0::2], out[..., 1::2] = even, odd
    return out


def upsample(plane, ratio):
    """A chroma plane (its real samples only) upsampled by `ratio` (h, v)
    as libjpeg does by default: (1, 1) as is; (2, 1) h2v1 and (2, 2) h2v2
    triangle filters with libjpeg's biases where the plane is wider than 2
    samples, else replicated."""
    p = plane.astype(np.int64)
    if ratio == (1, 1):
        return p
    if p.shape[1] <= 2:
        return np.repeat(np.repeat(p, ratio[0], axis=1), ratio[1], axis=0)
    if ratio == (2, 1):
        prev, nxt = _edge(p, 1)
        return _interleave_cols((3 * p + prev + 1) >> 2, (3 * p + nxt + 2) >> 2)
    up, down = _edge(p, 0)
    rows = []
    for far in (up, down):
        cs = 3 * p + far
        prev, nxt = _edge(cs, 1)
        rows.append(_interleave_cols((3 * cs + prev + 8) >> 4, (3 * cs + nxt + 7) >> 4))
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int64)
    out[0::2], out[1::2] = rows
    return out


def ycc_to_rgb(y, cb, cr):
    """libjpeg's `ycc_rgb_convert` on int planes of one shape."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A baseline JPEG as uint8 (H, W) (grayscale) or (H, W, 3) (RGB)."""
    frame = _parse(bytes(data))
    H, W = frame.height, frame.width
    max_h = max(c[1] for c in frame.comps)
    max_v = max(c[2] for c in frame.comps)
    planes = []
    for ci, (_, h, v, tq) in enumerate(frame.comps):
        dh, dw, bh, bw = _dims(frame, ci)
        coef = frame.coef[ci][:bh, :bw]
        samples = idct_islow(coef.reshape(-1, 64), frame.qt[tq]).reshape(bh, bw, 8, 8)
        plane = _blocks_to_plane(samples)[:dh, :dw]
        if len(frame.comps) == 3:
            plane = upsample(plane, (max_h // h, max_v // v))
        planes.append(plane[:H, :W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return ycc_to_rgb(*planes)


# -- encoding -----------------------------------------------------------------------

def quant_tables(quality: int):
    """The IJG tables scaled as `jpeg_set_quality(quality, TRUE)` scales
    them: (luminance, chrominance), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMINANCE_QUANT, STD_CHROMINANCE_QUANT))


def rgb_to_ycc(rgb):
    """libjpeg's `rgb_ycc_convert`: three int64 planes."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = ONE_HALF
    cbcr_offset = 128 << SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + cbcr_offset + half - 1) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + cbcr_offset + half - 1) >> SCALEBITS
    return y, cb, cr


def _pad(plane, rows, cols):
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def downsample(plane, ratio, out_rows, out_cols):
    """libjpeg's downsampling of a full-size plane (padded by edge
    replication first) to (out_rows, out_cols): h2v2 with biases 1, 2,
    1, 2, ...; h2v1 with 0, 1, 0, 1, ...; 1x1 as is."""
    h, v = ratio
    p = _pad(plane, out_rows * v, out_cols * h)
    if ratio == (1, 1):
        return p
    bias = np.arange(out_cols) & 1
    if ratio == (2, 1):
        return (p[:, 0::2] + p[:, 1::2] + bias) >> 1
    return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias + 1) >> 2


def fdct_islow(blocks):
    """libjpeg's `jpeg_fdct_islow` on (N, 8, 8) level-shifted samples:
    (N, 8, 8) coefficients scaled up by 8."""
    def one_d(d, odd_shift, first):
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = [None] * 8
        if first:
            out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
        else:
            out[0], out[4] = _descale(t10 + t11, PASS1_BITS), _descale(t10 - t11, PASS1_BITS)
        z1 = (t12 + t13) * FIX_0_541196100
        out[2] = _descale(z1 + t13 * FIX_0_765366865, odd_shift)
        out[6] = _descale(z1 + t12 * -FIX_1_847759065, odd_shift)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * FIX_1_175875602
        t4, t5 = t4 * FIX_0_298631336, t5 * FIX_2_053119869
        t6, t7 = t6 * FIX_3_072711026, t7 * FIX_1_501321110
        z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
        z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
        out[7] = _descale(t4 + z1 + z3, odd_shift)
        out[5] = _descale(t5 + z2 + z4, odd_shift)
        out[3] = _descale(t6 + z2 + z3, odd_shift)
        out[1] = _descale(t7 + z1 + z4, odd_shift)
        return np.stack(out, axis=-1)

    rows = one_d(blocks.astype(np.int64), CONST_BITS - PASS1_BITS, True)
    cols = one_d(np.swapaxes(rows, 1, 2), CONST_BITS + PASS1_BITS, False)
    return np.swapaxes(cols, 1, 2)


def _reciprocals(divisor):
    """libjpeg-turbo's `compute_reciprocal` for (64,) divisors: (recip,
    corr, shift) with which (|x| + corr) * recip >> (16 + shift) is |x|
    divided by the divisor and rounded."""
    recip, corr, shift = [], [], []
    for d in divisor.tolist():
        if d == 1:
            recip.append(1), corr.append(0), shift.append(-16)
            continue
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = (1 << r) // d, (1 << r) % d
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq), corr.append(c), shift.append(r - 16)
    return (np.array(recip, np.int64), np.array(corr, np.int64), np.array(shift, np.int64))


def quantize(coef, quant):
    """libjpeg-turbo's `quantize` of (N, 64) natural-order coefficients by a
    (64,) table (the DCT's scale of 8 folded into the divisor)."""
    recip, corr, shift = _reciprocals(quant.astype(np.int64) << 3)
    mag = np.abs(coef)
    q = ((mag + corr) * recip) >> (shift + 16)
    return np.where(coef < 0, -q, q)


def _huffman_codes(counts, values):
    """{value: (code, length)} of a table in canonical order."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put(0x7F, 8 - self.n)        # pad with ones, as libjpeg does


def _encode_block(w, coef, last_dc, dc_codes, ac_codes):
    """Huffman-code one natural-order block (a list of 64 ints)."""
    diff = coef[0] - last_dc
    mag = -diff if diff < 0 else diff
    nbits = mag.bit_length()
    w.put(*dc_codes[nbits])
    if nbits:
        w.put(diff - 1 if diff < 0 else diff, nbits)
    run = 0
    for k in range(1, 64):
        c = coef[_NATURAL[k]]
        if c == 0:
            run += 1
            continue
        while run > 15:
            w.put(*ac_codes[0xF0])
            run -= 16
        mag = -c if c < 0 else c
        nbits = mag.bit_length()
        w.put(*ac_codes[(run << 4) + nbits])
        w.put(c - 1 if c < 0 else c, nbits)
        run = 0
    if run:
        w.put(*ac_codes[0x00])



def _marker(kind, body):
    return bytes([0xFF, kind]) + struct.pack(">H", len(body) + 2) + body


def encode(image, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """A uint8 (H, W) grayscale or (H, W, 3) RGB image as a baseline JFIF
    JPEG, byte for byte as libjpeg-turbo writes it with
    `jpeg_set_quality(quality, TRUE)` and that sampling."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"JPEG samples must be uint8, not {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"cannot write an image of shape {image.shape} as a JPEG")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"unknown JPEG subsampling {subsampling!r} "
                         f"(one of {', '.join(SUBSAMPLING)})")
    H, W = image.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"a JPEG cannot be {W}x{H}")
    qtabs = quant_tables(quality)
    if image.ndim == 2:
        planes, samp, tq = [image.astype(np.int64)], [(1, 1)], [0]
    else:
        planes, samp, tq = list(rgb_to_ycc(image)), [SUBSAMPLING[subsampling], (1, 1), (1, 1)], \
            [0, 1, 1]
    max_h, max_v = samp[0]
    mcu_rows, mcu_cols = -(-H // (8 * max_v)), -(-W // (8 * max_h))
    coefs = []
    for plane, (h, v), t in zip(planes, samp, tq):
        dh, dw = -(-H * v // max_v), -(-W * h // max_h)
        bh, bw = -(-dh // 8), -(-dw // 8)
        ratio = (max_h // h, max_v // v)
        # rows: the image's padded to the row group, then the component's to whole blocks
        full = _pad(plane, -(-H // max_v) * max_v, plane.shape[1])
        ds = downsample(full, ratio, full.shape[0] // ratio[1], bw * 8)
        ds = _pad(ds, bh * 8, bw * 8)
        blocks = ds.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8) - 128
        q = quantize(fdct_islow(blocks).reshape(-1, 64), qtabs[t]).reshape(bh, bw, 64)
        coefs.append((q, h, v, bh, bw))
    w = _BitWriter()
    codes = {key: _huffman_codes(*tab) for key, tab in STD_HUFFMAN.items()}
    last = [0] * len(coefs)
    for my in range(mcu_rows if len(coefs) > 1 else coefs[0][3]):
        for mx in range(mcu_cols if len(coefs) > 1 else coefs[0][4]):
            for ci, (q, h, v, bh, bw) in enumerate(coefs):
                if len(coefs) == 1:
                    h = v = 1
                unit = []                      # the MCU's blocks of this component
                for by in range(v):
                    for bx in range(h):
                        y, x = my * v + by, mx * h + bx
                        if y < bh and x < bw:
                            unit.append(q[y, x].tolist())
                        else:                  # libjpeg's dummy block
                            dc = unit[-1][0] if y < bh else unit[by * h - 1][0]
                            unit.append([dc] + [0] * 63)
                t = 0 if ci == 0 else 1
                for block in unit:
                    _encode_block(w, block, last[ci], codes[(0, t)], codes[(1, t)])
                    last[ci] = block[0]
    w.flush()
    out = bytearray(b"\xff\xd8")
    out += _marker(0xE0, b"JFIF\0" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + b"\0\0")
    for t in sorted(set(tq)):
        out += _marker(0xDB, bytes([t]) + bytes(qtabs[t][ZIGZAG].astype(np.uint8)))
    comps = b"".join(bytes([i + 1, (h << 4) | v, t]) for i, ((h, v), t) in enumerate(zip(samp,
                                                                                     tq)))
    out += _marker(0xC0, struct.pack(">BHHB", 8, H, W, len(samp)) + comps)
    for t in sorted(set(tq)):
        for cls in (0, 1):
            counts, values = STD_HUFFMAN[(cls, t)]
            out += _marker(0xC4, bytes([(cls << 4) | t]) + bytes(counts) + values)
    scan = b"".join(bytes([i + 1, (t << 4) | t]) for i, t in enumerate(tq))
    out += _marker(0xDA, bytes([len(tq)]) + scan + bytes([0, 63, 0]))
    out += w.out + b"\xff\xd9"
    return bytes(out)
