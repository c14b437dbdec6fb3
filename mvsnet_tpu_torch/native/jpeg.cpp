// Baseline JPEG codec and PNG row unfilter in C++, with a plain C ABI
// (loaded with ctypes by native/codec.py).
//
// The same codec as mvsnet_tpu_torch/io/jpeg.py, bit for bit, and the same
// unfilter as io/images.py's `_unfilter`: integer arithmetic
// throughout, every formula and edge rule written as the Python writes it.
// The decoder is libjpeg's default decompression (jpeg_idct_islow, fancy
// h2v1/h2v2 upsampling, the fixed-point YCbCr -> RGB tables); the encoder
// is libjpeg-turbo's compression with jpeg_set_quality(q, TRUE) (the
// fixed-point RGB -> YCbCr, h2v1/h2v2 downsampling with alternating
// biases, dummy blocks, jpeg_fdct_islow, the reciprocal quantizer, the
// standard Huffman tables). Files the decoder does not read (progressive,
// arithmetic, lossless, 12-bit, CMYK, Adobe-transformed, other samplings)
// return an error that names them.
//
// Build (native/__init__.py does it at first use, into mvsnet_tpu_torch/_build/):
//   g++ -O3 -fopenmp -shared -fPIC jpeg.cpp -o libjpeg.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

int natural(int k) { return k < 64 ? kZigzag[k] : 63; }

const int kStdLuma[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcCounts[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                  {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kAcCounts[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D},
                                  {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kAcValues[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int SCALEBITS = 16;
const int64_t ONE_HALF = int64_t(1) << 15;

int64_t fix(double x) { return int64_t(x * double(1 << SCALEBITS) + 0.5); }
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }
inline int64_t clamp255(int64_t x) { return x < 0 ? 0 : (x > 255 ? 255 : x); }
inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct Error : std::runtime_error {
    explicit Error(const std::string& s) : std::runtime_error(s) {}
};

// -- decoding ---------------------------------------------------------------

struct Component {
    int id, h, v, tq;
    int64_t rows = 0, cols = 0;    // coefficient blocks allocated (whole MCUs)
    std::vector<int16_t> coef;     // rows * cols * 64, natural order
};

struct Frame {
    int64_t qt[4][64];
    bool has_qt[4] = {false, false, false, false};
    std::vector<uint16_t> huff[2][4];  // 65536-entry lookups: (length << 8) | value
    int restart = 0;
    bool jfif = false, adobe = false;
    int height = 0, width = 0, max_h = 1, max_v = 1;
    bool has_frame = false;
    std::vector<Component> comps;

    void dims(int ci, int64_t* dh, int64_t* dw, int64_t* bh, int64_t* bw) const {
        const Component& c = comps[ci];
        *dh = ceil_div(int64_t(height) * c.v, max_v);
        *dw = ceil_div(int64_t(width) * c.h, max_h);
        *bh = ceil_div(*dh, 8);
        *bw = ceil_div(*dw, 8);
    }
};

const char* sof_kind(int m) {
    switch (m) {
        case 0xC2: return "progressive (SOF2)";
        case 0xC3: return "lossless (SOF3)";
        case 0xC5: return "hierarchical differential sequential (SOF5)";
        case 0xC6: return "hierarchical differential progressive (SOF6)";
        case 0xC7: return "hierarchical differential lossless (SOF7)";
        case 0xC9: return "arithmetic-coded sequential (SOF9)";
        case 0xCA: return "arithmetic-coded progressive (SOF10)";
        case 0xCB: return "arithmetic-coded lossless (SOF11)";
        case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
        case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
        case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
        default: return nullptr;
    }
}

struct Reader {
    const uint8_t* d;
    int64_t n;
};

int64_t segment(const Reader& r, int64_t pos, int64_t* body) {
    if (pos + 2 > r.n) throw Error("corrupt JPEG: truncated marker segment");
    int64_t length = (int64_t(r.d[pos]) << 8) | r.d[pos + 1];
    if (length < 2 || pos + length > r.n) throw Error("corrupt JPEG: truncated marker segment");
    *body = pos + 2;
    return pos + length;
}

void huffman_lookup(const uint8_t* counts, const uint8_t* values, std::vector<uint16_t>* out) {
    out->assign(1 << 16, 0);
    int64_t code = 0, k = 0;
    for (int length = 1; length <= 16; ++length) {
        for (int i = 0; i < counts[length - 1]; ++i) {
            if (code >= (int64_t(1) << length)) throw Error("corrupt JPEG: bad Huffman table");
            int64_t lo = code << (16 - length);
            uint16_t e = uint16_t((length << 8) | values[k]);
            std::fill(out->begin() + lo, out->begin() + lo + (int64_t(1) << (16 - length)), e);
            ++code;
            ++k;
        }
        code <<= 1;
    }
}

void parse_dqt(Frame& f, const uint8_t* b, int64_t len) {
    int64_t pos = 0;
    while (pos < len) {
        int pq = b[pos] >> 4, tq = b[pos] & 15;
        if (tq > 3) throw Error("corrupt JPEG: bad quantization table");
        int64_t need = pq == 0 ? 65 : 129;
        if (pos + need > len) throw Error("corrupt JPEG: truncated marker segment");
        for (int k = 0; k < 64; ++k) {
            int64_t v = pq == 0 ? b[pos + 1 + k]
                                : ((int64_t(b[pos + 1 + 2 * k]) << 8) | b[pos + 2 + 2 * k]);
            f.qt[tq][kZigzag[k]] = v;
        }
        f.has_qt[tq] = true;
        pos += need;
    }
}

void parse_dht(Frame& f, const uint8_t* b, int64_t len) {
    int64_t pos = 0;
    while (pos < len) {
        if (pos + 17 > len) throw Error("corrupt JPEG: truncated marker segment");
        int tc = b[pos] >> 4, th = b[pos] & 15;
        int n = 0;
        for (int i = 0; i < 16; ++i) n += b[pos + 1 + i];
        if (tc > 1 || th > 3 || n > 256 || pos + 17 + n > len)
            throw Error("corrupt JPEG: bad Huffman table");
        huffman_lookup(b + pos + 1, b + pos + 17, &f.huff[tc][th]);
        pos += 17 + n;
    }
}

void parse_sof(Frame& f, int marker, const uint8_t* b, int64_t len) {
    if (len < 6) throw Error("corrupt JPEG: truncated marker segment");
    int precision = b[0];
    int H = (b[1] << 8) | b[2], W = (b[3] << 8) | b[4], nf = b[5];
    if (precision != 8)
        throw Error("unsupported JPEG: " + std::to_string(precision) + "-bit samples (SOF" +
                    std::to_string(marker - 0xC0) + "); only 8-bit is decoded");
    if (H == 0) throw Error("unsupported JPEG: height defined by a DNL marker");
    if (nf == 4) throw Error("unsupported JPEG: 4 components (CMYK or YCCK)");
    if (nf != 1 && nf != 3)
        throw Error("unsupported JPEG: " + std::to_string(nf) + " components");
    if (len < 6 + 3 * nf) throw Error("corrupt JPEG: truncated marker segment");
    if (W == 0) throw Error("corrupt JPEG: zero width");
    f.height = H;
    f.width = W;
    f.comps.clear();
    for (int i = 0; i < nf; ++i) {
        Component c;
        c.id = b[6 + 3 * i];
        c.h = b[7 + 3 * i] >> 4;
        c.v = b[7 + 3 * i] & 15;
        c.tq = b[8 + 3 * i];
        f.comps.push_back(c);
    }
    if (nf == 3) {
        if (f.adobe) throw Error("unsupported JPEG: Adobe APP14 colour transform");
        if (!f.jfif && f.comps[0].id == 82 && f.comps[1].id == 71 && f.comps[2].id == 66)
            throw Error("unsupported JPEG: RGB-coded components ('R', 'G', 'B')");
    }
    f.max_h = f.max_v = 1;
    for (auto& c : f.comps) {
        f.max_h = std::max(f.max_h, c.h);
        f.max_v = std::max(f.max_v, c.v);
    }
    for (auto& c : f.comps) {
        if (c.h < 1 || c.v < 1 || c.h > 4 || c.v > 4)
            throw Error("corrupt JPEG: bad sampling factors");
        if (c.tq > 3) throw Error("corrupt JPEG: undefined quantization table");
    }
    if (nf == 3) {
        bool ok = true;
        for (auto& c : f.comps) {
            if (f.max_h % c.h || f.max_v % c.v) { ok = false; break; }
            int rh = f.max_h / c.h, rv = f.max_v / c.v;
            if (!((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2))) ok = false;
        }
        if (!ok) {
            std::string s = "unsupported JPEG: chroma sampling ";
            for (int i = 0; i < 3; ++i) {
                if (i) s += ", ";
                s += std::to_string(f.comps[i].h) + "x" + std::to_string(f.comps[i].v);
            }
            throw Error(s + " (only 4:4:4, 4:2:2 and 4:2:0 are decoded)");
        }
    }
    for (auto& c : f.comps) {
        c.rows = ceil_div(H, 8 * f.max_v) * c.v;
        c.cols = ceil_div(W, 8 * f.max_h) * c.h;
        c.coef.assign(size_t(c.rows * c.cols * 64), 0);
    }
    f.has_frame = true;
}

// MSB-first bits of one restart interval's unstuffed bytes; zeros past the end
struct Bits {
    const uint8_t* d;
    int64_t n, pos = 0;
    uint64_t acc = 0;
    int nbits = 0;

    Bits(const uint8_t* data, int64_t len) : d(data), n(len) {}

    void fill() {
        while (nbits <= 24) {
            uint64_t byte = pos < n ? d[pos] : 0;
            ++pos;
            acc = ((acc << 8) | byte) & 0xFFFFFFFFFFULL;
            nbits += 8;
        }
    }
    int huff(const std::vector<uint16_t>& table) {
        if (nbits < 16) fill();
        uint16_t e = table[(acc >> (nbits - 16)) & 0xFFFF];
        if (e == 0) throw Error("corrupt JPEG: bad Huffman code");
        nbits -= e >> 8;
        return e & 0xFF;
    }
    int64_t receive_extend(int s) {
        if (s == 0) return 0;
        if (nbits < s) fill();
        nbits -= s;
        int64_t v = int64_t((acc >> nbits) & ((uint64_t(1) << s) - 1));
        return v >= (int64_t(1) << (s - 1)) ? v : v - (int64_t(1) << s) + 1;
    }
};

// the entropy-coded bytes after an SOS at pos, unstuffed and split at RSTn;
// returns the position of the marker that ends them
int64_t scan_intervals(const Reader& r, int64_t pos, std::vector<uint8_t>* bytes,
                       std::vector<int64_t>* starts) {
    bytes->clear();
    starts->assign(1, 0);
    const int64_t n = r.n;
    while (true) {
        const uint8_t* p = static_cast<const uint8_t*>(memchr(r.d + pos, 0xFF, size_t(n - pos)));
        if (p == nullptr) {
            bytes->insert(bytes->end(), r.d + pos, r.d + n);
            starts->push_back(int64_t(bytes->size()));
            return n;
        }
        int64_t nxt = p - r.d;
        bytes->insert(bytes->end(), r.d + pos, r.d + nxt);
        int64_t j = nxt + 1;
        while (j < n && r.d[j] == 0xFF) ++j;
        if (j >= n) {
            starts->push_back(int64_t(bytes->size()));
            return n;
        }
        int m = r.d[j];
        if (m == 0) {
            bytes->push_back(0xFF);
            pos = j + 1;
        } else if (m >= 0xD0 && m <= 0xD7) {
            starts->push_back(int64_t(bytes->size()));
            pos = j + 1;
        } else {
            starts->push_back(int64_t(bytes->size()));
            return nxt;
        }
    }
}

int64_t decode_block(Bits& bits, const std::vector<uint16_t>& dc, const std::vector<uint16_t>& ac,
                     int16_t* coef, int64_t pred) {
    int s = bits.huff(dc);
    int64_t v = pred + bits.receive_extend(s);
    coef[0] = int16_t(((v + 32768) & 0xFFFF) - 32768);
    int k = 1;
    while (k < 64) {
        int rs = bits.huff(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            coef[natural(k)] = int16_t(bits.receive_extend(s));
            ++k;
        } else if (r == 15) {
            k += 16;
        } else {
            break;
        }
    }
    return v;
}

int64_t decode_scan(Frame& f, const uint8_t* b, int64_t len, const Reader& r, int64_t pos) {
    if (len < 1) throw Error("corrupt JPEG: truncated marker segment");
    int ns = b[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) throw Error("corrupt JPEG: bad scan header");
    struct ScanComp { int ci; const std::vector<uint16_t>* dc; const std::vector<uint16_t>* ac; };
    std::vector<ScanComp> scan;
    for (int i = 0; i < ns; ++i) {
        int cid = b[1 + 2 * i], tables = b[2 + 2 * i];
        int ci = -1;
        for (size_t k = 0; k < f.comps.size(); ++k)
            if (f.comps[k].id == cid && ci < 0) ci = int(k);
        if (ci < 0) throw Error("corrupt JPEG: scan of an unknown component");
        int td = tables >> 4, ta = tables & 15;
        if (td > 3 || ta > 3 || f.huff[0][td].empty() || f.huff[1][ta].empty())
            throw Error("corrupt JPEG: scan uses an undefined Huffman table");
        scan.push_back({ci, &f.huff[0][td], &f.huff[1][ta]});
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns], a = b[3 + 2 * ns];
    if (ss != 0 || se != 63 || a != 0)
        throw Error("unsupported JPEG: a spectral-selection or successive-approximation scan "
                    "in a sequential frame");
    std::vector<uint8_t> bytes;
    std::vector<int64_t> starts;
    int64_t end = scan_intervals(r, pos, &bytes, &starts);
    const int64_t nseg = int64_t(starts.size()) - 1;

    // the MCUs as lists of (component, block row, block col)
    int64_t units, per_unit_blocks = 0;
    int64_t mcu_cols = 1, bw1 = 0;
    if (ns == 1) {
        int64_t dh, dw, bh, bw;
        f.dims(scan[0].ci, &dh, &dw, &bh, &bw);
        units = bh * bw;
        bw1 = bw;
    } else {
        int64_t mcu_rows = ceil_div(f.height, 8 * f.max_v);
        mcu_cols = ceil_div(f.width, 8 * f.max_h);
        units = mcu_rows * mcu_cols;
        for (auto& sc : scan) per_unit_blocks += f.comps[sc.ci].h * f.comps[sc.ci].v;
    }
    (void)per_unit_blocks;
    const int64_t per = f.restart ? f.restart : units;
    for (int64_t k = 0; k < units; k += per) {
        int64_t seg = k / per;
        const uint8_t* sd = nullptr;
        int64_t sl = 0;
        if (seg < nseg) {
            sd = bytes.data() + starts[seg];
            sl = starts[seg + 1] - starts[seg];
        }
        Bits bits(sd, sl);
        int64_t pred[4] = {0, 0, 0, 0};
        for (int64_t u = k; u < std::min(units, k + per); ++u) {
            if (ns == 1) {
                Component& c = f.comps[scan[0].ci];
                int64_t y = u / bw1, x = u % bw1;
                pred[0] = decode_block(bits, *scan[0].dc, *scan[0].ac,
                                       &c.coef[size_t((y * c.cols + x) * 64)], pred[0]);
            } else {
                int64_t my = u / mcu_cols, mx = u % mcu_cols;
                for (size_t si = 0; si < scan.size(); ++si) {
                    Component& c = f.comps[scan[si].ci];
                    for (int by = 0; by < c.v; ++by)
                        for (int bx = 0; bx < c.h; ++bx) {
                            int64_t y = my * c.v + by, x = mx * c.h + bx;
                            pred[si] = decode_block(bits, *scan[si].dc, *scan[si].ac,
                                                    &c.coef[size_t((y * c.cols + x) * 64)],
                                                    pred[si]);
                        }
                }
            }
        }
    }
    return end;
}

void parse(const Reader& r, Frame& f, bool header_only) {
    if (r.n < 2 || r.d[0] != 0xFF || r.d[1] != 0xD8) throw Error("not a JPEG file");
    int64_t pos = 2;
    int scans = 0;
    while (true) {
        const uint8_t* p = pos < r.n
            ? static_cast<const uint8_t*>(memchr(r.d + pos, 0xFF, size_t(r.n - pos))) : nullptr;
        if (p == nullptr) break;
        int64_t j = p - r.d;
        while (j < r.n && r.d[j] == 0xFF) ++j;
        if (j >= r.n) break;
        int marker = r.d[j];
        pos = j + 1;
        if (marker == 0xD9) break;
        if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
        if (const char* kind = sof_kind(marker))
            throw Error(std::string("unsupported JPEG: ") + kind);
        if (marker == 0xCC) throw Error("unsupported JPEG: arithmetic coding (DAC)");
        int64_t body;
        int64_t next = segment(r, pos, &body);
        const uint8_t* b = r.d + body;
        int64_t len = next - body;
        pos = next;
        if (marker == 0xC0 || marker == 0xC1) {
            if (f.has_frame) throw Error("corrupt JPEG: a second frame header");
            parse_sof(f, marker, b, len);
            if (header_only) return;
        } else if (marker == 0xC4) {
            parse_dht(f, b, len);
        } else if (marker == 0xDB) {
            parse_dqt(f, b, len);
        } else if (marker == 0xDD) {
            if (len < 2) throw Error("corrupt JPEG: truncated marker segment");
            f.restart = (b[0] << 8) | b[1];
        } else if (marker == 0xDC) {
            throw Error("unsupported JPEG: height defined by a DNL marker");
        } else if (marker == 0xE0 && len >= 5 && memcmp(b, "JFIF\0", 5) == 0) {
            f.jfif = true;
        } else if (marker == 0xEE && len >= 5 && memcmp(b, "Adobe", 5) == 0) {
            f.adobe = true;
            if (f.has_frame && f.comps.size() == 3)
                throw Error("unsupported JPEG: Adobe APP14 colour transform");
        } else if (marker == 0xDA) {
            if (!f.has_frame) throw Error("corrupt JPEG: a scan before the frame header");
            pos = decode_scan(f, b, len, r, pos);
            ++scans;
        }
    }
    if (!f.has_frame || (!header_only && scans == 0))
        throw Error("corrupt JPEG: no frame or no scan");
    if (!header_only)
        for (auto& c : f.comps)
            if (!f.has_qt[c.tq]) throw Error("corrupt JPEG: undefined quantization table");
}

// jpeg_idct_islow of one block: 64 samples, level shifted and range limited
void idct_islow(const int16_t* coef, const int64_t* q, int64_t* out) {
    int64_t blk[64], ws[64];
    for (int i = 0; i < 64; ++i) {
        int64_t qs = ((q[i] + 32768) & 0xFFFF) - 32768;   // ISLOW_MULT_TYPE is a short
        blk[i] = int64_t(coef[i]) * qs;
    }
    // d(k) reads the k-th input along the transformed axis
    auto one_d = [](const int64_t* d, int stride, int shift, int64_t* o, int ostride) {
        int64_t z2 = d[2 * stride], z3 = d[6 * stride];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = d[0];
        z3 = d[4 * stride];
        int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        int64_t t0 = d[7 * stride], t1 = d[5 * stride], t2 = d[3 * stride], t3 = d[1 * stride];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        int64_t z4 = t1 + t3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        t0 *= FIX_0_298631336;
        t1 *= FIX_2_053119869;
        t2 *= FIX_3_072711026;
        t3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 = z3 * -FIX_1_961570560 + z5;
        z4 = z4 * -FIX_0_390180644 + z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        o[0] = descale(tmp10 + t3, shift);
        o[1 * ostride] = descale(tmp11 + t2, shift);
        o[2 * ostride] = descale(tmp12 + t1, shift);
        o[3 * ostride] = descale(tmp13 + t0, shift);
        o[4 * ostride] = descale(tmp13 - t0, shift);
        o[5 * ostride] = descale(tmp12 - t1, shift);
        o[6 * ostride] = descale(tmp11 - t2, shift);
        o[7 * ostride] = descale(tmp10 - t3, shift);
    };
    for (int col = 0; col < 8; ++col) one_d(blk + col, 8, CONST_BITS - PASS1_BITS, ws + col, 8);
    int64_t res[64];
    for (int row = 0; row < 8; ++row)
        one_d(ws + 8 * row, 1, CONST_BITS + PASS1_BITS + 3, res + 8 * row, 1);
    for (int i = 0; i < 64; ++i) {
        int64_t x = ((res[i] & 1023) ^ 512) - 512;
        out[i] = clamp255(x + 128);
    }
}

// a plane of (rows, cols) int64 samples
struct Plane {
    int64_t rows = 0, cols = 0;
    std::vector<int64_t> v;
    int64_t& at(int64_t y, int64_t x) { return v[size_t(y * cols + x)]; }
    int64_t at(int64_t y, int64_t x) const { return v[size_t(y * cols + x)]; }
};

Plane component_plane(const Frame& f, int ci) {
    int64_t dh, dw, bh, bw;
    f.dims(ci, &dh, &dw, &bh, &bw);
    const Component& c = f.comps[ci];
    Plane p;
    p.rows = dh;
    p.cols = dw;
    p.v.assign(size_t(dh * dw), 0);
    int64_t samples[64];
    for (int64_t by = 0; by < bh; ++by)
        for (int64_t bx = 0; bx < bw; ++bx) {
            idct_islow(&c.coef[size_t((by * c.cols + bx) * 64)], f.qt[c.tq], samples);
            for (int y = 0; y < 8; ++y) {
                int64_t yy = by * 8 + y;
                if (yy >= dh) break;
                for (int x = 0; x < 8; ++x) {
                    int64_t xx = bx * 8 + x;
                    if (xx >= dw) break;
                    p.at(yy, xx) = samples[y * 8 + x];
                }
            }
        }
    return p;
}

// libjpeg's default upsampling of a chroma plane by (rh, rv)
Plane upsample(const Plane& p, int rh, int rv) {
    if (rh == 1 && rv == 1) return p;
    Plane o;
    o.rows = p.rows * rv;
    o.cols = p.cols * rh;
    o.v.assign(size_t(o.rows * o.cols), 0);
    if (p.cols <= 2) {                          // replication
        for (int64_t y = 0; y < o.rows; ++y)
            for (int64_t x = 0; x < o.cols; ++x) o.at(y, x) = p.at(y / rv, x / rh);
        return o;
    }
    const int64_t last = p.cols - 1;
    if (rv == 1) {                              // h2v1
        for (int64_t y = 0; y < p.rows; ++y)
            for (int64_t j = 0; j < p.cols; ++j) {
                int64_t c = p.at(y, j);
                int64_t prev = p.at(y, j ? j - 1 : 0), nxt = p.at(y, j < last ? j + 1 : last);
                o.at(y, 2 * j) = (3 * c + prev + 1) >> 2;
                o.at(y, 2 * j + 1) = (3 * c + nxt + 2) >> 2;
            }
        return o;
    }
    std::vector<int64_t> cs(size_t(p.cols));    // h2v2
    for (int64_t i = 0; i < p.rows; ++i)
        for (int half = 0; half < 2; ++half) {
            int64_t far = half == 0 ? (i ? i - 1 : 0) : (i + 1 < p.rows ? i + 1 : i);
            for (int64_t j = 0; j < p.cols; ++j) cs[size_t(j)] = 3 * p.at(i, j) + p.at(far, j);
            int64_t y = 2 * i + half;
            for (int64_t j = 0; j < p.cols; ++j) {
                int64_t c = cs[size_t(j)];
                int64_t prev = cs[size_t(j ? j - 1 : 0)], nxt = cs[size_t(j < last ? j + 1 : last)];
                o.at(y, 2 * j) = (3 * c + prev + 8) >> 4;
                o.at(y, 2 * j + 1) = (3 * c + nxt + 7) >> 4;
            }
        }
    return o;
}

void decode(const Reader& r, uint8_t* out) {
    Frame f;
    parse(r, f, false);
    const int64_t H = f.height, W = f.width;
    const int nf = int(f.comps.size());
    if (nf == 1) {
        Plane p = component_plane(f, 0);
        for (int64_t y = 0; y < H; ++y)
            for (int64_t x = 0; x < W; ++x) out[y * W + x] = uint8_t(p.at(y, x));
        return;
    }
    Plane planes[3];
    for (int ci = 0; ci < 3; ++ci)
        planes[ci] = upsample(component_plane(f, ci), f.max_h / f.comps[ci].h,
                              f.max_v / f.comps[ci].v);
    int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (fix(1.40200) * x + ONE_HALF) >> SCALEBITS;
        cb_b[i] = (fix(1.77200) * x + ONE_HALF) >> SCALEBITS;
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    for (int64_t y = 0; y < H; ++y)
        for (int64_t x = 0; x < W; ++x) {
            int64_t Y = planes[0].at(y, x), cb = planes[1].at(y, x), cr = planes[2].at(y, x);
            uint8_t* o = out + (y * W + x) * 3;
            o[0] = uint8_t(clamp255(Y + cr_r[cr]));
            o[1] = uint8_t(clamp255(Y + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)));
            o[2] = uint8_t(clamp255(Y + cb_b[cb]));
        }
}

// -- encoding -----------------------------------------------------------------

void fdct_islow(int64_t* d) {            // 64 level-shifted samples, in place
    auto one_d = [](int64_t* p, int stride, bool first) {
        const int odd_shift = first ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
        int64_t t0 = p[0] + p[7 * stride], t7 = p[0] - p[7 * stride];
        int64_t t1 = p[stride] + p[6 * stride], t6 = p[stride] - p[6 * stride];
        int64_t t2 = p[2 * stride] + p[5 * stride], t5 = p[2 * stride] - p[5 * stride];
        int64_t t3 = p[3 * stride] + p[4 * stride], t4 = p[3 * stride] - p[4 * stride];
        int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        if (first) {
            p[0] = (t10 + t11) * (int64_t(1) << PASS1_BITS);
            p[4 * stride] = (t10 - t11) * (int64_t(1) << PASS1_BITS);
        } else {
            p[0] = descale(t10 + t11, PASS1_BITS);
            p[4 * stride] = descale(t10 - t11, PASS1_BITS);
        }
        int64_t z1 = (t12 + t13) * FIX_0_541196100;
        p[2 * stride] = descale(z1 + t13 * FIX_0_765366865, odd_shift);
        p[6 * stride] = descale(z1 + t12 * -FIX_1_847759065, odd_shift);
        z1 = t4 + t7;
        int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        t4 *= FIX_0_298631336;
        t5 *= FIX_2_053119869;
        t6 *= FIX_3_072711026;
        t7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 = z3 * -FIX_1_961570560 + z5;
        z4 = z4 * -FIX_0_390180644 + z5;
        p[7 * stride] = descale(t4 + z1 + z3, odd_shift);
        p[5 * stride] = descale(t5 + z2 + z4, odd_shift);
        p[3 * stride] = descale(t6 + z2 + z3, odd_shift);
        p[1 * stride] = descale(t7 + z1 + z4, odd_shift);
    };
    for (int row = 0; row < 8; ++row) one_d(d + 8 * row, 1, true);
    for (int col = 0; col < 8; ++col) one_d(d + col, 8, false);
}

struct Divisors { int64_t recip[64], corr[64], shift[64]; };

void reciprocals(const int64_t* quant, Divisors* dv) {
    for (int i = 0; i < 64; ++i) {
        int64_t d = quant[i] << 3;
        if (d == 1) { dv->recip[i] = 1; dv->corr[i] = 0; dv->shift[i] = -16; continue; }
        int b = 63 - __builtin_clzll(uint64_t(d));
        int r = 16 + b;
        int64_t fq = (int64_t(1) << r) / d, fr = (int64_t(1) << r) % d;
        int64_t c = d / 2;
        if (fr == 0) { fq >>= 1; --r; }
        else if (fr <= d / 2) { ++c; }
        else { ++fq; }
        dv->recip[i] = fq;
        dv->corr[i] = c;
        dv->shift[i] = r - 16;
    }
}

struct BitWriter {
    std::vector<uint8_t>* out;
    uint64_t acc = 0;
    int n = 0;
    void put(uint64_t code, int length) {
        acc = (acc << length) | (code & ((uint64_t(1) << length) - 1));
        n += length;
        while (n >= 8) {
            n -= 8;
            uint8_t byte = uint8_t((acc >> n) & 0xFF);
            out->push_back(byte);
            if (byte == 0xFF) out->push_back(0);
        }
        acc &= (uint64_t(1) << n) - 1;
    }
    void flush() { if (n) put(0x7F, 8 - n); }
};

struct Codes { uint32_t code[256]; int len[256]; };

void huffman_codes(const uint8_t* counts, const uint8_t* values, Codes* c) {
    memset(c, 0, sizeof(*c));
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
        for (int i = 0; i < counts[length - 1]; ++i) {
            c->code[values[k]] = code;
            c->len[values[k]] = length;
            ++code;
            ++k;
        }
        code <<= 1;
    }
}

inline int bit_length(int64_t m) { return m ? 64 - __builtin_clzll(uint64_t(m)) : 0; }

void encode_block(BitWriter& w, const int64_t* coef, int64_t last_dc, const Codes& dc,
                  const Codes& ac) {
    int64_t diff = coef[0] - last_dc;
    int nbits = bit_length(diff < 0 ? -diff : diff);
    w.put(dc.code[nbits], dc.len[nbits]);
    if (nbits) w.put(uint64_t(diff < 0 ? diff - 1 : diff), nbits);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int64_t c = coef[kZigzag[k]];
        if (c == 0) { ++run; continue; }
        while (run > 15) { w.put(ac.code[0xF0], ac.len[0xF0]); run -= 16; }
        nbits = bit_length(c < 0 ? -c : c);
        int sym = (run << 4) + nbits;
        w.put(ac.code[sym], ac.len[sym]);
        w.put(uint64_t(c < 0 ? c - 1 : c), nbits);
        run = 0;
    }
    if (run) w.put(ac.code[0x00], ac.len[0x00]);
}

void marker(std::vector<uint8_t>& o, int kind, const std::vector<uint8_t>& body) {
    o.push_back(0xFF);
    o.push_back(uint8_t(kind));
    size_t n = body.size() + 2;
    o.push_back(uint8_t(n >> 8));
    o.push_back(uint8_t(n & 0xFF));
    o.insert(o.end(), body.begin(), body.end());
}

// plane padded by edge replication to (rows, cols)
Plane pad(const Plane& p, int64_t rows, int64_t cols) {
    Plane o;
    o.rows = rows;
    o.cols = cols;
    o.v.resize(size_t(rows * cols));
    for (int64_t y = 0; y < rows; ++y)
        for (int64_t x = 0; x < cols; ++x)
            o.at(y, x) = p.at(std::min(y, p.rows - 1), std::min(x, p.cols - 1));
    return o;
}

std::vector<uint8_t> encode(const uint8_t* img, int64_t H, int64_t W, int nc, int quality,
                            int sampling) {
    if (H <= 0 || W <= 0 || H > 65535 || W > 65535)
        throw Error("a JPEG cannot be " + std::to_string(W) + "x" + std::to_string(H));
    if (nc != 1 && nc != 3) throw Error("a JPEG is written from 1 or 3 channels");
    if (sampling < 0 || sampling > 2) throw Error("unknown JPEG subsampling");
    quality = std::min(std::max(quality, 1), 100);
    int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
    int64_t qt[2][64];
    for (int i = 0; i < 64; ++i) {
        qt[0][i] = std::min<int64_t>(std::max<int64_t>((kStdLuma[i] * scale + 50) / 100, 1), 255);
        qt[1][i] = std::min<int64_t>(std::max<int64_t>((kStdChroma[i] * scale + 50) / 100, 1), 255);
    }
    std::vector<Plane> planes(static_cast<size_t>(nc));
    for (auto& p : planes) {
        p.rows = H;
        p.cols = W;
        p.v.resize(size_t(H * W));
    }
    if (nc == 1) {
        for (int64_t i = 0; i < H * W; ++i) planes[0].v[size_t(i)] = img[i];
    } else {
        const int64_t cbcr_offset = int64_t(128) << SCALEBITS;
        const int64_t fy_r = fix(0.29900), fy_g = fix(0.58700), fy_b = fix(0.11400);
        const int64_t fcb_r = fix(0.16874), fcb_g = fix(0.33126), f_half = fix(0.50000);
        const int64_t fcr_g = fix(0.41869), fcr_b = fix(0.08131);
        for (int64_t i = 0; i < H * W; ++i) {
            int64_t r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
            planes[0].v[size_t(i)] = (fy_r * r + fy_g * g + fy_b * b + ONE_HALF) >> SCALEBITS;
            planes[1].v[size_t(i)] =
                (-fcb_r * r - fcb_g * g + f_half * b + cbcr_offset + ONE_HALF - 1) >> SCALEBITS;
            planes[2].v[size_t(i)] =
                (f_half * r - fcr_g * g - fcr_b * b + cbcr_offset + ONE_HALF - 1) >> SCALEBITS;
        }
    }
    const int samp[3][2] = {{1, 1}, {2, 1}, {2, 2}};
    int comp_h[3] = {1, 1, 1}, comp_v[3] = {1, 1, 1}, comp_t[3] = {0, 1, 1};
    if (nc == 3) {
        comp_h[0] = samp[sampling][0];
        comp_v[0] = samp[sampling][1];
    }
    const int max_h = comp_h[0], max_v = comp_v[0];
    struct Coefs { std::vector<int64_t> q; int64_t bh, bw; int h, v; };
    std::vector<Coefs> coefs(static_cast<size_t>(nc));
    Divisors dv[2];
    reciprocals(qt[0], &dv[0]);
    reciprocals(qt[1], &dv[1]);
    for (int ci = 0; ci < nc; ++ci) {
        const int h = comp_h[ci], v = comp_v[ci];
        const int64_t dh = ceil_div(H * v, max_v), dw = ceil_div(W * h, max_h);
        const int64_t bh = ceil_div(dh, 8), bw = ceil_div(dw, 8);
        const int rh = max_h / h, rv = max_v / v;
        const Plane full = pad(planes[size_t(ci)], ceil_div(H, max_v) * max_v, W);
        const int64_t out_rows = full.rows / rv, out_cols = bw * 8;
        const Plane p = pad(full, out_rows * rv, out_cols * rh);
        Plane ds;
        ds.rows = out_rows;
        ds.cols = out_cols;
        ds.v.resize(size_t(out_rows * out_cols));
        for (int64_t y = 0; y < out_rows; ++y)
            for (int64_t x = 0; x < out_cols; ++x) {
                int64_t s;
                if (rh == 1 && rv == 1) s = p.at(y, x);
                else if (rv == 1) s = (p.at(y, 2 * x) + p.at(y, 2 * x + 1) + (x & 1)) >> 1;
                else s = (p.at(2 * y, 2 * x) + p.at(2 * y, 2 * x + 1) + p.at(2 * y + 1, 2 * x) +
                          p.at(2 * y + 1, 2 * x + 1) + (x & 1) + 1) >> 2;
                ds.at(y, x) = s;
            }
        const Plane blocks = pad(ds, bh * 8, bw * 8);
        Coefs& c = coefs[size_t(ci)];
        c.bh = bh;
        c.bw = bw;
        c.h = h;
        c.v = v;
        c.q.resize(size_t(bh * bw * 64));
        const Divisors& d = dv[comp_t[ci]];
        int64_t blk[64];
        for (int64_t by = 0; by < bh; ++by)
            for (int64_t bx = 0; bx < bw; ++bx) {
                for (int y = 0; y < 8; ++y)
                    for (int x = 0; x < 8; ++x)
                        blk[y * 8 + x] = blocks.at(by * 8 + y, bx * 8 + x) - 128;
                fdct_islow(blk);
                int64_t* q = &c.q[size_t((by * bw + bx) * 64)];
                for (int i = 0; i < 64; ++i) {
                    int64_t mag = blk[i] < 0 ? -blk[i] : blk[i];
                    int64_t v2 = ((mag + d.corr[i]) * d.recip[i]) >> (d.shift[i] + 16);
                    q[i] = blk[i] < 0 ? -v2 : v2;
                }
            }
    }
    std::vector<uint8_t> data;
    data.reserve(size_t(H * W * nc / 4 + 1024));
    BitWriter w{&data};
    Codes dc[2], ac[2];
    for (int t = 0; t < 2; ++t) {
        std::vector<uint8_t> dcv(12);
        for (int i = 0; i < 12; ++i) dcv[size_t(i)] = uint8_t(i);
        huffman_codes(kDcCounts[t], dcv.data(), &dc[t]);
        huffman_codes(kAcCounts[t], kAcValues[t], &ac[t]);
    }
    int64_t last[3] = {0, 0, 0};
    if (nc == 1) {
        const Coefs& c = coefs[0];
        for (int64_t b = 0; b < c.bh * c.bw; ++b) {
            const int64_t* q = &c.q[size_t(b * 64)];
            encode_block(w, q, last[0], dc[0], ac[0]);
            last[0] = q[0];
        }
    } else {
        const int64_t mcu_rows = ceil_div(H, 8 * max_v), mcu_cols = ceil_div(W, 8 * max_h);
        int64_t dummy[64];
        for (int64_t my = 0; my < mcu_rows; ++my)
            for (int64_t mx = 0; mx < mcu_cols; ++mx)
                for (int ci = 0; ci < 3; ++ci) {
                    const Coefs& c = coefs[size_t(ci)];
                    const int t = comp_t[ci];
                    std::vector<int64_t> unit_dc;
                    for (int by = 0; by < c.v; ++by)
                        for (int bx = 0; bx < c.h; ++bx) {
                            const int64_t y = my * c.v + by, x = mx * c.h + bx;
                            const int64_t* q;
                            if (y < c.bh && x < c.bw) {
                                q = &c.q[size_t((y * c.bw + x) * 64)];
                            } else {               // libjpeg's dummy block
                                memset(dummy, 0, sizeof(dummy));
                                dummy[0] = y < c.bh ? unit_dc.back()
                                                    : unit_dc[size_t(by * c.h - 1)];
                                q = dummy;
                            }
                            unit_dc.push_back(q[0]);
                            encode_block(w, q, last[ci], dc[t], ac[t]);
                            last[ci] = q[0];
                        }
                }
    }
    w.flush();
    std::vector<uint8_t> out = {0xFF, 0xD8};
    marker(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    const int ntab = nc == 1 ? 1 : 2;
    for (int t = 0; t < ntab; ++t) {
        std::vector<uint8_t> b = {uint8_t(t)};
        for (int k = 0; k < 64; ++k) b.push_back(uint8_t(qt[t][kZigzag[k]]));
        marker(out, 0xDB, b);
    }
    std::vector<uint8_t> sof = {8, uint8_t(H >> 8), uint8_t(H & 0xFF), uint8_t(W >> 8),
                                uint8_t(W & 0xFF), uint8_t(nc)};
    for (int ci = 0; ci < nc; ++ci) {
        sof.push_back(uint8_t(ci + 1));
        sof.push_back(uint8_t((comp_h[ci] << 4) | comp_v[ci]));
        sof.push_back(uint8_t(comp_t[ci]));
    }
    marker(out, 0xC0, sof);
    for (int t = 0; t < ntab; ++t) {
        std::vector<uint8_t> b = {uint8_t(t)};
        b.insert(b.end(), kDcCounts[t], kDcCounts[t] + 16);
        for (int i = 0; i < 12; ++i) b.push_back(uint8_t(i));
        marker(out, 0xC4, b);
        b = {uint8_t(0x10 | t)};
        b.insert(b.end(), kAcCounts[t], kAcCounts[t] + 16);
        b.insert(b.end(), kAcValues[t], kAcValues[t] + 162);
        marker(out, 0xC4, b);
    }
    std::vector<uint8_t> sos = {uint8_t(nc)};
    for (int ci = 0; ci < nc; ++ci) {
        sos.push_back(uint8_t(ci + 1));
        sos.push_back(uint8_t((comp_t[ci] << 4) | comp_t[ci]));
    }
    sos.push_back(0);
    sos.push_back(63);
    sos.push_back(0);
    marker(out, 0xDA, sos);
    out.insert(out.end(), data.begin(), data.end());
    out.push_back(0xFF);
    out.push_back(0xD9);
    return out;
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

void set_error(char* err, int64_t cap, const std::string& s) {
    if (err && cap > 0) snprintf(err, size_t(cap), "%s", s.c_str());
}

}  // namespace

extern "C" {

int native_codec_abi_version() { return 1; }

// (height, width, channels) of a JPEG from its frame header. Returns 0, or
// -1 with a message in err.
int jpeg_header(const uint8_t* data, int64_t n, int32_t* hwc, char* err, int64_t err_cap) {
    try {
        Frame f;
        parse(Reader{data, n}, f, true);
        hwc[0] = f.height;
        hwc[1] = f.width;
        hwc[2] = int32_t(f.comps.size());
        return 0;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return -1;
    }
}

// decode into out (height * width * channels bytes, jpeg_header's sizes).
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int64_t err_cap) {
    try {
        decode(Reader{data, n}, out);
        return 0;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return -1;
    }
}

// encode a (h, w, c) uint8 image; sampling 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0.
// Returns the file's size (written to out when it fits in cap), or -1 with
// a message in err.
int64_t jpeg_encode(const uint8_t* img, int64_t h, int64_t w, int32_t c, int32_t quality,
                    int32_t sampling, uint8_t* out, int64_t cap, char* err, int64_t err_cap) {
    try {
        std::vector<uint8_t> file = encode(img, h, w, c, quality, sampling);
        if (int64_t(file.size()) <= cap) memcpy(out, file.data(), file.size());
        return int64_t(file.size());
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return -1;
    }
}

// undo the PNG filters of h scanlines (each a filter byte and stride bytes)
// into out (h * stride). Returns -1, or the first row with an unknown
// filter type.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = raw + y * (stride + 1);
        const int kind = src[0];
        ++src;
        uint8_t* cur = out + y * stride;
        const uint8_t* up = y ? out + (y - 1) * stride : nullptr;
        switch (kind) {
            case 0:
                memcpy(cur, src, size_t(stride));
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = uint8_t(src[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i) cur[i] = uint8_t(src[i] + (up ? up[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
                    cur[i] = uint8_t(src[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
                    int c = (i >= bpp && up) ? up[i - bpp] : 0;
                    cur[i] = uint8_t(src[i] + paeth(a, b, c));
                }
                break;
            default:
                return y;
        }
    }
    return -1;
}

}  // extern "C"
