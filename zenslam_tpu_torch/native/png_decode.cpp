// Minimal grayscale PNG decoder (zlib inflate + unfilter) — the native image
// path of the dataset reader (the counterpart of OpenCV imgcodecs).
// Supports color types 0 (gray), 2 (RGB→luma), 4, 6 (alpha dropped),
// bit depths 8 and 16, no interlacing.
//
// C ABI for ctypes:
//   zs_decode_png_gray(data, n, &out, &w, &h, &bit_depth) -> 0 on success
//   zs_free(ptr)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

}  // namespace

extern "C" {

void zs_free(void* p) { std::free(p); }

int zs_decode_png_gray(const uint8_t* data, size_t n, uint8_t** out,
                       int* out_w, int* out_h, int* out_bit_depth) {
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    if (n < 8 || std::memcmp(data, sig, 8) != 0) return -1;

    size_t pos = 8;
    uint32_t w = 0, h = 0;
    int bit_depth = 0, color_type = 0;
    std::vector<uint8_t> idat;
    while (pos + 8 <= n) {
        uint32_t len = be32(data + pos);
        const uint8_t* type = data + pos + 4;
        const uint8_t* body = data + pos + 8;
        if (pos + 12 + len > n) return -2;
        if (!std::memcmp(type, "IHDR", 4)) {
            w = be32(body);
            h = be32(body + 4);
            bit_depth = body[8];
            color_type = body[9];
            if (body[12] != 0) return -3;  // interlaced unsupported
        } else if (!std::memcmp(type, "IDAT", 4)) {
            idat.insert(idat.end(), body, body + len);
        } else if (!std::memcmp(type, "IEND", 4)) {
            break;
        }
        pos += 12 + len;
    }
    if (!w || !h || (bit_depth != 8 && bit_depth != 16)) return -4;

    int channels;
    switch (color_type) {
        case 0: channels = 1; break;
        case 2: channels = 3; break;
        case 4: channels = 2; break;
        case 6: channels = 4; break;
        default: return -5;
    }
    const int bps = bit_depth / 8;
    const size_t bpp = size_t(channels) * bps;           // bytes per pixel
    const size_t rowbytes = size_t(w) * bpp;
    const size_t raw_size = (rowbytes + 1) * h;

    std::vector<uint8_t> raw(raw_size);
    uLongf dst_len = raw_size;
    if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK ||
        dst_len != raw_size) {
        return -6;
    }

    // unfilter in place into `img`
    std::vector<uint8_t> img(rowbytes * h);
    for (uint32_t y = 0; y < h; ++y) {
        const uint8_t filter = raw[y * (rowbytes + 1)];
        const uint8_t* src = raw.data() + y * (rowbytes + 1) + 1;
        uint8_t* dst = img.data() + y * rowbytes;
        const uint8_t* up = y ? img.data() + (y - 1) * rowbytes : nullptr;
        for (size_t x = 0; x < rowbytes; ++x) {
            int a = x >= bpp ? dst[x - bpp] : 0;
            int b = up ? up[x] : 0;
            int c = (up && x >= bpp) ? up[x - bpp] : 0;
            int v = src[x];
            switch (filter) {
                case 0: break;
                case 1: v += a; break;
                case 2: v += b; break;
                case 3: v += (a + b) / 2; break;
                case 4: v += paeth(a, b, c); break;
                default: return -7;
            }
            dst[x] = uint8_t(v);
        }
    }

    // collapse to grayscale (ITU-R 601 luma for RGB), native-endian samples
    uint8_t* gray = static_cast<uint8_t*>(std::malloc(size_t(w) * h * bps));
    if (!gray) return -8;
    for (uint32_t y = 0; y < h; ++y) {
        const uint8_t* row = img.data() + y * rowbytes;
        for (uint32_t x = 0; x < w; ++x) {
            const uint8_t* px = row + size_t(x) * bpp;
            if (bps == 1) {
                uint8_t v;
                if (channels >= 3)
                    v = uint8_t((299 * px[0] + 587 * px[1] + 114 * px[2]) / 1000);
                else
                    v = px[0];
                gray[size_t(y) * w + x] = v;
            } else {
                auto sample = [&](int ch) {
                    return uint32_t((px[2 * ch] << 8) | px[2 * ch + 1]);  // PNG is BE
                };
                uint32_t v;
                if (channels >= 3)
                    v = (299 * sample(0) + 587 * sample(1) + 114 * sample(2)) / 1000;
                else
                    v = sample(0);
                reinterpret_cast<uint16_t*>(gray)[size_t(y) * w + x] = uint16_t(v);
            }
        }
    }
    *out = gray;
    *out_w = int(w);
    *out_h = int(h);
    *out_bit_depth = bit_depth;
    return 0;
}

}  // extern "C"
