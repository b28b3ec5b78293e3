// climsr_tpu_torch native raster IO core (a copy of climsr_tpu/native/tiffio.cpp).
//
// The reference delegates raster IO to GDAL/rasterio (C); this is the
// framework's own native layer: a minimal TIFF 6.0 float32 strip decoder,
// nearest-neighbor resize, and a GIL-free multi-threaded batch tile loader.
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
//
// Scope mirrors climsr_tpu_torch/io/geotiff.py's fast path: little-endian,
// single-band, uncompressed or deflate strips, f32/u8/i16 samples. Anything
// else returns a nonzero code and the Python codec takes over.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

struct Tag {
    uint16_t id;
    uint16_t type;
    uint32_t count;
    uint32_t value_or_offset;
};

constexpr uint16_t kImageWidth = 256;
constexpr uint16_t kImageLength = 257;
constexpr uint16_t kBitsPerSample = 258;
constexpr uint16_t kCompression = 259;
constexpr uint16_t kStripOffsets = 273;
constexpr uint16_t kSamplesPerPixel = 277;
constexpr uint16_t kStripByteCounts = 279;
constexpr uint16_t kPredictor = 317;
constexpr uint16_t kSampleFormat = 339;

size_t type_size(uint16_t t) {
    switch (t) {
        case 1: case 2: case 6: case 7: return 1;
        case 3: case 8: return 2;
        case 4: case 9: case 11: return 4;
        case 5: case 10: case 12: return 8;
        default: return 1;
    }
}

struct FileBuf {
    std::vector<uint8_t> data;
    bool ok = false;
};

FileBuf read_file(const char* path) {
    FileBuf fb;
    FILE* f = std::fopen(path, "rb");
    if (!f) return fb;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    // ftell can return -1 (unseekable special files); a negative size cast to
    // size_t would make resize throw across the extern "C" boundary
    if (size < 0) {
        std::fclose(f);
        return fb;
    }
    fb.data.resize(static_cast<size_t>(size));
    fb.ok = std::fread(fb.data.data(), 1, fb.data.size(), f) == fb.data.size();
    std::fclose(f);
    return fb;
}

template <typename T>
T rd(const uint8_t* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;
}

// Returns 0 on success. out must hold h*w floats (call with out=nullptr to probe dims).
int decode_tiff_f32_impl(const uint8_t* buf, size_t n, float* out, int32_t* out_h, int32_t* out_w) {
    if (n < 8 || buf[0] != 'I' || buf[1] != 'I') return 1;  // little-endian only
    if (rd<uint16_t>(buf + 2) != 42) return 2;
    uint32_t ifd = rd<uint32_t>(buf + 4);
    if (ifd + 2 > n) return 3;
    uint16_t ntags = rd<uint16_t>(buf + ifd);
    if (ifd + 2 + ntags * 12ull > n) return 3;

    uint32_t width = 0, height = 0, bits = 32, compression = 1, spp = 1, sample_format = 1,
             predictor = 1;
    std::vector<uint32_t> strip_offsets, strip_counts;

    for (uint16_t i = 0; i < ntags; ++i) {
        const uint8_t* p = buf + ifd + 2 + i * 12;
        Tag t{rd<uint16_t>(p), rd<uint16_t>(p + 2), rd<uint32_t>(p + 4), rd<uint32_t>(p + 8)};
        auto values_u32 = [&](std::vector<uint32_t>& dst) {
            size_t sz = type_size(t.type);
            size_t total = sz * t.count;
            const uint8_t* src = total <= 4 ? p + 8 : buf + t.value_or_offset;
            if (total > 4 && t.value_or_offset + total > n) return false;
            dst.resize(t.count);
            for (uint32_t k = 0; k < t.count; ++k) {
                dst[k] = (t.type == 3) ? rd<uint16_t>(src + k * 2) : rd<uint32_t>(src + k * 4);
            }
            return true;
        };
        uint32_t scalar = (t.type == 3) ? (t.value_or_offset & 0xFFFF) : t.value_or_offset;
        switch (t.id) {
            case kImageWidth: width = scalar; break;
            case kImageLength: height = scalar; break;
            case kBitsPerSample: bits = scalar; break;
            case kCompression: compression = scalar; break;
            case kSamplesPerPixel: spp = scalar; break;
            case kSampleFormat: sample_format = scalar; break;
            case kPredictor: predictor = scalar; break;
            case kStripOffsets:
                if (!values_u32(strip_offsets)) return 3;
                break;
            case kStripByteCounts:
                if (!values_u32(strip_counts)) return 3;
                break;
            default: break;
        }
    }
    if (!width || !height || spp != 1) return 4;
    if (strip_offsets.empty() || strip_offsets.size() != strip_counts.size()) return 4;

    *out_h = static_cast<int32_t>(height);
    *out_w = static_cast<int32_t>(width);
    if (out == nullptr) return 0;  // probe only

    size_t bytes_per_sample = bits / 8;
    size_t expected = static_cast<size_t>(width) * height * bytes_per_sample;
    std::vector<uint8_t> raw;
    raw.reserve(expected);
    for (size_t s = 0; s < strip_offsets.size(); ++s) {
        if (strip_offsets[s] + static_cast<size_t>(strip_counts[s]) > n) return 3;
        const uint8_t* src = buf + strip_offsets[s];
        if (compression == 1) {
            raw.insert(raw.end(), src, src + strip_counts[s]);
        } else if (compression == 8 || compression == 32946) {
            uLongf avail = static_cast<uLongf>(expected - raw.size());
            std::vector<uint8_t> chunk(avail);
            uLongf got = avail;
            if (uncompress(chunk.data(), &got, src, strip_counts[s]) != Z_OK) return 5;
            raw.insert(raw.end(), chunk.begin(), chunk.begin() + got);
        } else {
            return 6;  // unsupported compression -> Python fallback
        }
    }
    if (raw.size() != expected) return 7;

    // TIFF predictor (tag 317). This decoder only reads strip files, and
    // strips hold whole rows, so horizontal differencing (predictor 2) is
    // undone with a per-row prefix sum over the assembled raster. The
    // floating-point predictor (3) needs a byte de-interleave — defer to the
    // Python codec (io/geotiff.py decodes it) rather than decode garbage.
    if (predictor == 2) {
        if (sample_format == 1 && bits == 8) {
            for (uint32_t y = 0; y < height; ++y) {
                uint8_t* row = raw.data() + static_cast<size_t>(y) * width;
                for (uint32_t x = 1; x < width; ++x) row[x] = static_cast<uint8_t>(row[x] + row[x - 1]);
            }
        } else if (sample_format == 2 && bits == 16) {
            for (uint32_t y = 0; y < height; ++y) {
                int16_t* row = reinterpret_cast<int16_t*>(raw.data()) + static_cast<size_t>(y) * width;
                for (uint32_t x = 1; x < width; ++x)
                    row[x] = static_cast<int16_t>(static_cast<uint16_t>(row[x]) + static_cast<uint16_t>(row[x - 1]));
            }
        } else {
            return 11;  // predictor-2 on a sample type we don't un-difference
        }
    } else if (predictor != 1) {
        return 11;  // unknown / float predictor -> Python fallback
    }

    size_t count = static_cast<size_t>(width) * height;
    if (sample_format == 3 && bits == 32) {
        std::memcpy(out, raw.data(), expected);
    } else if (sample_format == 1 && bits == 8) {
        for (size_t i = 0; i < count; ++i) out[i] = static_cast<float>(raw[i]);
    } else if (sample_format == 2 && bits == 16) {
        const int16_t* src = reinterpret_cast<const int16_t*>(raw.data());
        for (size_t i = 0; i < count; ++i) out[i] = static_cast<float>(src[i]);
    } else {
        return 8;
    }
    return 0;
}

}  // namespace

extern "C" {

// Probe dims: returns 0 and fills h/w on success.
int climsr_tiff_probe(const char* path, int32_t* h, int32_t* w) {
    try {
        FileBuf fb = read_file(path);
        if (!fb.ok) return 10;
        return decode_tiff_f32_impl(fb.data.data(), fb.data.size(), nullptr, h, w);
    } catch (...) {
        return 12;  // never let a C++ exception cross into ctypes
    }
}

// Decode into caller-provided buffer of h*w floats.
int climsr_tiff_read_f32(const char* path, float* out, int32_t h, int32_t w) {
    try {
        FileBuf fb = read_file(path);
        if (!fb.ok) return 10;
        // validate dims BEFORE writing: the file may have changed between the
        // caller's probe and this read, and out only holds h*w floats — a
        // dims-first pass prevents a heap overflow on such races
        int32_t gh = 0, gw = 0;
        int rc = decode_tiff_f32_impl(fb.data.data(), fb.data.size(), nullptr, &gh, &gw);
        if (rc != 0) return rc;
        if (gh != h || gw != w) return 9;
        return decode_tiff_f32_impl(fb.data.data(), fb.data.size(), out, &gh, &gw);
    } catch (...) {
        return 12;
    }
}

// Nearest resize, cv2 semantics (src index = floor(dst * src/dst)).
void climsr_nearest_resize_f32(const float* src, int32_t sh, int32_t sw,
                               float* dst, int32_t dh, int32_t dw) {
    for (int32_t y = 0; y < dh; ++y) {
        int32_t sy = static_cast<int32_t>(static_cast<int64_t>(y) * sh / dh);
        const float* srow = src + static_cast<size_t>(sy) * sw;
        float* drow = dst + static_cast<size_t>(y) * dw;
        for (int32_t x = 0; x < dw; ++x) {
            drow[x] = srow[static_cast<int64_t>(x) * sw / dw];
        }
    }
}

// Batch decode: n tiles of identical (h, w) into out[n, h, w]; GIL-free C++
// threads. status[i] = per-file return code.
void climsr_tiff_read_batch_f32(const char** paths, int32_t n, float* out,
                                int32_t h, int32_t w, int32_t n_threads,
                                int32_t* status) {
    if (n_threads < 1) n_threads = 1;
    try {
        std::vector<std::thread> workers;
        const size_t tile = static_cast<size_t>(h) * w;
        auto work = [&](int32_t tid) {
            for (int32_t i = tid; i < n; i += n_threads) {
                status[i] = climsr_tiff_read_f32(paths[i], out + tile * i, h, w);
            }
        };
        for (int32_t t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
        for (auto& th : workers) th.join();
    } catch (...) {
        for (int32_t i = 0; i < n; ++i) status[i] = 12;
    }
}

}  // extern "C"
