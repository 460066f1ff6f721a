// gs360x native host library.
//
// The device owns all pixel *math*; this library owns the host-side byte
// plumbing around it — the operations the reference delegated to ffmpeg's
// and OpenCV's native cores (SURVEY §2.2): YUV→RGB for the pure-Python
// video codecs, and RIFF/MJPEG-AVI demux scanning. Python
// binds via ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libgs360x_native.so \
//            gs360x_native.cpp

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// YUV -> RGB (BT.601 limited range; the Y4M codec path)
// ---------------------------------------------------------------------------

static inline uint8_t clamp_u8(float v) {
    return (uint8_t)(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
}

// planar 4:4:4 (3, H, W) -> interleaved RGB (H, W, 3)
int gs_yuv444_to_rgb(const uint8_t* yuv, uint8_t* rgb,
                     int64_t h, int64_t w) {
    const int64_t plane = h * w;
    const uint8_t* Y = yuv;
    const uint8_t* U = yuv + plane;
    const uint8_t* V = yuv + 2 * plane;
    for (int64_t i = 0; i < plane; ++i) {
        float y = ((float)Y[i] - 16.0f) * (255.0f / 219.0f);
        float u = ((float)U[i] - 128.0f) * (255.0f / 224.0f);
        float v = ((float)V[i] - 128.0f) * (255.0f / 224.0f);
        float r = y + 1.402f * v;
        float b = y + 1.772f * u;
        float g = (y - 0.299f * r - 0.114f * b) / 0.587f;
        rgb[3 * i + 0] = clamp_u8(r + 0.5f);
        rgb[3 * i + 1] = clamp_u8(g + 0.5f);
        rgb[3 * i + 2] = clamp_u8(b + 0.5f);
    }
    return 0;
}

// planar 4:2:0 -> interleaved RGB (nearest chroma upsample)
int gs_yuv420_to_rgb(const uint8_t* yuv, uint8_t* rgb,
                     int64_t h, int64_t w) {
    const int64_t plane = h * w;
    const int64_t cw = w / 2;
    const uint8_t* Y = yuv;
    const uint8_t* U = yuv + plane;
    const uint8_t* V = U + plane / 4;
    for (int64_t yy = 0; yy < h; ++yy) {
        const uint8_t* urow = U + (yy / 2) * cw;
        const uint8_t* vrow = V + (yy / 2) * cw;
        for (int64_t xx = 0; xx < w; ++xx) {
            const int64_t i = yy * w + xx;
            float y = ((float)Y[i] - 16.0f) * (255.0f / 219.0f);
            float u = ((float)urow[xx / 2] - 128.0f) * (255.0f / 224.0f);
            float v = ((float)vrow[xx / 2] - 128.0f) * (255.0f / 224.0f);
            float r = y + 1.402f * v;
            float b = y + 1.772f * u;
            float g = (y - 0.299f * r - 0.114f * b) / 0.587f;
            rgb[3 * i + 0] = clamp_u8(r + 0.5f);
            rgb[3 * i + 1] = clamp_u8(g + 0.5f);
            rgb[3 * i + 2] = clamp_u8(b + 0.5f);
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// RIFF / MJPEG-AVI demux scan
// ---------------------------------------------------------------------------

struct AviInfo {
    int32_t width;
    int32_t height;
    int32_t fps_num;
    int32_t fps_den;
    int64_t n_frames;
};

static uint32_t rd32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

// Scan an AVI byte range for headers and 00dc/00db chunk offsets.
// offsets/sizes arrays must hold max_frames entries. Returns the number of
// frames found, or -1 on malformed input.
int64_t gs_avi_scan(const uint8_t* data, int64_t len,
                    int64_t* offsets, int64_t* sizes, int64_t max_frames,
                    AviInfo* info) {
    if (len < 12 || memcmp(data, "RIFF", 4) != 0 ||
        memcmp(data + 8, "AVI ", 4) != 0)
        return -1;
    info->width = info->height = 0;
    info->fps_num = 30;
    info->fps_den = 1;
    int64_t count = 0;

    // iterative chunk walk with an explicit stack of (pos, end)
    std::vector<std::pair<int64_t, int64_t>> stack;
    stack.push_back({12, len});
    bool have_strh = false, have_strf = false;
    while (!stack.empty()) {
        auto [pos, end] = stack.back();
        stack.pop_back();
        while (pos + 8 <= end) {
            const uint8_t* hdr = data + pos;
            uint32_t size = rd32(hdr + 4);
            int64_t body = pos + 8;
            if (body + size > (uint64_t)len) break;
            if (memcmp(hdr, "LIST", 4) == 0) {
                stack.push_back({body + size + (size & 1), end});
                pos = body + 4;
                end = body + size;
                continue;
            }
            if (!have_strh && memcmp(hdr, "strh", 4) == 0 && size >= 28 &&
                memcmp(data + body, "vids", 4) == 0) {
                uint32_t scale = rd32(data + body + 20);
                uint32_t rate = rd32(data + body + 24);
                if (scale && rate) {
                    info->fps_num = (int32_t)rate;
                    info->fps_den = (int32_t)scale;
                }
                have_strh = true;
            } else if (!have_strf && memcmp(hdr, "strf", 4) == 0 &&
                       size >= 12) {
                info->width = (int32_t)rd32(data + body + 4);
                int32_t h32 = (int32_t)rd32(data + body + 8);
                info->height = h32 < 0 ? -h32 : h32;
                have_strf = true;
            } else if ((memcmp(hdr, "00dc", 4) == 0 ||
                        memcmp(hdr, "00db", 4) == 0) && size > 0) {
                if (count < max_frames) {
                    offsets[count] = body;
                    sizes[count] = (int64_t)size;
                }
                ++count;
            }
            pos = body + size + (size & 1);
        }
    }
    info->n_frames = count;
    return count < max_frames ? count : max_frames;
}

}  // extern "C"
