// eedata: the port's host-side JPEG decoder for the ImageNet / Tiny-ImageNet
// folder loaders (edge_enhancement_tpu_torch/data/native.py binds it with
// ctypes).
//
// Host code, not a kernel: a copy of the decode half of the JAX package's
// native data runtime (decode_one, rrc_box, center_box,
// ee_stream_decode_files, ee_jpeg_dims), so that the port's
// batches equal the JAX package's pixel for pixel where both link the same
// libjpeg:
//   - the IDCT runs at the smallest M/8 scale whose crop still covers the
//     target size, with libjpeg's JDCT_IFAST;
//   - the crop box is mapped into scaled coordinates (lround for its size);
//   - the box is resized with Q8 fixed-point bilinear weights from
//     per-column tables (integer-only arithmetic).
// The JAX runtime's gather, hflip, pad-crop, rotate and resize entry points
// are not copied: the port does those in numpy (data/datasets.py).
//
// Built at first use by data/native.py:
//   g++ -O3 -shared -fPIC -std=c++17 -fopenmp [-DEE_HAVE_JPEG -ljpeg]
// Without libjpeg the entry points are stubs that report every file as
// failed, and the Python loader decodes with PIL instead.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef EE_HAVE_JPEG
#include <jpeglib.h>
#include <jerror.h>
#endif

namespace {

// OpenMP threads of one ee_stream_decode_files call; 0 = the runtime's
// default (OMP_NUM_THREADS, else one per core)
int g_threads = 0;

int team_size() {
#ifdef _OPENMP
    return g_threads > 0 ? g_threads : omp_get_max_threads();
#else
    return 1;
#endif
}

}  // namespace

extern "C" {

void ee_set_num_threads(int32_t n) { g_threads = n > 0 ? n : 0; }

// The OpenMP team size of an ee_stream_decode_files call (1 without OpenMP).
int ee_num_threads() { return team_size(); }

#ifdef EE_HAVE_JPEG

namespace {

struct EeJpegErr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void ee_jpeg_error_exit(j_common_ptr cinfo) {
    EeJpegErr* err = reinterpret_cast<EeJpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

// Decode one JPEG with the crop box (by, bx, bh, bw) given in ORIGINAL image
// coordinates (bh <= 0 means full image), bilinear-resized to (oh, ow) RGB.
// The IDCT runs at the smallest M/8 scale covering (oh, ow). Returns 0 on ok.
int decode_one(const uint8_t* data, int64_t len, int32_t by, int32_t bx,
               int32_t bh, int32_t bw, int64_t oh, int64_t ow, uint8_t* out) {
    jpeg_decompress_struct cinfo;
    EeJpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = ee_jpeg_error_exit;
    // every buffer that is live across a libjpeg call is constructed BEFORE
    // setjmp: error_exit longjmps here, and jumping over a vector's lifetime
    // would skip its destructor
    std::vector<uint8_t> buf;     // scaled crop rows, RGB
    std::vector<uint8_t> rowbuf;  // discard buffer for rows above the box
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    const int64_t full_h = cinfo.image_height, full_w = cinfo.image_width;
    if (bh <= 0 || bw <= 0) { by = 0; bx = 0;
        bh = (int32_t)full_h; bw = (int32_t)full_w; }
    by = std::max(0, std::min(by, (int32_t)full_h - 1));
    bx = std::max(0, std::min(bx, (int32_t)full_w - 1));
    bh = std::max(1, std::min(bh, (int32_t)full_h - by));
    bw = std::max(1, std::min(bw, (int32_t)full_w - bx));

    // smallest scale M/8 with scaled crop >= target (cap 8/8 = full size)
    int m = 8;
    for (int cand = 1; cand <= 8; ++cand) {
        if ((int64_t)bh * cand >= oh * 8 && (int64_t)bw * cand >= ow * 8) {
            m = cand;
            break;
        }
    }
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
    cinfo.out_color_space = JCS_RGB;
    cinfo.dct_method = JDCT_IFAST;
    jpeg_start_decompress(&cinfo);
    const int64_t sh = cinfo.output_height, sw = cinfo.output_width;
    // crop box in scaled coordinates
    const double sy_scale = (double)sh / full_h, sx_scale = (double)sw / full_w;
    int64_t cby = (int64_t)(by * sy_scale), cbx = (int64_t)(bx * sx_scale);
    int64_t cbh = std::max<int64_t>(1, (int64_t)std::lround(bh * sy_scale));
    int64_t cbw = std::max<int64_t>(1, (int64_t)std::lround(bw * sx_scale));
    cby = std::min(cby, sh - 1); cbx = std::min(cbx, sw - 1);
    cbh = std::min(cbh, sh - cby); cbw = std::min(cbw, sw - cbx);

    buf.resize((size_t)cbh * sw * 3);
    rowbuf.resize((size_t)sw * 3);
    JSAMPROW rowptr[1];
    while (cinfo.output_scanline < cinfo.output_height) {
        const int64_t y = cinfo.output_scanline;
        if (y >= cby && y < cby + cbh) {
            rowptr[0] = buf.data() + (size_t)(y - cby) * sw * 3;
        } else if (y >= cby + cbh) {
            jpeg_abort_decompress(&cinfo);  // skip the tail entirely
            break;
        } else {
            rowptr[0] = rowbuf.data();      // discard rows above the box
        }
        jpeg_read_scanlines(&cinfo, rowptr, 1);
    }
    if (cinfo.output_scanline >= cinfo.output_height) {
        jpeg_finish_decompress(&cinfo);
    }
    jpeg_destroy_decompress(&cinfo);

    // bilinear resize of the (cbh, cbw) box (rows in buf, x-offset cbx),
    // Q8 fixed-point weights with per-column tables
    std::vector<int32_t> xoff0(ow), xoff1(ow), wx(ow);
    {
        const int64_t scale_x_q16 = (cbw << 16) / ow;
        for (int64_t x = 0; x < ow; ++x) {
            int64_t sx_q16 = ((2 * x + 1) * scale_x_q16 - (1 << 16)) / 2;
            sx_q16 = std::max<int64_t>(0,
                std::min<int64_t>(sx_q16, (cbw - 1) << 16));
            const int64_t x0 = sx_q16 >> 16;
            const int64_t x1 = std::min(x0 + 1, cbw - 1);
            xoff0[x] = (int32_t)((cbx + x0) * 3);
            xoff1[x] = (int32_t)((cbx + x1) * 3);
            wx[x] = (int32_t)((sx_q16 >> 8) & 0xff);
        }
    }
    const int64_t scale_y_q16 = (cbh << 16) / oh;
    for (int64_t y = 0; y < oh; ++y) {
        int64_t sy_q16 = ((2 * y + 1) * scale_y_q16 - (1 << 16)) / 2;
        sy_q16 = std::max<int64_t>(0,
            std::min<int64_t>(sy_q16, (cbh - 1) << 16));
        const int64_t y0 = sy_q16 >> 16;
        const int64_t y1 = std::min(y0 + 1, cbh - 1);
        const int32_t fy = (int32_t)((sy_q16 >> 8) & 0xff);
        const uint8_t* r0 = buf.data() + (size_t)y0 * sw * 3;
        const uint8_t* r1 = buf.data() + (size_t)y1 * sw * 3;
        uint8_t* px = out + y * ow * 3;
        for (int64_t x = 0; x < ow; ++x) {
            const int32_t x0 = xoff0[x], x1 = xoff1[x], fx = wx[x];
            for (int k = 0; k < 3; ++k) {
                const int32_t top = (r0[x0 + k] << 8)
                                  + (r0[x1 + k] - r0[x0 + k]) * fx;
                const int32_t bot = (r1[x0 + k] << 8)
                                  + (r1[x1 + k] - r1[x0 + k]) * fx;
                px[x * 3 + k] =
                    (uint8_t)(((top << 8) + (bot - top) * fy + (1 << 15)) >> 16);
            }
        }
    }
    return 0;
}

}  // namespace

int ee_jpeg_dims(const uint8_t* data, int64_t len, int32_t* h, int32_t* w);

namespace {

// torchvision RandomResizedCrop box from 40 pre-drawn uniforms (10 tries x
// {scale, log-ratio, y, x}); centre-square fallback. Mirrored in Python
// (data/datasets.py::rrc_box_from_draws), so the native and PIL paths crop
// the same boxes from the same draws.
void rrc_box(const float* d, int64_t h, int64_t w, int32_t* box) {
    const double area = (double)h * w;
    const double lr_lo = std::log(3.0 / 4.0), lr_hi = std::log(4.0 / 3.0);
    for (int t = 0; t < 10; ++t) {
        const double target_area = (0.08 + d[t * 4] * 0.92) * area;
        const double ratio = std::exp(lr_lo + d[t * 4 + 1] * (lr_hi - lr_lo));
        const int64_t bw = (int64_t)std::lround(std::sqrt(target_area * ratio));
        const int64_t bh = (int64_t)std::lround(std::sqrt(target_area / ratio));
        if (bw > 0 && bw <= w && bh > 0 && bh <= h) {
            // double precision: the Python twin computes f64(draw) * int
            box[0] = (int32_t)((double)d[t * 4 + 2] * (double)(h - bh + 1));
            box[1] = (int32_t)((double)d[t * 4 + 3] * (double)(w - bw + 1));
            box[2] = (int32_t)bh;
            box[3] = (int32_t)bw;
            return;
        }
    }
    const int64_t s = std::min(h, w);
    box[0] = (int32_t)((h - s) / 2);
    box[1] = (int32_t)((w - s) / 2);
    box[2] = (int32_t)s;
    box[3] = (int32_t)s;
}

// Resize(short=eval_resize) + CenterCrop(eval_crop) as one original-
// resolution box (data/datasets.py::_eval_center_box).
void center_box(int64_t h, int64_t w, int32_t eval_resize, int32_t eval_crop,
                int32_t* box) {
    const int64_t s = std::min(h, w);
    int64_t side = (int64_t)std::lround((double)s * eval_crop / eval_resize);
    side = std::max<int64_t>(1, side);
    box[0] = (int32_t)((h - side) / 2);
    box[1] = (int32_t)((w - side) / 2);
    box[2] = (int32_t)side;
    box[3] = (int32_t)side;
}

}  // namespace

// One-call streaming batch: read each file, decode + crop + resize (+hflip)
// (+uint8 -> float32 [0,1] while the image is still cache-hot).
// paths_blob: NUL-terminated UTF-8 paths back to back; path_offsets[i] is
// the start of path i. mode: 0 = full-image resize, 1 = RandomResizedCrop
// (draws = n x 40 uniforms), 2 = eval centre box (eval_resize/eval_crop).
// flip_flags (may be NULL): apply horizontal flip per sample after resize.
// Exactly one of out_u8 / out_f32 must be non-NULL.
// Returns the number of failures (their slots zeroed).
int ee_stream_decode_files(const char* paths_blob, const int64_t* path_offsets,
                           int64_t n, int32_t mode, const float* draws,
                           int32_t eval_resize, int32_t eval_crop,
                           int64_t oh, int64_t ow, uint8_t* out_u8,
                           float* out_f32, const uint8_t* flip_flags) {
    int failures = 0;
    const int64_t elems = oh * ow * 3;
#pragma omp parallel num_threads(team_size())
    {
        std::vector<uint8_t> tmp(out_f32 ? (size_t)elems : 0);
#pragma omp for schedule(dynamic) reduction(+ : failures)
        for (int64_t i = 0; i < n; ++i) {
            uint8_t* dst = out_u8 ? out_u8 + i * elems : tmp.data();
            const char* path = paths_blob + path_offsets[i];
            std::vector<uint8_t> bytes;
            FILE* f = std::fopen(path, "rb");
            if (f) {
                std::fseek(f, 0, SEEK_END);
                const long sz = std::ftell(f);
                std::fseek(f, 0, SEEK_SET);
                if (sz > 0) {
                    bytes.resize((size_t)sz);
                    if (std::fread(bytes.data(), 1, (size_t)sz, f) != (size_t)sz)
                        bytes.clear();
                }
                std::fclose(f);
            }
            int rc = 1;
            if (!bytes.empty()) {
                int32_t h = 0, w = 0;
                if (ee_jpeg_dims(bytes.data(), (int64_t)bytes.size(), &h, &w) == 0) {
                    int32_t box[4] = {0, 0, -1, -1};
                    if (mode == 1) {
                        rrc_box(draws + i * 40, h, w, box);
                    } else if (mode == 2) {
                        center_box(h, w, eval_resize, eval_crop, box);
                    }
                    rc = decode_one(bytes.data(), (int64_t)bytes.size(), box[0],
                                    box[1], box[2], box[3], oh, ow, dst);
                }
            }
            if (rc != 0) {
                if (out_u8) std::memset(dst, 0, (size_t)elems);
                if (out_f32)
                    std::memset(out_f32 + i * elems, 0, (size_t)elems * 4);
                failures += 1;
                continue;
            }
            if (flip_flags && flip_flags[i]) {
                for (int64_t y = 0; y < oh; ++y) {
                    uint8_t* row = dst + y * ow * 3;
                    for (int64_t x = 0; x < ow / 2; ++x) {
                        for (int k = 0; k < 3; ++k)
                            std::swap(row[x * 3 + k], row[(ow - 1 - x) * 3 + k]);
                    }
                }
            }
            if (out_f32) {
                float* fdst = out_f32 + i * elems;
                constexpr float kInv = 1.0f / 255.0f;
                for (int64_t j = 0; j < elems; ++j) fdst[j] = dst[j] * kInv;
            }
        }
    }
    return failures;
}

// Header-only dimension query (no pixel decode). Returns 0 on success.
int ee_jpeg_dims(const uint8_t* data, int64_t len, int32_t* h, int32_t* w) {
    jpeg_decompress_struct cinfo;
    EeJpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = ee_jpeg_error_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    *h = (int32_t)cinfo.image_height;
    *w = (int32_t)cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

int ee_has_jpeg() { return 1; }

#else  // !EE_HAVE_JPEG

int ee_jpeg_dims(const uint8_t*, int64_t, int32_t*, int32_t*) { return 2; }
int ee_stream_decode_files(const char*, const int64_t*, int64_t n, int32_t,
                           const float*, int32_t, int32_t, int64_t, int64_t,
                           uint8_t*, float*, const uint8_t*) { return (int)n; }
int ee_has_jpeg() { return 0; }

#endif  // EE_HAVE_JPEG

}  // extern "C"
