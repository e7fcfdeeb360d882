// Native image pipeline: JPEG/PNG decode + Lanczos-3 resize, batched over a
// thread pool. The port's copy of wildmvs/cpp/image.cpp (the code is the
// same; only this header differs). It replaces the reference's DataLoader
// worker pool (train.py:120, 8 CPU workers doing PIL decode + LANCZOS
// resize): ctypes calls release the GIL, the pool decodes a whole n-uplet
// of views concurrently, and data/prefetch.py overlaps the next sample
// with the device step.
//
// Decode backends: libjpeg (baseline+progressive JPEG) and libpng (via the
// libpng16 simplified API). Resize is a separable Lanczos (a=3) with PIL's
// box semantics (support = a * max(scale, 1), pixel centers at +0.5), so
// outputs match PIL.Image.resize(..., LANCZOS) to within rounding: PIL
// resamples through an 8-bit intermediate between the horizontal and
// vertical passes, we keep float32 throughout (strictly more precise).
//
// C API (ctypes, see wildmvs_torch/cpp/__init__.py):
//   wmvs_load_batch  — decode n files (+ optional min-side-fit resize) into
//                      malloc'd float32 [h, w, c] buffers in [0, 1]
//   wmvs_resize_f32  — standalone Lanczos resize of a float32 image
//   wmvs_free        — release a buffer returned by wmvs_load_batch

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- decode --

struct DecodeResult {
  std::vector<uint8_t> data;  // interleaved, 8-bit
  int h = 0, w = 0, c = 0;
  bool ok = false;
};

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

DecodeResult decode_jpeg(const char* path) {
  DecodeResult out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  // match PIL: gray stays 1-channel, everything else converts to RGB
  cinfo.out_color_space =
      (cinfo.jpeg_color_space == JCS_GRAYSCALE) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out.w = cinfo.output_width;
  out.h = cinfo.output_height;
  out.c = cinfo.output_components;
  out.data.resize(size_t(out.h) * out.w * out.c);
  const size_t stride = size_t(out.w) * out.c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out.data.data() + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  out.ok = true;
  return out;
}

DecodeResult decode_png(const char* path) {
  DecodeResult out;
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return out;
  // match PIL's np.asarray(Image.open(...)): gray -> [H,W], color -> RGB.
  // 16-bit, alpha and palette PNGs decode to DIFFERENT arrays under PIL
  // (uint16 range / [H,W,4] / palette indices) — refuse those here so the
  // caller's PIL fallback keeps the contract instead of silently
  // normalizing (wmvs_load_batch reports the failure; data.loaders
  // falls back for the batch).
  if (image.format & (PNG_FORMAT_FLAG_LINEAR | PNG_FORMAT_FLAG_ALPHA |
                      PNG_FORMAT_FLAG_COLORMAP)) {
    png_image_free(&image);
    return out;
  }
  const bool gray =
      (image.format & (PNG_FORMAT_FLAG_COLOR | PNG_FORMAT_FLAG_COLORMAP)) == 0;
  image.format = gray ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
  out.c = gray ? 1 : 3;
  out.h = image.height;
  out.w = image.width;
  out.data.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out.data.data(), 0, nullptr)) {
    png_image_free(&image);
    return out;
  }
  out.ok = true;
  return out;
}

bool has_suffix(const std::string& s, const char* suf) {
  const size_t n = strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; ++i) {
    char a = s[s.size() - n + i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != suf[i]) return false;
  }
  return true;
}

DecodeResult decode_any(const char* path) {
  const std::string p(path);
  if (has_suffix(p, ".png")) return decode_png(path);
  if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg"))
    return decode_jpeg(path);
  // sniff the magic bytes as a fallback
  FILE* f = fopen(path, "rb");
  if (!f) return {};
  unsigned char magic[4] = {0};
  const size_t got = fread(magic, 1, 4, f);
  fclose(f);
  if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P') return decode_png(path);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
    return decode_jpeg(path);
  return {};
}

// ---------------------------------------------------------------- resize --

// Lanczos kernel, a = 3 (PIL's LANCZOS / ANTIALIAS filter)
inline double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  const double px = M_PI * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

// PIL-style coefficient table: for every output index, the input window
// [bound0, bound1) and normalized weights.
struct ResampleCoeffs {
  std::vector<int> bound0, bound1;
  std::vector<std::vector<float>> weights;
};

ResampleCoeffs precompute(int in_size, int out_size) {
  ResampleCoeffs rc;
  rc.bound0.resize(out_size);
  rc.bound1.resize(out_size);
  rc.weights.resize(out_size);
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 3.0 * filterscale;
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int x0 = int(center - support + 0.5);
    int x1 = int(center + support + 0.5);
    if (x0 < 0) x0 = 0;
    if (x1 > in_size) x1 = in_size;
    rc.bound0[i] = x0;
    rc.bound1[i] = x1;
    auto& w = rc.weights[i];
    w.resize(x1 - x0);
    double total = 0.0;
    for (int x = x0; x < x1; ++x) {
      const double v = lanczos3((x - center + 0.5) / filterscale);
      w[x - x0] = float(v);
      total += v;
    }
    if (total != 0.0)
      for (auto& v : w) v = float(v / total);
  }
  return rc;
}

// separable Lanczos resize of float32 interleaved [h, w, c]
std::vector<float> resize_lanczos(const float* src, int h, int w, int c,
                                  int out_h, int out_w) {
  const ResampleCoeffs rx = precompute(w, out_w);
  const ResampleCoeffs ry = precompute(h, out_h);
  // horizontal pass: [h, w, c] -> [h, out_w, c]
  std::vector<float> tmp(size_t(h) * out_w * c);
  for (int y = 0; y < h; ++y) {
    const float* row = src + size_t(y) * w * c;
    float* orow = tmp.data() + size_t(y) * out_w * c;
    for (int i = 0; i < out_w; ++i) {
      const int x0 = rx.bound0[i], x1 = rx.bound1[i];
      const float* wt = rx.weights[i].data();
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int x = x0; x < x1; ++x) acc += row[x * c + ch] * wt[x - x0];
        orow[i * c + ch] = acc;
      }
    }
  }
  // vertical pass: [h, out_w, c] -> [out_h, out_w, c]
  std::vector<float> dst(size_t(out_h) * out_w * c);
  const size_t stride = size_t(out_w) * c;
  for (int i = 0; i < out_h; ++i) {
    const int y0 = ry.bound0[i], y1 = ry.bound1[i];
    const float* wt = ry.weights[i].data();
    float* orow = dst.data() + i * stride;
    std::fill(orow, orow + stride, 0.f);
    for (int y = y0; y < y1; ++y) {
      const float wv = wt[y - y0];
      const float* irow = tmp.data() + y * stride;
      for (size_t k = 0; k < stride; ++k) orow[k] += irow[k] * wv;
    }
  }
  return dst;
}

// --------------------------------------------------------------- workers --

struct LoadJob {
  const char* path;
  int resize_th, resize_tw;  // min-side-fit box; 0 = keep native size
  float* out = nullptr;      // malloc'd [h, w, c] in [0, 1]
  int h = 0, w = 0, c = 0;
  float ratio = 1.f;  // original / resized (read_image's r)
  int ok = 0;
};

void run_job(LoadJob& job) {
  DecodeResult dec = decode_any(job.path);
  if (!dec.ok) return;
  const size_t n = dec.data.size();
  std::vector<float> img(n);
  for (size_t i = 0; i < n; ++i) img[i] = dec.data[i] * (1.f / 255.f);
  int h = dec.h, w = dec.w;
  if (job.resize_th > 0 && job.resize_tw > 0) {
    // r = min(w/tw, h/th); new = (int(w/r), int(h/r))  [loaders.read_image]
    const double r = std::min(double(w) / job.resize_tw,
                              double(h) / job.resize_th);
    const int nw = int(w / r), nh = int(h / r);
    if (nw != w || nh != h)
      img = resize_lanczos(img.data(), h, w, dec.c, nh, nw);
    h = nh;
    w = nw;
    job.ratio = float(r);
  }
  const size_t bytes = size_t(h) * w * dec.c * sizeof(float);
  job.out = static_cast<float*>(malloc(bytes));
  if (!job.out) return;
  // clamp: Lanczos overshoots; PIL clips to uint8 range
  for (size_t i = 0; i < img.size(); ++i) {
    float v = img[i];
    job.out[i] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
  }
  job.h = h;
  job.w = w;
  job.c = dec.c;
  job.ok = 1;
}

}  // namespace

extern "C" {

// Decode (and optionally min-side-fit resize) n images in parallel.
// Outputs per image i: out_data[i] (malloc'd float32 [h,w,c] in [0,1] —
// free with wmvs_free), out_h/out_w/out_c[i], out_ratio[i]. Returns the
// number of successfully decoded images.
int wmvs_load_batch(const char** paths, int n, int resize_th, int resize_tw,
                    float** out_data, int* out_h, int* out_w, int* out_c,
                    float* out_ratio, int nthreads) {
  std::vector<LoadJob> jobs(n);
  for (int i = 0; i < n; ++i) {
    jobs[i].path = paths[i];
    jobs[i].resize_th = resize_th;
    jobs[i].resize_tw = resize_tw;
  }
  if (nthreads <= 0) nthreads = int(std::thread::hardware_concurrency());
  if (nthreads > n) nthreads = n;
  if (nthreads <= 1) {
    for (auto& j : jobs) run_job(j);
  } else {
    std::atomic<int> next{0};
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t)
      pool.emplace_back([&] {
        for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1))
          run_job(jobs[i]);
      });
    for (auto& th : pool) th.join();
  }
  int ok = 0;
  for (int i = 0; i < n; ++i) {
    out_data[i] = jobs[i].out;
    out_h[i] = jobs[i].h;
    out_w[i] = jobs[i].w;
    out_c[i] = jobs[i].c;
    out_ratio[i] = jobs[i].ratio;
    ok += jobs[i].ok;
  }
  return ok;
}

// Standalone Lanczos-3 resize: float32 [h, w, c] -> [out_h, out_w, c] into
// caller-allocated dst (no clamping — raw filter output).
void wmvs_resize_f32(const float* src, int h, int w, int c, int out_h,
                     int out_w, float* dst) {
  std::vector<float> out = resize_lanczos(src, h, w, c, out_h, out_w);
  memcpy(dst, out.data(), out.size() * sizeof(float));
}

void wmvs_free(void* p) { free(p); }

}  // extern "C"
