// Native host-side IO for the data pipeline: PPM (P6) / PNG / JPEG
// decode, Middlebury .flo parse, bilinear resize, and a persistent
// thread pool for batch assembly.
//
// A copy of deepof_tpu/native/io_native.cc (the same decoders, resize
// and .flo reader, bit for bit), plus three entry points the port needs
// because it has no cv2: the codecs this build linked
// (`deepof_codecs`), an image's own size (`deepof_image_dims`) and a
// decode at that size to uint8 BGR (`deepof_decode_image_u8`), the
// counterpart of cv2.imread(path, IMREAD_COLOR); and the last two for an
// encoded image in memory (`deepof_image_dims_mem`,
// `deepof_decode_mem_u8`), the counterpart of cv2.imdecode.
//
// A whole batch decodes in parallel outside the GIL; Python binds via
// ctypes (deepof_tpu_torch/native/__init__.py), which builds this file
// with g++ at first use into build/deepof_tpu_torch/.
//
// Build (full): g++ -O3 -shared -fPIC -std=c++17 -pthread
//   -DDEEPOF_HAVE_PNG -DDEEPOF_HAVE_JPEG io_native.cc -lpng -ljpeg
//   -o libdeepof_io.so
// Without the codec defines the library builds with PPM+.flo only.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#ifdef DEEPOF_HAVE_PNG
#include <png.h>
#endif
#ifdef DEEPOF_HAVE_JPEG
#include <csetjmp>

#include <jpeglib.h>
#endif

namespace {

// ---------------------------------------------------------------- thread pool
class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

ThreadPool* pool() {
  static ThreadPool p(std::max(2u, std::thread::hardware_concurrency() / 2));
  return &p;
}

// A simple countdown latch so one batch call can await all its jobs.
struct Latch {
  explicit Latch(int n) : remaining(n) {}
  void done() {
    std::lock_guard<std::mutex> lk(mu);
    if (--remaining == 0) cv.notify_all();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return remaining == 0; });
  }
  int remaining;
  std::mutex mu;
  std::condition_variable cv;
};

constexpr int kMaxDim = 1 << 16;
// Per-dim bounds alone still admit a 64k x 64k header (12.9 GB RGB) whose
// vector::resize would throw bad_alloc; bound total pixels too so corrupt
// headers fail the call instead of throwing (67M px ~ 201 MB RGB, far
// above any dataset frame).
constexpr size_t kMaxPixels = size_t{1} << 26;

bool dims_ok(int w, int h) {
  return w > 0 && h > 0 && w <= kMaxDim && h <= kMaxDim &&
         static_cast<size_t>(w) * h <= kMaxPixels;
}

// ------------------------------------------------------------------ PPM (P6)
bool read_ppm_dims(FILE* f, int* w, int* h) {
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1 || strcmp(magic, "P6") != 0) return false;
  int vals[3], got = 0;
  while (got < 3) {
    int ch = fgetc(f);
    if (ch == EOF) return false;
    if (ch == '#') {  // comment to end of line
      while (ch != '\n' && ch != EOF) ch = fgetc(f);
      continue;
    }
    if (isspace(ch)) continue;
    ungetc(ch, f);
    if (fscanf(f, "%d", &vals[got]) != 1) return false;
    ++got;
  }
  fgetc(f);  // single whitespace before binary data
  if (vals[2] != 255) return false;
  // range-check: reject absurd/negative dims before any allocation (a
  // corrupt header must fail the call, not throw on a pool thread)
  if (!dims_ok(vals[0], vals[1])) return false;
  *w = vals[0];
  *h = vals[1];
  return true;
}

// decode one P6 stream (positioned at the magic) into uint8 RGB
bool decode_ppm_stream(FILE* f, std::vector<uint8_t>* buf, int* w, int* h) {
  if (!read_ppm_dims(f, w, h)) return false;
  size_t n = static_cast<size_t>(*w) * (*h) * 3;
  buf->resize(n);
  return fread(buf->data(), 1, n, f) == n;
}

// decode one P6 file into interleaved uint8 RGB (native size)
bool decode_ppm_file(const char* path, std::vector<uint8_t>* buf, int* w,
                     int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = decode_ppm_stream(f, buf, w, h);
  fclose(f);
  return ok;
}

#ifdef DEEPOF_HAVE_PNG
// decode one PNG stream (positioned at byte 0) via libpng's simplified API
bool decode_png_stream(FILE* f, std::vector<uint8_t>* buf, int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_stdio(&image, f)) return false;
  image.format = PNG_FORMAT_RGB;
  *w = static_cast<int>(image.width);
  *h = static_cast<int>(image.height);
  if (!dims_ok(*w, *h)) {
    png_image_free(&image);
    return false;
  }
  buf->resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, buf->data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}
#endif  // DEEPOF_HAVE_PNG

#ifdef DEEPOF_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// decode one JPEG stream (positioned at byte 0; libjpeg classic API;
// errors longjmp back instead of exiting the process)
bool decode_jpeg_stream(FILE* f, std::vector<uint8_t>* buf, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  if (!dims_ok(*w, *h) || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  buf->resize(static_cast<size_t>(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        buf->data() + static_cast<size_t>(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#endif  // DEEPOF_HAVE_JPEG

#ifdef DEEPOF_HAVE_PNG
bool png_stream_dims(FILE* f, int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_stdio(&image, f)) return false;
  *w = static_cast<int>(image.width);
  *h = static_cast<int>(image.height);
  png_image_free(&image);
  return dims_ok(*w, *h);
}
#endif  // DEEPOF_HAVE_PNG

#ifdef DEEPOF_HAVE_JPEG
bool jpeg_stream_dims(FILE* f, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return dims_ok(*w, *h);
}
#endif  // DEEPOF_HAVE_JPEG

enum class ImgFormat { kUnsupported, kPpm, kPng, kJpeg };

// the ONE magic-byte table (decode + the Python-side support probe)
ImgFormat sniff_format(const unsigned char sig[2]) {
  if (sig[0] == 'P' && sig[1] == '6') return ImgFormat::kPpm;
#ifdef DEEPOF_HAVE_PNG
  if (sig[0] == 0x89 && sig[1] == 'P') return ImgFormat::kPng;
#endif
#ifdef DEEPOF_HAVE_JPEG
  if (sig[0] == 0xFF && sig[1] == 0xD8) return ImgFormat::kJpeg;
#endif
  return ImgFormat::kUnsupported;
}

// dispatch PPM / PNG / JPEG by magic bytes; ONE open per file (the sniffed
// bytes are pushed back via rewind before the codec runs)
bool decode_image_file(const char* path, std::vector<uint8_t>* buf, int* w,
                       int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char sig[2] = {0, 0};
  if (fread(sig, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  switch (sniff_format(sig)) {
    case ImgFormat::kPpm:
      ok = decode_ppm_stream(f, buf, w, h);
      break;
#ifdef DEEPOF_HAVE_PNG
    case ImgFormat::kPng:
      ok = decode_png_stream(f, buf, w, h);
      break;
#endif
#ifdef DEEPOF_HAVE_JPEG
    case ImgFormat::kJpeg:
      ok = decode_jpeg_stream(f, buf, w, h);
      break;
#endif
    default:
      break;
  }
  fclose(f);
  return ok;
}

// the own size of a PPM / PNG / JPEG, without decoding its samples
bool image_file_dims(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char sig[2] = {0, 0};
  if (fread(sig, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  switch (sniff_format(sig)) {
    case ImgFormat::kPpm:
      ok = read_ppm_dims(f, w, h);
      break;
#ifdef DEEPOF_HAVE_PNG
    case ImgFormat::kPng:
      ok = png_stream_dims(f, w, h);
      break;
#endif
#ifdef DEEPOF_HAVE_JPEG
    case ImgFormat::kJpeg:
      ok = jpeg_stream_dims(f, w, h);
      break;
#endif
    default:
      break;
  }
  fclose(f);
  return ok;
}

// -------------------------------------------------------- bilinear resize
// uint8 RGB (sh, sw) -> float32 (dh, dw), channel order swapped to BGR to
// match the reference's cv2 pipeline (`flyingChairsLoader.py:71-79`).
void resize_bilinear_bgr(const uint8_t* src, int sh, int sw, float* dst,
                         int dh, int dw) {
  if (sh == dh && sw == dw) {
    // identity: pure uint8 -> float32 + RGB->BGR swap, no interpolation
    // (the FlyingChairs default keeps the native 384x512 resolution)
    const size_t n = static_cast<size_t>(sh) * sw;
    for (size_t i = 0; i < n; ++i) {
      dst[i * 3 + 0] = src[i * 3 + 2];
      dst[i * 3 + 1] = src[i * 3 + 1];
      dst[i * 3 + 2] = src[i * 3 + 0];
    }
    return;
  }
  // per-x coefficients once per image, not per pixel (the float math and
  // clamping in the inner loop cost more than the blend itself)
  std::vector<int> x0v(dw), x1v(dw);
  std::vector<float> wxv(dw);
  const float ys = static_cast<float>(sh) / dh;
  const float xs = static_cast<float>(sw) / dw;
  for (int x = 0; x < dw; ++x) {
    // cv2-style half-pixel centers
    float fx = (x + 0.5f) * xs - 0.5f;
    int x0 = static_cast<int>(fx > 0 ? fx : 0);
    if (x0 > sw - 1) x0 = sw - 1;
    x0v[x] = x0 * 3;
    x1v[x] = (x0 + 1 < sw ? x0 + 1 : sw - 1) * 3;
    float wx = fx - x0;
    wxv[x] = wx < 0 ? 0 : wx;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    int y0 = static_cast<int>(fy > 0 ? fy : 0);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    float* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* a = r0 + x0v[x];
      const uint8_t* b = r0 + x1v[x];
      const uint8_t* c = r1 + x0v[x];
      const uint8_t* d = r1 + x1v[x];
      const float wx = wxv[x];
      for (int ch = 0; ch < 3; ++ch) {
        float top = a[ch] + wx * (b[ch] - a[ch]);
        float bot = c[ch] + wx * (d[ch] - c[ch]);
        out[x * 3 + 2 - ch] = top + wy * (bot - top);  // RGB -> BGR
      }
    }
  }
}

constexpr float kFloMagic = 202021.25f;

}  // namespace

extern "C" {

// Decode one PPM to float32 BGR resized to (dh, dw). Returns 0 on success.
// try/catch: these are C-ABI entry points callable directly from ctypes —
// an exception (e.g. bad_alloc on a hostile header) must not unwind
// across the ABI and terminate the caller.
int deepof_decode_ppm(const char* path, float* out, int dh, int dw) {
  try {
    std::vector<uint8_t> buf;
    int w, h;
    if (!decode_ppm_file(path, &buf, &w, &h)) return 1;
    resize_bilinear_bgr(buf.data(), h, w, out, dh, dw);
    return 0;
  } catch (...) {
    return 2;
  }
}

// Decode one PPM/PNG/JPEG (dispatch by magic) to float32 BGR resized to
// (dh, dw). Returns 0 on success.
int deepof_decode_image(const char* path, float* out, int dh, int dw) {
  try {
    std::vector<uint8_t> buf;
    int w, h;
    if (!decode_image_file(path, &buf, &w, &h)) return 1;
    resize_bilinear_bgr(buf.data(), h, w, out, dh, dw);
    return 0;
  } catch (...) {
    return 2;
  }
}

// 1 iff this build can decode `path`'s format (by magic bytes).
int deepof_image_supported(const char* path) {
  unsigned char sig[2] = {0, 0};
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  size_t n = fread(sig, 1, 2, f);
  fclose(f);
  if (n < 2) return 0;
  return sniff_format(sig) != ImgFormat::kUnsupported ? 1 : 0;
}

// Decode a batch of images (mixed formats allowed) in parallel into
// (n, dh, dw, 3) float32 BGR. Returns number of failures.
int deepof_decode_image_batch(const char** paths, int n, float* out, int dh,
                              int dw) {
  Latch latch(n);
  std::atomic<int> failures{0};
  const size_t stride = static_cast<size_t>(dh) * dw * 3;
  for (int i = 0; i < n; ++i) {
    const char* p = paths[i];
    float* dst = out + stride * i;
    pool()->submit([p, dst, dh, dw, &latch, &failures] {
      try {
        if (deepof_decode_image(p, dst, dh, dw) != 0) failures++;
      } catch (...) {  // never let an exception escape a pool thread
        failures++;
      }
      latch.done();
    });
  }
  latch.wait();
  return failures.load();
}

// Probe a PPM's native dims.
int deepof_ppm_dims(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  bool ok = read_ppm_dims(f, w, h);
  fclose(f);
  return ok ? 0 : 1;
}

// Decode a batch of PPMs (kept for ABI compat; the generic image batch
// dispatches PPM by magic bytes). Returns number of failures.
int deepof_decode_ppm_batch(const char** paths, int n, float* out, int dh,
                            int dw) {
  return deepof_decode_image_batch(paths, n, out, dh, dw);
}

// Middlebury .flo: magic float 202021.25, int32 w, int32 h, then
// h*w*2 little-endian float32 (u, v interleaved). Returns 0 on success.
int deepof_flo_dims(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  float magic;
  int32_t ww, hh;
  bool ok = fread(&magic, 4, 1, f) == 1 && magic == kFloMagic &&
            fread(&ww, 4, 1, f) == 1 && fread(&hh, 4, 1, f) == 1;
  fclose(f);
  if (!ok) return 1;
  *w = ww;
  *h = hh;
  return 0;
}

int deepof_read_flo(const char* path, float* out, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  // validate the file's own header against the expected dims — the batch
  // API probes dims once from the first file; a mixed-resolution file must
  // fail loudly, not fread with the wrong row stride
  float magic;
  int32_t ww, hh;
  if (fread(&magic, 4, 1, f) != 1 || magic != kFloMagic ||
      fread(&ww, 4, 1, f) != 1 || fread(&hh, 4, 1, f) != 1 || ww != w ||
      hh != h) {
    fclose(f);
    return 1;
  }
  size_t n = static_cast<size_t>(h) * w * 2;
  bool ok = fread(out, 4, n, f) == n;
  fclose(f);
  return ok ? 0 : 1;
}

// Parallel batch .flo read into (n, h, w, 2) float32.
int deepof_read_flo_batch(const char** paths, int n, float* out, int h,
                          int w) {
  Latch latch(n);
  std::atomic<int> failures{0};
  const size_t stride = static_cast<size_t>(h) * w * 2;
  for (int i = 0; i < n; ++i) {
    const char* p = paths[i];
    float* dst = out + stride * i;
    pool()->submit([p, dst, h, w, &latch, &failures] {
      try {
        if (deepof_read_flo(p, dst, h, w) != 0) failures++;
      } catch (...) {
        failures++;
      }
      latch.done();
    });
  }
  latch.wait();
  return failures.load();
}

// The codecs of this build: bit 0 PPM (always), bit 1 PNG, bit 2 JPEG.
int deepof_codecs() {
  int bits = 1;
#ifdef DEEPOF_HAVE_PNG
  bits |= 2;
#endif
#ifdef DEEPOF_HAVE_JPEG
  bits |= 4;
#endif
  return bits;
}

// Probe a PPM / PNG / JPEG's own size. Returns 0 on success.
int deepof_image_dims(const char* path, int* h, int* w) {
  try {
    return image_file_dims(path, w, h) ? 0 : 1;
  } catch (...) {
    return 2;
  }
}

// Decode one PPM / PNG / JPEG at its own size, which must be (h, w), to
// uint8 BGR (h, w, 3): what cv2.imread(path, IMREAD_COLOR) returns.
// Returns 0 on success.
int deepof_decode_image_u8(const char* path, uint8_t* out, int h, int w) {
  try {
    std::vector<uint8_t> buf;
    int fw, fh;
    if (!decode_image_file(path, &buf, &fw, &fh)) return 1;
    if (fw != w || fh != h) return 1;
    const size_t n = static_cast<size_t>(h) * w;
    for (size_t i = 0; i < n; ++i) {
      out[i * 3 + 0] = buf[i * 3 + 2];
      out[i * 3 + 1] = buf[i * 3 + 1];
      out[i * 3 + 2] = buf[i * 3 + 0];
    }
    return 0;
  } catch (...) {
    return 2;
  }
}

// The same two calls on an encoded image held in memory (an HTTP
// request's bytes), through a read-only FILE* over the buffer
// (fmemopen), so every codec reads it as it reads a file.
int deepof_image_dims_mem(const uint8_t* data, size_t n, int* h, int* w) {
  try {
    if (n < 2) return 1;
    FILE* f = fmemopen(const_cast<uint8_t*>(data), n, "rb");
    if (!f) return 1;
    bool ok = false;
    switch (sniff_format(data)) {
      case ImgFormat::kPpm:
        ok = read_ppm_dims(f, w, h);
        break;
#ifdef DEEPOF_HAVE_PNG
      case ImgFormat::kPng:
        ok = png_stream_dims(f, w, h);
        break;
#endif
#ifdef DEEPOF_HAVE_JPEG
      case ImgFormat::kJpeg:
        ok = jpeg_stream_dims(f, w, h);
        break;
#endif
      default:
        break;
    }
    fclose(f);
    return ok ? 0 : 1;
  } catch (...) {
    return 2;
  }
}

int deepof_decode_mem_u8(const uint8_t* data, size_t n, uint8_t* out, int h,
                         int w) {
  try {
    if (n < 2) return 1;
    FILE* f = fmemopen(const_cast<uint8_t*>(data), n, "rb");
    if (!f) return 1;
    std::vector<uint8_t> buf;
    int fw = 0, fh = 0;
    bool ok = false;
    switch (sniff_format(data)) {
      case ImgFormat::kPpm:
        ok = decode_ppm_stream(f, &buf, &fw, &fh);
        break;
#ifdef DEEPOF_HAVE_PNG
      case ImgFormat::kPng:
        ok = decode_png_stream(f, &buf, &fw, &fh);
        break;
#endif
#ifdef DEEPOF_HAVE_JPEG
      case ImgFormat::kJpeg:
        ok = decode_jpeg_stream(f, &buf, &fw, &fh);
        break;
#endif
      default:
        break;
    }
    fclose(f);
    if (!ok || fw != w || fh != h) return 1;
    const size_t px = static_cast<size_t>(h) * w;
    for (size_t i = 0; i < px; ++i) {
      out[i * 3 + 0] = buf[i * 3 + 2];
      out[i * 3 + 1] = buf[i * 3 + 1];
      out[i * 3 + 2] = buf[i * 3 + 0];
    }
    return 0;
  } catch (...) {
    return 2;
  }
}

}  // extern "C"
