// Native data-loading pipeline: JPEG decode + resize/crop/flip/normalize.
//
// The host side of the port's input pipeline (counterpart of
// `laudnet_tpu/data/csrc/loader.cpp`, the same source): PIL holds the GIL
// per image while this library decodes and transforms a whole batch across
// C++ threads in a single Python call.
//
// Semantics mirror laudnet_tpu_torch/data/transforms.py (itself mirroring
// the reference `utils/transform.py`):
//   train: RandomResizedCrop(size, scale=(0.08,1.0), ratio=(3/4,4/3),
//          10 attempts then resize-shorter+center-crop fallback)
//          + horizontal flip p=0.5 + optional normalize
//   eval:  resize shorter side to int(size/crop_ratio) + CenterCrop(size)
//          + optional normalize
// Resampling is PIL-compatible antialiased bilinear (triangle filter with
// support scaled by the downscale factor), computed in float32 — matches
// PIL.Image.resize(..., BILINEAR) to within quantization (PIL rounds each
// separable pass to uint8; we don't, which is strictly more accurate).
//
// Build: g++ -O3 -shared -fPIC loader.cpp -o libln_data.so -ljpeg -lpthread
// ABI: see ln_load_batch below; Python wrapper in ../native_loader.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------- RNG ----
// splitmix64: deterministic per-image stream from the caller's seed. The
// Python loader seeds `random.Random(seed)` per image; the native stream is
// deterministic in the same seed but is its own RNG family (augmentation
// randomness does not need to match Python draw-for-draw).
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
  // inclusive randint like python random.randint(0, hi)
  int64_t randint(int64_t hi) {
    return hi <= 0 ? 0 : (int64_t)(next() % (uint64_t)(hi + 1));
  }
};

// --------------------------------------------------------- JPEG decode ----
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG file to uint8 RGB HWC. Returns false on any failure.
bool decode_jpeg(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr for us
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  if (cinfo.output_components != 3 || *w <= 0 || *h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  out->resize((size_t)(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// ------------------------------------------- PIL-style triangle resize ----
// One separable pass along an axis: for output index i, the source center is
// in0 + (i + 0.5) * scale; the triangle filter has support max(scale, 1)
// (antialias on downscale). Matches PIL's precompute_coeffs.
struct AxisCoeffs {
  std::vector<int> xmin, xlen;
  std::vector<float> weights;  // flattened, stride = max filter width
  int kmax = 0;
};

AxisCoeffs precompute(double in0, double in1, int in_size, int out_size) {
  AxisCoeffs c;
  double scale = (in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = filterscale;  // bilinear support = 1.0 * filterscale
  int kmax = (int)std::ceil(support) * 2 + 1;
  c.kmax = kmax;
  c.xmin.resize(out_size);
  c.xlen.resize(out_size);
  c.weights.assign((size_t)out_size * kmax, 0.f);
  double ss = 1.0 / filterscale;
  for (int i = 0; i < out_size; ++i) {
    double center = in0 + (i + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    int n = xmax - xmin;
    double sum = 0.0;
    std::vector<double> w(n);
    for (int x = 0; x < n; ++x) {
      double t = (x + xmin - center + 0.5) * ss;
      double v = t < 0 ? 1.0 + t : 1.0 - t;  // triangle
      w[x] = v > 0 ? v : 0.0;
      sum += w[x];
    }
    c.xmin[i] = xmin;
    c.xlen[i] = n;
    for (int x = 0; x < n; ++x)
      c.weights[(size_t)i * kmax + x] = (float)(sum > 0 ? w[x] / sum : 0.0);
  }
  return c;
}

// Resize src (uint8 HWC) through box (x0,y0,x1,y1) to (oh, ow) float RGB.
void resize_box(const uint8_t* src, int sw, int sh, double x0, double y0,
                double x1, double y1, int ow, int oh, float* dst) {
  AxisCoeffs cx = precompute(x0, x1, sw, ow);
  AxisCoeffs cy = precompute(y0, y1, sh, oh);
  // the vertical pass only reads source rows inside the (dilated) box —
  // restrict the horizontal pass to that row range (a ~2x saving for
  // random crops that cover a fraction of the image)
  int row0 = sh, row1 = 0;
  for (int j = 0; j < oh; ++j) {
    row0 = std::min(row0, cy.xmin[j]);
    row1 = std::max(row1, cy.xmin[j] + cy.xlen[j]);
  }
  std::vector<float> tmp((size_t)(row1 - row0) * ow * 3);
  for (int y = row0; y < row1; ++y) {
    const uint8_t* row = src + (size_t)y * sw * 3;
    float* trow = tmp.data() + (size_t)(y - row0) * ow * 3;
    for (int i = 0; i < ow; ++i) {
      const float* w = &cx.weights[(size_t)i * cx.kmax];
      int xm = cx.xmin[i], n = cx.xlen[i];
      float r = 0, g = 0, b = 0;
      for (int x = 0; x < n; ++x) {
        const uint8_t* p = row + (size_t)(xm + x) * 3;
        float ww = w[x];
        r += ww * p[0];
        g += ww * p[1];
        b += ww * p[2];
      }
      trow[i * 3 + 0] = r;
      trow[i * 3 + 1] = g;
      trow[i * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int j = 0; j < oh; ++j) {
    const float* w = &cy.weights[(size_t)j * cy.kmax];
    int ym = cy.xmin[j], n = cy.xlen[j];
    float* drow = dst + (size_t)j * ow * 3;
    std::memset(drow, 0, sizeof(float) * ow * 3);
    for (int y = 0; y < n; ++y) {
      const float* trow = tmp.data() + (size_t)(ym + y - row0) * ow * 3;
      float ww = w[y];
      for (int k = 0; k < ow * 3; ++k) drow[k] += ww * trow[k];
    }
  }
}

// ------------------------------------------------------- per-image job ----
struct Job {
  const char* path;
  uint64_t seed;
  int out_size;
  bool train;
  double crop_ratio, scale_min, scale_max, ratio_min, ratio_max;
  bool normalize;
  const float* mean;
  const float* stdv;
  float* out;  // out_size*out_size*3
};

void finish(const Job& j, std::vector<float>& img, bool flip) {
  const int s = j.out_size;
  for (int y = 0; y < s; ++y) {
    for (int x = 0; x < s; ++x) {
      const float* p = &img[((size_t)y * s + (flip ? s - 1 - x : x)) * 3];
      float* q = j.out + ((size_t)y * s + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = p[c] / 255.0f;
        if (j.normalize) v = (v - j.mean[c]) / j.stdv[c];
        q[c] = v;
      }
    }
  }
}

// resize shorter side to `target`, center-crop out_size — the eval path and
// the RandomResizedCrop fallback (transforms.py:49-50, 89-99).
void resize_center_crop(const Job& j, const uint8_t* rgb, int w, int h,
                        int target, std::vector<float>& crop) {
  int rw, rh;
  if (w <= h) {
    rw = target;
    rh = (int)((double)target * h / w);  // int() truncation, like python
  } else {
    rh = target;
    rw = (int)((double)target * w / h);
  }
  std::vector<float> resized((size_t)rw * rh * 3);
  resize_box(rgb, w, h, 0, 0, w, h, rw, rh, resized.data());
  const int s = j.out_size;
  int cx0 = (rw - s) / 2, cy0 = (rh - s) / 2;
  crop.resize((size_t)s * s * 3);
  for (int y = 0; y < s; ++y)
    std::memcpy(&crop[(size_t)y * s * 3],
                &resized[((size_t)(y + cy0) * rw + cx0) * 3],
                sizeof(float) * s * 3);
}

bool process(const Job& j) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(j.path, &rgb, &w, &h)) return false;
  const int s = j.out_size;
  Rng rng(j.seed);
  std::vector<float> img;
  bool flip = false;
  if (j.train) {
    double area = (double)w * h;
    bool done = false;
    double lr0 = std::log(j.ratio_min), lr1 = std::log(j.ratio_max);
    for (int attempt = 0; attempt < 10 && !done; ++attempt) {
      double target = rng.uniform(j.scale_min, j.scale_max) * area;
      double ar = std::exp(rng.uniform(lr0, lr1));
      int cw = (int)std::lround(std::sqrt(target * ar));
      int ch = (int)std::lround(std::sqrt(target / ar));
      if (cw > 0 && cw <= w && ch > 0 && ch <= h) {
        int x0 = (int)rng.randint(w - cw);
        int y0 = (int)rng.randint(h - ch);
        img.resize((size_t)s * s * 3);
        resize_box(rgb.data(), w, h, x0, y0, x0 + cw, y0 + ch, s, s,
                   img.data());
        done = true;
      }
    }
    if (!done) resize_center_crop(j, rgb.data(), w, h, s, img);
    flip = rng.uniform() < 0.5;
  } else {
    int target = (int)(s / j.crop_ratio);
    resize_center_crop(j, rgb.data(), w, h, target, img);
  }
  finish(j, img, flip);
  return true;
}

}  // namespace

extern "C" {

// Load + transform a batch. `out` is (n, out_size, out_size, 3) float32;
// `ok[i]` is set to 1 on success, 0 on decode failure (caller falls back to
// the Python path for those images). Returns the number of failures.
int ln_load_batch(const char** paths, int n, const int64_t* seeds,
                  int out_size, int train, double crop_ratio,
                  double scale_min, double scale_max, double ratio_min,
                  double ratio_max, int normalize, const float* mean,
                  const float* stdv, float* out, uint8_t* ok, int n_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) {
      Job j{paths[i],   (uint64_t)seeds[i], out_size,  train != 0,
            crop_ratio, scale_min,          scale_max, ratio_min,
            ratio_max,  normalize != 0,     mean,      stdv,
            out + (size_t)i * out_size * out_size * 3};
      bool good = process(j);
      ok[i] = good ? 1 : 0;
      if (!good) failures.fetch_add(1);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    int nt = n_threads < n ? n_threads : n;
    ts.reserve(nt);
    for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return failures.load();
}

// Decode-only entry (testing / custom pipelines): full-resolution float RGB
// in [0,255]. Caller must pass a buffer of cap floats; returns -1 on decode
// failure, -2 if the image does not fit, else writes w/h and the pixels.
int ln_decode(const char* path, float* out, int64_t cap, int* w, int* h) {
  std::vector<uint8_t> rgb;
  if (!decode_jpeg(path, &rgb, w, h)) return -1;
  int64_t need = (int64_t)(*w) * (*h) * 3;
  if (need > cap) return -2;
  for (int64_t i = 0; i < need; ++i) out[i] = rgb[i];
  return 0;
}
}
