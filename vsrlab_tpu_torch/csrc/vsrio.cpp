// vsrio: the host data core of vsrlab_tpu_torch (its own copy of the JAX
// package's library of the same name).
//
// The host-side input pipeline does per-sample frame decode and
// degradation. This library does that work in C++ with a thread pool,
// writing straight into caller-provided float32 buffers (no per-frame
// Python objects, no GIL ping-pong):
//
//   * vsrio_codec_degrade    - inter-frame DCT-residual codec emulator
//                              (native form of data/codec_emulator.py);
//                              plain C++, always built
//   * vsrio_decode_clip      - image files -> (T, H, W, 3) float32 RGB [0,1],
//                              optional resize                  [OpenCV]
//   * vsrio_bicubic_resize   - batch bicubic resize of a float32 clip [OpenCV]
//   * vsrio_jpeg_degrade     - per-frame JPEG encode/decode round trip [OpenCV]
//
// The OpenCV entry points are compiled only with -DVSRIO_OPENCV, which
// vsrlab_tpu_torch/build.py sets where the opencv4 headers are found.
// Loaded through ctypes (vsrlab_tpu_torch/data/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

#ifdef VSRIO_OPENCV
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#endif

namespace {

// Run fn(i) for i in [0, n) on up to `threads` workers.
void parallel_for(int n, int threads, const std::function<void(int)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&] {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  int k = std::min(threads, n);
  std::vector<std::thread> pool;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

#ifdef VSRIO_OPENCV
namespace {

// BGR uint8 -> RGB float32 [0,1] into `dst` (h*w*3 floats).
void to_rgb_float(const cv::Mat& bgr, float* dst) {
  const int h = bgr.rows, w = bgr.cols;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = bgr.ptr<uint8_t>(y);
    float* out = dst + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      out[3 * x + 0] = row[3 * x + 2] * (1.0f / 255.0f);
      out[3 * x + 1] = row[3 * x + 1] * (1.0f / 255.0f);
      out[3 * x + 2] = row[3 * x + 0] * (1.0f / 255.0f);
    }
  }
}

}  // namespace

extern "C" {

// Decode `n` image files into out (n, out_h, out_w, 3) float32 RGB.
// paths: array of NUL-terminated UTF-8 strings. If out_h/out_w are 0 the
// native size is used (all frames must then share it). Returns 0 on success,
// else the 1-based index of the first file that failed.
int vsrio_decode_clip(const char** paths, int n, float* out, int out_h,
                      int out_w, int threads) {
  if (n <= 0) return 0;
  int ref_h = out_h, ref_w = out_w;
  if (ref_h <= 0 || ref_w <= 0) {
    // native-size mode: frame 0 fixes the clip size; every other frame
    // must match it (writing at self-sized offsets would overrun the
    // caller's (n, h0, w0, 3) buffer on mixed-resolution inputs)
    cv::Mat first = cv::imread(paths[0], cv::IMREAD_COLOR);
    if (first.empty()) return 1;
    ref_h = first.rows;
    ref_w = first.cols;
  }
  std::atomic<int> failed{0};
  parallel_for(n, threads, [&](int i) {
    cv::Mat img = cv::imread(paths[i], cv::IMREAD_COLOR);
    if (img.empty()) {
      int expected = 0;
      failed.compare_exchange_strong(expected, i + 1);
      return;
    }
    if (out_h > 0 && out_w > 0) {
      if (img.rows != out_h || img.cols != out_w) {
        cv::resize(img, img, cv::Size(out_w, out_h), 0, 0, cv::INTER_AREA);
      }
    } else if (img.rows != ref_h || img.cols != ref_w) {
      int expected = 0;  // size mismatch = failure, not heap corruption
      failed.compare_exchange_strong(expected, i + 1);
      return;
    }
    to_rgb_float(img, out + static_cast<size_t>(i) * ref_h * ref_w * 3);
  });
  return failed.load();
}

// Bicubic-resize a float32 RGB clip (t, h, w, 3) -> (t, out_h, out_w, 3).
void vsrio_bicubic_resize(const float* in, int t, int h, int w, float* out,
                          int out_h, int out_w, int threads) {
  parallel_for(t, threads, [&](int i) {
    cv::Mat src(h, w, CV_32FC3,
                const_cast<float*>(in + static_cast<size_t>(i) * h * w * 3));
    cv::Mat dst(out_h, out_w, CV_32FC3,
                out + static_cast<size_t>(i) * out_h * out_w * 3);
    cv::Mat tmp;
    cv::resize(src, tmp, cv::Size(out_w, out_h), 0, 0, cv::INTER_CUBIC);
    // clamp to [0,1] like the python pipeline
    cv::min(cv::max(tmp, 0.0f), 1.0f, tmp);
    tmp.copyTo(dst);
  });
}

// JPEG round-trip degradation on a float32 RGB clip (t, h, w, 3), in place
// semantics via separate out buffer. quality in [1, 100].
void vsrio_jpeg_degrade(const float* in, int t, int h, int w, int quality,
                        float* out, int threads) {
  parallel_for(t, threads, [&](int i) {
    cv::Mat rgb(h, w, CV_32FC3,
                const_cast<float*>(in + static_cast<size_t>(i) * h * w * 3));
    cv::Mat u8, bgr;
    rgb.convertTo(u8, CV_8UC3, 255.0);
    cv::cvtColor(u8, bgr, cv::COLOR_RGB2BGR);
    std::vector<uint8_t> buf;
    cv::imencode(".jpg", bgr, buf, {cv::IMWRITE_JPEG_QUALITY, quality});
    cv::Mat dec = cv::imdecode(buf, cv::IMREAD_COLOR);
    if (dec.empty() || dec.rows != h || dec.cols != w) {
      // encode/decode failure: pass the frame through undegraded rather
      // than returning uninitialised output memory
      std::copy(in + static_cast<size_t>(i) * h * w * 3,
                in + static_cast<size_t>(i + 1) * h * w * 3,
                out + static_cast<size_t>(i) * h * w * 3);
      return;
    }
    to_rgb_float(dec, out + static_cast<size_t>(i) * h * w * 3);
  });
}

}  // extern "C"
#endif  // VSRIO_OPENCV

// ---------------------------------------------------------------------------
// Inter-frame DCT-residual codec emulator: the native form of
// vsrlab_tpu_torch/data/codec_emulator.py (closed GOP, IPPP, YCbCr 4:2:0,
// libjpeg quant tables). Semantics must match the numpy path; the tests
// compare the two.

namespace codec {

constexpr float kQLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr float kQChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

void make_basis(float* B) {
  for (int k = 0; k < 8; ++k) {
    for (int n = 0; n < 8; ++n) {
      double b = std::cos(M_PI * (2 * n + 1) * k / 16.0) * std::sqrt(2.0 / 8.0);
      if (k == 0) b /= std::sqrt(2.0);
      B[k * 8 + n] = static_cast<float>(b);
    }
  }
}

void scale_table(const float* t, float quality, float* out) {
  float q = std::min(100.0f, std::max(1.0f, quality));
  float s = q < 50.0f ? 5000.0f / q : 200.0f - 2.0f * q;
  for (int i = 0; i < 64; ++i) {
    float v = std::floor((t[i] * s + 50.0f) / 100.0f);
    out[i] = std::min(255.0f, std::max(1.0f, v));
  }
}

// DCT -> quantize -> dequantize -> IDCT on one 8x8 block (row stride w).
void quantize_block(float* p, int w, const float* B, const float* qt) {
  float tmp[64], coef[64];
  // tmp = B * block
  for (int k = 0; k < 8; ++k)
    for (int m = 0; m < 8; ++m) {
      float s = 0.0f;
      for (int n = 0; n < 8; ++n) s += B[k * 8 + n] * p[n * w + m];
      tmp[k * 8 + m] = s;
    }
  // coef = tmp * B^T, quantized
  for (int k = 0; k < 8; ++k)
    for (int l = 0; l < 8; ++l) {
      float s = 0.0f;
      for (int m = 0; m < 8; ++m) s += tmp[k * 8 + m] * B[l * 8 + m];
      coef[k * 8 + l] = std::nearbyintf(s / qt[k * 8 + l]) * qt[k * 8 + l];
    }
  // tmp = B^T * coef
  for (int n = 0; n < 8; ++n)
    for (int l = 0; l < 8; ++l) {
      float s = 0.0f;
      for (int k = 0; k < 8; ++k) s += B[k * 8 + n] * coef[k * 8 + l];
      tmp[n * 8 + l] = s;
    }
  // block = tmp * B
  for (int n = 0; n < 8; ++n)
    for (int m = 0; m < 8; ++m) {
      float s = 0.0f;
      for (int l = 0; l < 8; ++l) s += tmp[n * 8 + l] * B[l * 8 + m];
      p[n * w + m] = s;
    }
}

void quantize_plane(float* p, int h, int w, const float* B, const float* qt,
                    int threads) {
  // thread spawn/join costs ~10s of microseconds per pool — more than
  // the DCT work of a small plane (a 32x32 chroma plane is 4 block-rows
  // of ~2 kFLOP each). Stay serial below ~64 block-rows of work.
  if (static_cast<long long>(h) * w < 128 * 128) threads = 1;
  parallel_for(h / 8, threads, [&](int by) {
    for (int bx = 0; bx < w / 8; ++bx)
      quantize_block(p + (by * 8) * static_cast<size_t>(w) + bx * 8, w, B, qt);
  });
}

}  // namespace codec

extern "C" {

// DCT-residual codec round-trip on a float32 RGB clip (t, h, w, 3) in [0,1].
// quality in [1,100]; gop = keyframe interval; subsample: 4:2:0 chroma.
void vsrio_codec_degrade(const float* in, int t, int h, int w, float quality,
                         int gop, int subsample, float* out, int threads) {
  const int hp = (h + 15) / 16 * 16, wp = (w + 15) / 16 * 16;
  const int hc = hp / 2, wc = wp / 2;
  float B[64], ql[64], qc[64];
  codec::make_basis(B);
  codec::scale_table(codec::kQLuma, quality, ql);
  codec::scale_table(codec::kQChroma, quality, qc);

  const size_t luma_n = static_cast<size_t>(hp) * wp;
  const size_t chroma_n = subsample ? static_cast<size_t>(hc) * wc : luma_n;
  std::vector<float> ycc(luma_n * 3);          // current frame planes, padded
  std::vector<float> plane_y(luma_n), plane_cb(chroma_n), plane_cr(chroma_n);
  std::vector<float> prev_y(luma_n), prev_cb(chroma_n), prev_cr(chroma_n);

  for (int i = 0; i < t; ++i) {
    const float* frame = in + static_cast<size_t>(i) * h * w * 3;
    // RGB -> YCbCr * 255 with edge padding
    for (int y = 0; y < hp; ++y) {
      const int sy = std::min(y, h - 1);
      for (int x = 0; x < wp; ++x) {
        const int sx = std::min(x, w - 1);
        const float r = frame[(static_cast<size_t>(sy) * w + sx) * 3 + 0];
        const float g = frame[(static_cast<size_t>(sy) * w + sx) * 3 + 1];
        const float b = frame[(static_cast<size_t>(sy) * w + sx) * 3 + 2];
        const size_t o = static_cast<size_t>(y) * wp + x;
        ycc[o] = (0.299f * r + 0.587f * g + 0.114f * b) * 255.0f;
        ycc[luma_n + o] =
            (-0.168736f * r - 0.331264f * g + 0.5f * b + 0.5f) * 255.0f;
        ycc[2 * luma_n + o] =
            (0.5f * r - 0.418688f * g - 0.081312f * b + 0.5f) * 255.0f;
      }
    }
    const bool is_i = (i % gop) == 0;
    // luma
    for (size_t k = 0; k < luma_n; ++k)
      plane_y[k] = ycc[k] - (is_i ? 0.0f : prev_y[k]);
    codec::quantize_plane(plane_y.data(), hp, wp, B, ql, threads);
    for (size_t k = 0; k < luma_n; ++k)
      plane_y[k] += is_i ? 0.0f : prev_y[k];
    // chroma (optionally 2x2-mean subsampled)
    for (int c = 0; c < 2; ++c) {
      float* plane = c == 0 ? plane_cb.data() : plane_cr.data();
      float* prev = c == 0 ? prev_cb.data() : prev_cr.data();
      const float* src = ycc.data() + (c + 1) * luma_n;
      if (subsample) {
        for (int y = 0; y < hc; ++y)
          for (int x = 0; x < wc; ++x)
            plane[static_cast<size_t>(y) * wc + x] =
                0.25f * (src[(2 * y) * static_cast<size_t>(wp) + 2 * x] +
                         src[(2 * y + 1) * static_cast<size_t>(wp) + 2 * x] +
                         src[(2 * y) * static_cast<size_t>(wp) + 2 * x + 1] +
                         src[(2 * y + 1) * static_cast<size_t>(wp) + 2 * x + 1]);
      } else {
        std::memcpy(plane, src, luma_n * sizeof(float));
      }
      const int ph = subsample ? hc : hp, pw = subsample ? wc : wp;
      if (!is_i)
        for (size_t k = 0; k < chroma_n; ++k) plane[k] -= prev[k];
      codec::quantize_plane(plane, ph, pw, B, qc, threads);
      if (!is_i)
        for (size_t k = 0; k < chroma_n; ++k) plane[k] += prev[k];
    }
    // stash recon as next reference
    std::memcpy(prev_y.data(), plane_y.data(), luma_n * sizeof(float));
    std::memcpy(prev_cb.data(), plane_cb.data(), chroma_n * sizeof(float));
    std::memcpy(prev_cr.data(), plane_cr.data(), chroma_n * sizeof(float));
    // YCbCr -> RGB, crop, clip
    float* dst = out + static_cast<size_t>(i) * h * w * 3;
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const size_t lo = static_cast<size_t>(y) * wp + x;
        const size_t co = subsample
                              ? static_cast<size_t>(y / 2) * wc + x / 2
                              : lo;
        const float Y = plane_y[lo] / 255.0f;
        const float Cb = plane_cb[co] / 255.0f - 0.5f;
        const float Cr = plane_cr[co] / 255.0f - 0.5f;
        float r = Y + 1.402f * Cr;
        float g = Y - 0.344136f * Cb - 0.714136f * Cr;
        float b = Y + 1.772f * Cb;
        float* px = dst + (static_cast<size_t>(y) * w + x) * 3;
        px[0] = std::min(1.0f, std::max(0.0f, r));
        px[1] = std::min(1.0f, std::max(0.0f, g));
        px[2] = std::min(1.0f, std::max(0.0f, b));
      }
    }
  }
}

}  // extern "C"
