// Image preprocessing for the serving ingest path: bilinear resize +
// per-channel normalize, with optional symmetric int8 quantization so
// images hit the wire (and the host-to-device link) already in the engine's
// transfer dtype.
//
// The reference has no preprocessing of its own — callers hand
// ready-made NCHW blobs to Net::Forward ([pub] src/net.cpp) — but its
// production pipelines did this on the CPU before the call; this is the
// native data-loader stage of the rebuild's serving layer
// (feathercnn_tpu_torch/serve/preprocess.py binds it; its numpy path is
// the same math).
//
// Layout: NHWC, uint8 input (H_in, W_in, C) -> float32 or int8 output
// (H_out, W_out, C).  Bilinear uses half-pixel centers (align_corners
// false), matching the numpy path in serve/preprocess.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// out_f32 = (resize(img)[h,w,c]/255 - mean[c]) * inv_std[c]
void fcnn_preprocess_f32(const uint8_t* img, int h_in, int w_in, int c,
                         float* out, int h_out, int w_out,
                         const float* mean, const float* inv_std) {
  const float sy = static_cast<float>(h_in) / h_out;
  const float sx = static_cast<float>(w_in) / w_out;
  for (int y = 0; y < h_out; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h_in - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, h_in - 1);
    const float wy = fy - y0;
    for (int x = 0; x < w_out; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(w_in - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, w_in - 1);
      const float wx = fx - x0;
      const uint8_t* p00 = img + (y0 * w_in + x0) * c;
      const uint8_t* p01 = img + (y0 * w_in + x1) * c;
      const uint8_t* p10 = img + (y1 * w_in + x0) * c;
      const uint8_t* p11 = img + (y1 * w_in + x1) * c;
      float* o = out + (y * w_out + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
        const float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
        const float v = (top + (bot - top) * wy) / 255.0f;
        o[ch] = (v - mean[ch]) * inv_std[ch];
      }
    }
  }
}

// int8 variant: additionally quantize with a per-tensor scale
// (round-to-nearest, saturate to [-127, 127]) — the engine's w8a8
// transfer mode.
void fcnn_preprocess_i8(const uint8_t* img, int h_in, int w_in, int c,
                        int8_t* out, int h_out, int w_out,
                        const float* mean, const float* inv_std,
                        float inv_scale) {
  const float sy = static_cast<float>(h_in) / h_out;
  const float sx = static_cast<float>(w_in) / w_out;
  for (int y = 0; y < h_out; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h_in - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, h_in - 1);
    const float wy = fy - y0;
    for (int x = 0; x < w_out; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(w_in - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, w_in - 1);
      const float wx = fx - x0;
      const uint8_t* p00 = img + (y0 * w_in + x0) * c;
      const uint8_t* p01 = img + (y0 * w_in + x1) * c;
      const uint8_t* p10 = img + (y1 * w_in + x0) * c;
      const uint8_t* p11 = img + (y1 * w_in + x1) * c;
      int8_t* o = out + (y * w_out + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
        const float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
        const float v = (top + (bot - top) * wy) / 255.0f;
        const float q =
            std::nearbyint((v - mean[ch]) * inv_std[ch] * inv_scale);
        o[ch] = static_cast<int8_t>(
            std::max(-127.0f, std::min(127.0f, q)));
      }
    }
  }
}

}  // extern "C"
