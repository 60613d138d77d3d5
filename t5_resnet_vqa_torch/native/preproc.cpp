// Native resize for the host input pipeline (the port's copy of the JAX
// package's native/preproc.cpp; the arithmetic is unchanged, so the two
// libraries give the same bits when built by the same compiler).
//
// Fuses cv2.resize -> ToTensor scale -> (ViT path) normalize into one
// cache-friendly C++ loop: bilinear resize with OpenCV's half-pixel
// coordinate mapping, uint8 -> float32 [0,1] scaling, and optional
// per-channel mean/std normalization, writing the NHWC float output
// directly (no intermediate uint8 buffer).
//
// Performance structure: the x-axis resample coordinates (x0, x1, wx) are
// loop-invariant across rows and precomputed once per image, so the hot
// inner loop is pure gather+FMA with no floor/clamp; the same-size case
// (no geometric resampling) collapses to a single scale pass the compiler
// auto-vectorizes.
//
// Built by native/loader.py with g++ at first use and loaded via ctypes.
// It agrees with the cv2 path within one uint8 step.

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// src: uint8 [sh, sw, 3] RGB; dst: float32 [dh, dw, 3].
// mean/std: nullptr or float[3] applied as (x/255 - mean) / std.
void resize_bilinear_scale(const uint8_t* src, int sh, int sw,
                           float* dst, int dh, int dw,
                           const float* mean, const float* std_) {
    const float inv255 = 1.0f / 255.0f;
    float ch_scale[3] = {inv255, inv255, inv255};
    float ch_bias[3] = {0.0f, 0.0f, 0.0f};
    const bool normalized = (mean != nullptr && std_ != nullptr);
    if (normalized) {
        for (int c = 0; c < 3; ++c) {
            ch_scale[c] = inv255 / std_[c];
            ch_bias[c] = -mean[c] / std_[c];
        }
    }

    // Same-size: no resampling, just the fused scale (vectorizable).
    if (sh == dh && sw == dw) {
        const size_t total = static_cast<size_t>(sh) * sw * 3;
        if (!normalized) {
            for (size_t i = 0; i < total; ++i)
                dst[i] = src[i] * inv255;
        } else {
            for (size_t i = 0; i < total; i += 3) {
                dst[i]     = src[i]     * ch_scale[0] + ch_bias[0];
                dst[i + 1] = src[i + 1] * ch_scale[1] + ch_bias[1];
                dst[i + 2] = src[i + 2] * ch_scale[2] + ch_bias[2];
            }
        }
        return;
    }

    // x-axis tables: byte offsets + lerp weight, computed once per image
    // (OpenCV half-pixel mapping: s = (d + 0.5) * scale - 0.5).
    const float scale_x = static_cast<float>(sw) / dw;
    std::vector<int> x0v(dw), x1v(dw);
    std::vector<float> wxv(dw);
    for (int dx = 0; dx < dw; ++dx) {
        const float fx = (dx + 0.5f) * scale_x - 0.5f;
        const int x0 = static_cast<int>(std::floor(fx));
        wxv[dx] = fx - x0;
        x0v[dx] = std::clamp(x0, 0, sw - 1) * 3;
        x1v[dx] = std::clamp(x0 + 1, 0, sw - 1) * 3;
    }

    const float scale_y = static_cast<float>(sh) / dh;
    for (int dy = 0; dy < dh; ++dy) {
        const float fy = (dy + 0.5f) * scale_y - 0.5f;
        int y0 = static_cast<int>(std::floor(fy));
        const float wy = fy - y0;
        int y1 = std::clamp(y0 + 1, 0, sh - 1);
        y0 = std::clamp(y0, 0, sh - 1);
        const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
        const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
        float* out_row = dst + static_cast<size_t>(dy) * dw * 3;
        const float omwy = 1.0f - wy;

        for (int dx = 0; dx < dw; ++dx) {
            const float wx = wxv[dx];
            const float omwx = 1.0f - wx;
            const float w00 = omwy * omwx, w01 = omwy * wx;
            const float w10 = wy * omwx, w11 = wy * wx;
            const uint8_t* p00 = row0 + x0v[dx];
            const uint8_t* p01 = row0 + x1v[dx];
            const uint8_t* p10 = row1 + x0v[dx];
            const uint8_t* p11 = row1 + x1v[dx];
            float* o = out_row + dx * 3;
            o[0] = (w00 * p00[0] + w01 * p01[0] + w10 * p10[0] + w11 * p11[0])
                   * ch_scale[0] + ch_bias[0];
            o[1] = (w00 * p00[1] + w01 * p01[1] + w10 * p10[1] + w11 * p11[1])
                   * ch_scale[1] + ch_bias[1];
            o[2] = (w00 * p00[2] + w01 * p01[2] + w10 * p10[2] + w11 * p11[2])
                   * ch_scale[2] + ch_bias[2];
        }
    }
}

}  // extern "C"
