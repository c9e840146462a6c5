// Host image preprocessing for the training data loader (the port's copy of
// the JAX package's csrc/image_ops.cpp, the same code).
//
// The reference's data path is torchvision/PIL transforms on the Python
// side (reference train.py:55-93): per-sample shortest-edge resize + crop +
// normalize. At accelerator training throughput the host becomes the
// bottleneck, so the hot loop lives here: a fused antialiased
// (triangle-filter) resample + crop + normalize from the decoded uint8
// buffer straight into the float32 batch slot, threaded across batch items.
// The resampler reproduces PIL's bilinear convolution (support scaled by the
// downscale factor), so outputs are close to PIL's.
//
// Built with g++ at first use and bound with ctypes by
// imagharmony_tpu_torch/native.py.

#include <algorithm>
#include <atomic>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Weights {
    // per output index: [bound_lo, bound_hi) into the source axis and
    // normalized coefficients
    std::vector<int> lo, hi;
    std::vector<std::vector<float>> coef;
};

inline float triangle(float x) {
    x = std::fabs(x);
    return x < 1.0f ? 1.0f - x : 0.0f;
}

// PIL-style resample weights for out indices [offset, offset+count) of a
// virtual resized axis of length out_full, from a source axis of in_size.
Weights make_weights(int in_size, int out_full, int offset, int count) {
    Weights w;
    w.lo.resize(count);
    w.hi.resize(count);
    w.coef.resize(count);
    double scale = static_cast<double>(in_size) / out_full;
    double filterscale = std::max(scale, 1.0);
    double support = 1.0 * filterscale;  // bilinear filter support == 1
    for (int i = 0; i < count; ++i) {
        double center = (offset + i + 0.5) * scale;
        int lo = static_cast<int>(std::max(0.0, std::floor(center - support)));
        int hi = static_cast<int>(std::min<double>(in_size, std::ceil(center + support)));
        // offset+count is expected to stay within out_full; if a caller
        // overruns anyway, degrade to edge replication instead of a
        // negative-size resize (lo can land past in_size when center is
        // beyond the source axis)
        lo = std::min(lo, in_size - 1);
        if (hi <= lo) hi = lo + 1;
        w.lo[i] = lo;
        w.hi[i] = hi;
        auto& c = w.coef[i];
        c.resize(hi - lo);
        double total = 0.0;
        for (int k = lo; k < hi; ++k) {
            double v = triangle(static_cast<float>((k - center + 0.5) / filterscale));
            c[k - lo] = static_cast<float>(v);
            total += v;
        }
        if (total > 0) {
            for (auto& v : c) v = static_cast<float>(v / total);
        }
    }
    return w;
}

inline int round_half_even(double v) {
    return static_cast<int>(std::nearbyint(v));  // default FE_TONEAREST
}

void resize_crop_normalize_one(const uint8_t* src, int sh, int sw,
                               int out_size, int top, int left,
                               const float* mean, const float* inv_std,
                               float* dst) {
    const int c = 3;
    // shortest-edge resized dims, matching Python round() (half-even)
    int shortside = std::min(sh, sw);
    int nh = round_half_even(static_cast<double>(sh) * out_size / shortside);
    int nw = round_half_even(static_cast<double>(sw) * out_size / shortside);

    Weights wx = make_weights(sw, nw, left, out_size);
    Weights wy = make_weights(sh, nh, top, out_size);

    // source row range needed
    int ymin = sh, ymax = 0;
    for (int i = 0; i < out_size; ++i) {
        ymin = std::min(ymin, wy.lo[i]);
        ymax = std::max(ymax, wy.hi[i]);
    }

    // horizontal pass over needed source rows
    std::vector<float> tmp(static_cast<size_t>(ymax - ymin) * out_size * c);
    for (int y = ymin; y < ymax; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * sw * c;
        float* trow = tmp.data() + static_cast<size_t>(y - ymin) * out_size * c;
        for (int j = 0; j < out_size; ++j) {
            float acc[3] = {0, 0, 0};
            const auto& coefs = wx.coef[j];
            int lo = wx.lo[j];
            for (size_t k = 0; k < coefs.size(); ++k) {
                const uint8_t* p = row + (lo + k) * c;
                float cv = coefs[k];
                acc[0] += cv * p[0];
                acc[1] += cv * p[1];
                acc[2] += cv * p[2];
            }
            float* o = trow + static_cast<size_t>(j) * c;
            o[0] = acc[0];
            o[1] = acc[1];
            o[2] = acc[2];
        }
    }

    // vertical pass + normalize
    const float inv255 = 1.0f / 255.0f;
    for (int i = 0; i < out_size; ++i) {
        const auto& coefs = wy.coef[i];
        int lo = wy.lo[i];
        float* orow = dst + static_cast<size_t>(i) * out_size * c;
        for (int j = 0; j < out_size; ++j) {
            float acc[3] = {0, 0, 0};
            for (size_t k = 0; k < coefs.size(); ++k) {
                const float* p = tmp.data() +
                                 (static_cast<size_t>(lo + k - ymin) * out_size + j) * c;
                float cv = coefs[k];
                acc[0] += cv * p[0];
                acc[1] += cv * p[1];
                acc[2] += cv * p[2];
            }
            float* o = orow + static_cast<size_t>(j) * c;
            for (int k = 0; k < c; ++k) {
                // PIL clips + rounds to uint8 between passes; we keep full
                // precision (strictly more accurate, within 1/255 of PIL)
                float v = std::min(255.0f, std::max(0.0f, acc[k]));
                o[k] = (v * inv255 - mean[k]) * inv_std[k];
            }
        }
    }
}

}  // namespace

extern "C" {

void batch_resize_crop_normalize(const uint8_t** srcs, const int* shs,
                                 const int* sws, int n, int out_size,
                                 const int* tops, const int* lefts,
                                 const float* mean, const float* std,
                                 float* dst, int num_threads) {
    float inv_std[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};
    std::atomic<int> next(0);
    auto worker = [&]() {
        while (true) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            resize_crop_normalize_one(
                srcs[i], shs[i], sws[i], out_size, tops[i], lefts[i], mean,
                inv_std, dst + static_cast<size_t>(i) * out_size * out_size * 3);
        }
    };
    int t = std::max(1, std::min(num_threads, n));
    std::vector<std::thread> threads;
    for (int i = 0; i < t; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

void resize_crop_normalize(const uint8_t* src, int sh, int sw, int out_size,
                           int top, int left, const float* mean,
                           const float* std, float* dst) {
    float inv_std[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};
    resize_crop_normalize_one(src, sh, sw, out_size, top, left, mean, inv_std,
                              dst);
}

int image_ops_abi_version() { return 1; }

}  // extern "C"
