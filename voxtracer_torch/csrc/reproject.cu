// History resample kernel for NVIDIA Hopper (sm_90a): a bilinear fetch
// of C history planes at per-pixel source coordinates, clamp-to-edge, at
// pixel centres, one thread per output pixel.
//
// Replaces voxtracer/ops/reproject_pallas.py `resample` (its
// `_make_kernel`), the Pallas TPU kernel.  It is a per-thread
// transcription of voxtracer_torch/ops/reproject.py `resample_plain`,
// which the CPU tests hold against the JAX package's `_bilinear` and the
// interpreted Pallas kernel, in the same floating-point operation order.
// Built without FMA contraction (-fmad=false), it rounds as the plain
// version does.
//
// Design.  The TPU kernel could not gather: it served taps by distinct
// integer offset out of a VMEM window (one min-reduce and one roll per
// offset, padded history, at most MAX_ROUNDS rounds, |offset| <= MARGIN)
// and reported lanes it could not serve as not ok.  Here each thread
// reads its four taps directly from global memory for each plane, at any
// offset, so `ok` is written true everywhere.  Tap indices are clamped
// in float to [-1, n] before the conversion to int (NaN goes to -1), then
// to [0, n - 1], so every load is in bounds whatever the coordinate; a
// NaN or infinite coordinate gives NaN weights, so its sample is NaN, as
// in the plain version.
//
// What bounds it: memory.  A pixel reads its two coordinates and 4 x C
// history words (neighbours of a smooth reprojection, so mostly L1/L2
// hits) and writes C words and one byte: about 2 M px x (8 + 4C + 1) B
// ~ 60 MB at 1080p with C = 5, ~20 us at the H100's 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// a tap coordinate (a whole float) -> index clamped to [0, n-1]; the
// float clamp first keeps the conversion defined for any input
// (fmaxf sends NaN to the lower bound)
__device__ __forceinline__ int tap_index(float v, int n) {
    const int i = (int)fminf(fmaxf(v, -1.f), (float)n);
    return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) resample_kernel(
    const float* __restrict__ hist, const float* __restrict__ px_f,
    const float* __restrict__ py_f, int channels, int height, int width,
    float* __restrict__ sampled, bool* __restrict__ ok) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t plane = (size_t)height * width;
    const size_t o = (size_t)y * width + x;

    const float xf = px_f[o] - 0.5f;
    const float yf = py_f[o] - 0.5f;
    const float x0 = floorf(xf);
    const float y0 = floorf(yf);
    const float tx = xf - x0;
    const float ty = yf - y0;
    const int xa = tap_index(x0, width), xb = tap_index(x0 + 1.f, width);
    const int ya = tap_index(y0, height), yb = tap_index(y0 + 1.f, height);
    const size_t i00 = (size_t)ya * width + xa, i10 = (size_t)ya * width + xb;
    const size_t i01 = (size_t)yb * width + xa, i11 = (size_t)yb * width + xb;
    for (int c = 0; c < channels; ++c) {
        const float* src = hist + c * plane;
        const float top = src[i00] * (1.f - tx) + src[i10] * tx;
        const float bot = src[i01] * (1.f - tx) + src[i11] * tx;
        sampled[c * plane + o] = top * (1.f - ty) + bot * ty;
    }
    ok[o] = true;
}

}  // namespace

extern "C" int vt_resample_launch(const float* hist, const float* px_f,
                                  const float* py_f, int channels,
                                  int height, int width, float* sampled,
                                  bool* ok, void* stream) {
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((width + BLOCK_X - 1) / BLOCK_X,
                    (height + BLOCK_Y - 1) / BLOCK_Y);
    resample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        hist, px_f, py_f, channels, height, width, sampled, ok);
    return static_cast<int>(cudaGetLastError());
}
