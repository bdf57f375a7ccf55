// Frame epilogue kernels for NVIDIA Hopper (sm_90a): the tail of a frame
// after its trace (and its temporal or denoise kernel), one pass over the
// image, one thread per pixel.
//
// Replaces no Pallas kernel.  In the JAX package the tail of a frame is
// jitted code that XLA fuses into one pass over the image: the still
// blend (voxtracer/ops/temporal.py:104, called at
// voxtracer/engine/pipeline.py:467-481), the radius-0 albedo modulate
// (voxtracer/ops/denoise_pallas.py:281-283) and the sRGB u8 encode with
// its crop (voxtracer/ops/tonemap.py:37, called at pipeline.py:552-553).
// Eager torch runs the same values as some 60-115 elementwise kernels a
// frame.  Two kernels here:
//
// - still_epilogue_kernel: voxtracer_torch/ops/temporal.py `_blend_still`
//   (ray planes of the new and the old camera, world points, the
//   same-position test, `blended` and `next_blend`, both always
//   written), then, given an albedo plane, ops/denoise.py `_modulate`
//   (out * (keep_albedo + f * albedo)) and ops/tonemap.py `to_u8` into
//   an (H, W, 3) u8 image, and, given a pointer, the modulated linear
//   (3, H, W).  Without an albedo plane it is the blend alone (a still
//   frame that the denoise kernel filters next).
// - encode_kernel: the u8 encode of a linear (3, Hp, Wp) plane that the
//   temporal or the denoise kernel wrote, cropped to (H, W); given an
//   albedo plane the radius-0 modulate first, and then, given a
//   pointer, the modulated linear too.
//
// Both write the image at `image + slot * H * W * 3` where `slot` is a
// device pointer (the sequence path's frame slot, advanced by its graph),
// else at `image`; a slot outside [0, n_images) writes no image.
//
// Parity.  Each is a per-thread transcription of those plain torch ops,
// in their floating-point operation order, built without FMA contraction
// (-fmad=false) and without fast math: IEEE division and square root as
// torch's CUDA kernels do them.  torch.clamp / clamp_min keep a NaN and
// are min(max(x, lo), hi) otherwise (clampf, max0 below).  The encode
// calls what torch's CUDA kernels call: `powf` with the exponent 1 / 2.4
// rounded to float32 (pow_tensor_scalar_kernel's `::pow(base, exp)` on
// float32), float32 products and sums of the constants rounded to
// float32, `rintf` for torch.round (half to even), and the u8 conversion
// through int64 as c10's static_cast_with_inter_type.
//
// What bounds it: memory.  The still epilogue at radius 0 reads 15
// float32 planes (colour, normal, old colour and albedo 3 each, depth,
// old blend, old depth) = 60 B a pixel and writes 4 planes and 3 bytes =
// 19 B (31 with the linear): 79 B a pixel, 0.0217 ms at 1280x720 and
// 0.196 ms at 3840x2160 at 3.35 TB/s.  The encode reads 12 B (24 with
// the albedo) and writes 3 (15 with the linear).  Neither has enough
// arithmetic to matter (~90 float operations a pixel for the blend, one
// powf a channel).  Design: one thread a pixel in 32x8 blocks, so that a
// warp reads 128 contiguous bytes of each plane and writes 96 contiguous
// bytes of the image; nothing is staged, nothing read twice.
//
// Parameters.  Both kernels read the slice row[33:92] of a frame row
// (engine/params.py pack_frame_rows): the temporal vector (cameras,
// cutoff, history_valid), the denoise vector (the albedo factor) and the
// three 1 - x constants.  The by-value entry copies the host's slice into
// the launch.  The row-reading entry (ROW) takes a device pointer to the
// slice: the launcher copies it, device to device and in stream order,
// into `c_row` in constant memory just before the launch, so that a
// captured CUDA graph (a copy node, then the kernel) runs whichever row
// the device holds there at replay, as csrc/temporal.cu and
// csrc/denoise.cu do.  `c_row` is one per process and shared by both
// kernels: each copy precedes its own kernel on the stream, and the port
// renders on one stream.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// row[33:92]: the temporal vector (0-39), the denoise vector (40-55),
// 1 - sample_blending, 1 - maximum_blending, 1 - albedo_factor
constexpr int N_PARAMS = 59;
constexpr int P_OLD_CAM = 12;
constexpr int P_CUTOFF = 35;
constexpr int P_HISTORY_VALID = 36;
constexpr int P_ALBEDO_FACTOR = 40 + 14;
constexpr int P_KEEP_SAMPLE = 56;
constexpr int P_KEEP_FLOOR = 57;
constexpr int P_KEEP_ALBEDO = 58;

struct Params {
    float p[N_PARAMS];
};
__constant__ Params c_row;  // the row-reading entries' parameters

// torch.clamp_min(a, 0): NaN stays NaN
__device__ __forceinline__ float max0(float a) {
    return (a != a) ? a : fmaxf(a, 0.f);
}

// torch.clamp(a, lo, hi) with bounds that are no NaN: NaN stays NaN
__device__ __forceinline__ float clampf(float a, float lo, float hi) {
    return (a != a) ? a : fminf(fmaxf(a, lo), hi);
}

// the unit ray of pixel (px, py) through camera rows c: origin, right,
// up, forward (pixel-scaled)
__device__ __forceinline__ void unit_ray(const float* c, float px, float py,
                                         float& x, float& y, float& z) {
    x = px * c[3] - py * c[6] + c[9];
    y = px * c[4] - py * c[7] + c[10];
    z = px * c[5] - py * c[8] + c[11];
    const float n = sqrtf(x * x + y * y + z * z);
    x = x / n;
    y = y / n;
    z = z / n;
}

__device__ __forceinline__ float modulate(float v, float a, const float* p) {
    return v * (p[P_KEEP_ALBEDO] + p[P_ALBEDO_FACTOR] * a);
}

// ops/tonemap.py to_u8: clamp, sRGB curve, round half to even, u8
__device__ __forceinline__ uint8_t srgb_u8(float v) {
    const float c = clampf(v, 0.f, 1.f);
    const float s = c <= 0.0031308f
                        ? 12.92f * c
                        : 1.055f * powf(c, (float)(1.0 / 2.4)) - 0.055f;
    return static_cast<uint8_t>(static_cast<int64_t>(rintf(s * 255.f)));
}

// where this frame's image starts, or null: no image to write
__device__ __forceinline__ uint8_t* image_base(uint8_t* image,
                                               const int64_t* slot,
                                               int n_images,
                                               size_t frame_bytes) {
    if (!image || !slot) return image;
    const int64_t s = *slot;
    return (s >= 0 && s < n_images) ? image + s * frame_bytes : nullptr;
}

template <bool ROW>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) still_epilogue_kernel(
    const Params P, const float* __restrict__ color,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ old_color, const float* __restrict__ old_blend,
    const float* __restrict__ old_depth, const float* __restrict__ albedo,
    int height, int width, float* __restrict__ blended,
    float* __restrict__ next_blend, float* __restrict__ linear,
    uint8_t* __restrict__ image, const int64_t* __restrict__ slot,
    int n_images) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const float* p = ROW ? c_row.p : P.p;
    const float* old = p + P_OLD_CAM;
    const size_t plane = (size_t)height * width;
    const size_t o = (size_t)y * width + x;
    const float pxf = (float)x, pyf = (float)y;

    // the first-hit world points of the new and the old camera
    float rx, ry, rz;
    unit_ray(p, pxf, pyf, rx, ry, rz);
    const float d = depth[o];
    const float wx = p[0] + d * rx;
    const float wy = p[1] + d * ry;
    const float wz = p[2] + d * rz;
    float orx, ory, orz;
    unit_ray(old, pxf, pyf, orx, ory, orz);
    const float od = old_depth[o];
    const float owx = old[0] + od * orx;
    const float owy = old[1] + od * ory;
    const float owz = old[2] + od * orz;

    // world-distance validity scaled by depth and view angle
    const float cdx = p[0] - wx, cdy = p[1] - wy, cdz = p[2] - wz;
    const float cn = sqrtf(cdx * cdx + cdy * cdy + cdz * cdz);
    const float bias = max0((cdx / cn) * normal[o]
                            + (cdy / cn) * normal[plane + o]
                            + (cdz / cn) * normal[2 * plane + o]);
    const float dx = owx - wx, dy = owy - wy, dz = owz - wz;
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const bool same_position = dist < bias * p[P_CUTOFF] * d;

    const bool hit = d >= 0.f;
    const bool valid = same_position && hit && p[P_HISTORY_VALID] > 0.f;
    const float blending = valid ? old_blend[o] : 1.f;
    next_blend[o] = clampf(p[P_KEEP_SAMPLE] * blending, p[P_KEEP_FLOOR], 1.f);
    uint8_t* px = image_base(image, slot, n_images, plane * 3);
    if (px) px += o * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const size_t i = c * plane + o;
        const float sc = color[i];
        const float use = valid ? old_color[i] : 0.f;
        const float b = hit ? use * (1.f - blending) + sc * blending : sc;
        blended[i] = b;
        if (albedo) {
            const float m = modulate(b, albedo[i], p);
            if (linear) linear[i] = m;
            if (px) px[c] = srgb_u8(m);
        }
    }
}

template <bool ROW>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) encode_kernel(
    const Params P, const float* __restrict__ src,
    const float* __restrict__ albedo, int in_h, int in_w, int height,
    int width, float* __restrict__ linear, uint8_t* __restrict__ image,
    const int64_t* __restrict__ slot, int n_images) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (x >= in_w || y >= in_h) return;
    const float* p = ROW ? c_row.p : P.p;
    const size_t plane = (size_t)in_h * in_w;
    const size_t o = (size_t)y * in_w + x;
    uint8_t* px = nullptr;
    if (x < width && y < height) {  // the crop
        px = image_base(image, slot, n_images, (size_t)height * width * 3);
        if (px) px += ((size_t)y * width + x) * 3;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const size_t i = c * plane + o;
        float v = src[i];
        if (albedo) {
            v = modulate(v, albedo[i], p);
            if (linear) linear[i] = v;
        }
        if (px) px[c] = srgb_u8(v);
    }
}

// The parameters by value (`params_host`, a host pointer to the 59
// floats) or, where it is null, copied from the device slice `row` into
// `c_row`; returns whether the row-reading instance runs, or an error.
cudaError_t stage_params(const float* params_host, const float* row,
                         bool needed, cudaStream_t s, Params& P, bool& by_row) {
    by_row = false;
    if (params_host) {
        memcpy(P.p, params_host, sizeof(P.p));
        return cudaSuccess;
    }
    if (!row) return needed ? cudaErrorInvalidValue : cudaSuccess;
    by_row = true;
    return cudaMemcpyToSymbolAsync(c_row, row, sizeof(Params), 0,
                                   cudaMemcpyDeviceToDevice, s);
}

dim3 grid_of(int height, int width) {
    return dim3((width + BLOCK_X - 1) / BLOCK_X,
                (height + BLOCK_Y - 1) / BLOCK_Y);
}

}  // namespace

// The still blend of a (height, width) frame into `blended` (3, H, W) and
// `next_blend` (H, W); with `albedo` also the radius-0 modulate, the u8
// image (at `image`, or at frame *slot of `n_images` where `slot` is not
// null) and, where `linear` is not null, the modulated linear.
extern "C" int vt_still_epilogue_launch(
    const float* params_host, const float* row, const float* color,
    const float* normal, const float* depth, const float* old_color,
    const float* old_blend, const float* old_depth, const float* albedo,
    int height, int width, float* blended, float* next_blend, float* linear,
    uint8_t* image, const int64_t* slot, int n_images, void* stream) {
    if (height <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
    if (albedo && !image) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Params P = {};
    bool by_row;
    const cudaError_t err = stage_params(params_host, row, true, s, P, by_row);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid = grid_of(height, width);
    if (by_row) {
        still_epilogue_kernel<true><<<grid, block, 0, s>>>(
            P, color, normal, depth, old_color, old_blend, old_depth, albedo,
            height, width, blended, next_blend, linear, image, slot, n_images);
    } else {
        still_epilogue_kernel<false><<<grid, block, 0, s>>>(
            P, color, normal, depth, old_color, old_blend, old_depth, albedo,
            height, width, blended, next_blend, linear, image, slot, n_images);
    }
    return static_cast<int>(cudaGetLastError());
}

// The u8 encode of `src` (3, in_h, in_w) cropped to (height, width); with
// `albedo` (3, in_h, in_w) the radius-0 modulate first (parameters by
// value or by row), and where `linear` is not null the modulated linear.
extern "C" int vt_encode_launch(
    const float* params_host, const float* row, const float* src,
    const float* albedo, int in_h, int in_w, int height, int width,
    float* linear, uint8_t* image, const int64_t* slot, int n_images,
    void* stream) {
    if (in_h <= 0 || in_w <= 0) return static_cast<int>(cudaSuccess);
    if (height > in_h || width > in_w || !image)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Params P = {};
    bool by_row;
    const cudaError_t err =
        stage_params(params_host, row, albedo != nullptr, s, P, by_row);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid = grid_of(in_h, in_w);
    if (by_row) {
        encode_kernel<true><<<grid, block, 0, s>>>(
            P, src, albedo, in_h, in_w, height, width, linear, image, slot,
            n_images);
    } else {
        encode_kernel<false><<<grid, block, 0, s>>>(
            P, src, albedo, in_h, in_w, height, width, linear, image, slot,
            n_images);
    }
    return static_cast<int>(cudaGetLastError());
}
