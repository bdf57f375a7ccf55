// Temporal reprojection kernel for NVIDIA Hopper (sm_90a): the whole
// moving-camera temporal stage (temporal.comp) in one pass, one thread
// per pixel.
//
// Replaces voxtracer/ops/temporal_pallas.py `temporal_blend_fused` (its
// `_make_kernel`), the Pallas TPU kernel.  It is a per-thread
// transcription of voxtracer_torch/ops/temporal.py
// `temporal_blend_reproject_plain`, which the CPU tests hold against the
// JAX package's any-offset path (`temporal.temporal_blend`,
// reproject=True, resample_impl="xla"), in the same floating-point
// operation order.  Built without FMA contraction (-fmad=false) and
// without fast math, it rounds as the plain version does.
//
// Per pixel: the current ray and first-hit world point; the point in
// the old camera's screen through the inverse old pixel basis (packed on
// the host); a bilinear 4-tap fetch of the 5 history planes (rgb,
// blend, depth) with clamp-to-edge; the old ray on the pixel lattice;
// the world-distance validity test; the blend and the next blend
// factor.
//
// Design.  The TPU kernel served history out of a VMEM window by
// integer offset (one roll per distinct offset, at most MAX_ROUNDS,
// |dy| <= MARGIN); lanes it could not serve lost their history.  Here
// each thread gathers its four taps directly from global memory at any
// offset, so nothing is lost to a window.  Tap indices are clamped in
// float before the conversion to int, so an off-screen or non-finite
// reprojection (a point beside or behind the old camera) reads an edge
// pixel, never out of bounds; such a pixel is never valid, so what it
// reads is never used.
//
// Parameters.  The by-value entry copies the host's (40,) vector into
// the launch.  The row-reading entry (ROW) takes a device pointer to its
// slice of a frame row: the launcher copies it, device to device and in
// stream order, into `c_row` in constant memory just before the launch,
// so a captured CUDA graph (a copy node, then the kernel) blends by
// whichever row the device holds there at replay.  Both instances run
// the one body below and read their parameters from a constant bank:
// staging the row through shared memory instead takes 42 registers, not
// 32, so 6 blocks a SM instead of 8, and measured 28% slower on an H100
// at 1920x1080 (PERF.md §6).  `c_row` is one per process: the copy and
// the kernel that reads it are ordered on their stream and on no other,
// so row-reading launches (and graphs that hold them) from two streams at
// once would race on it.  The port renders on one stream.
//
// Slabs.  The current planes may be a slab of a row-sharded frame
// (voxtracer_torch/parallel/mesh.py): image rows row0 .. row0 + height - 1
// against the whole history of img_height rows, which the mesh gathers
// onto the slab's device; the rays read the image row and the old screen
// is scaled by the image's height.  The TPU kernel took fixed row halos
// instead (temporal_pallas.py HALO_TOP / HALO_BOT); the any-offset gather
// needs the history at any row, as the JAX package's all-gather branch
// (voxtracer/engine/pipeline.py:294-326) does.
//
// What bounds it: memory.  A pixel reads 7 planes of its own and 20
// gathered history words (4 taps x 5 planes, neighbours of a smooth
// reprojection, so mostly L1/L2 hits) and writes 4 planes: about
// 2 M px x 44 B ~ 90 MB at 1080p, ~30 us at the H100's 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

constexpr int N_PARAMS = 40;

// voxtracer_torch/engine/params.py pack_temporal_params layout
struct Params {
    float p[N_PARAMS];
};
__constant__ Params c_row;  // the row-reading entry's parameters

// max(a, 0) that keeps a NaN, as torch.maximum and jnp.maximum do
__device__ __forceinline__ float max0(float a) {
    return (a != a) ? a : fmaxf(a, 0.f);
}

// torch.clamp(a, lo, hi): NaN stays NaN
__device__ __forceinline__ float clampf(float a, float lo, float hi) {
    return (a != a) ? a : fminf(fmaxf(a, lo), hi);
}

__device__ __forceinline__ void norm_div3(float& x, float& y, float& z) {
    const float n = sqrtf(x * x + y * y + z * z);
    x = x / n;
    y = y / n;
    z = z / n;
}

// a tap coordinate (a whole float) -> index clamped to [0, n-1]; the
// float clamp first keeps the conversion defined for any input
// (fmaxf sends NaN to the lower bound)
__device__ __forceinline__ int tap_index(float v, int n) {
    const int i = (int)fminf(fmaxf(v, -1.f), (float)n);
    return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

template <bool ROW>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) temporal_kernel(
    const Params P, const float* __restrict__ color,
    const float* __restrict__ normal,
    const float* __restrict__ depth, const float* __restrict__ old_color,
    const float* __restrict__ old_blend, const float* __restrict__ old_depth,
    int height, int width, int row0, int img_height,
    float* __restrict__ blended, float* __restrict__ next_blend) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const float* p = ROW ? c_row.p : P.p;
    const size_t plane = (size_t)height * width;
    const size_t hist_plane = (size_t)img_height * width;
    const size_t o = (size_t)y * width + x;
    const float pxf = (float)x, pyf = (float)(row0 + y);

    // the current pixel's ray and first-hit world point
    float rx = pxf * p[3] - pyf * p[6] + p[9];
    float ry = pxf * p[4] - pyf * p[7] + p[10];
    float rz = pxf * p[5] - pyf * p[8] + p[11];
    norm_div3(rx, ry, rz);
    const float d = depth[o];
    const float wx = p[0] + d * rx;
    const float wy = p[1] + d * ry;
    const float wz = p[2] + d * rz;

    // world -> old screen: s = inv @ (world - old origin)
    const float relx = wx - p[12], rely = wy - p[13], relz = wz - p[14];
    const float s0 = p[24] * relx + p[25] * rely + p[26] * relz;
    const float s1 = p[27] * relx + p[28] * rely + p[29] * relz;
    const float s2 = p[30] * relx + p[31] * rely + p[32] * relz;
    const float sx = s0 / s2;
    const float sy = s1 / s2;
    const float tex_x = (sx + 0.5f) / (float)width;
    const float tex_y = (sy - 0.5f) / (float)(-img_height);
    const bool in_range =
        tex_x >= 0.f && tex_x <= 1.f && tex_y >= 0.f && tex_y <= 1.f;

    // bilinear fetch of the 5 history planes at pixel centers
    const float xf = tex_x * (float)width - 0.5f;
    const float yf = tex_y * (float)img_height - 0.5f;
    const float x0 = floorf(xf);
    const float y0 = floorf(yf);
    const float tx = xf - x0;
    const float ty = yf - y0;
    const int xa = tap_index(x0, width), xb = tap_index(x0 + 1.f, width);
    const int ya = tap_index(y0, img_height),
              yb = tap_index(y0 + 1.f, img_height);
    const size_t i00 = (size_t)ya * width + xa, i10 = (size_t)ya * width + xb;
    const size_t i01 = (size_t)yb * width + xa, i11 = (size_t)yb * width + xb;
    float h[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
        const float* src = c < 3 ? old_color + c * hist_plane
                                 : (c == 3 ? old_blend : old_depth);
        const float top = src[i00] * (1.f - tx) + src[i10] * tx;
        const float bot = src[i01] * (1.f - tx) + src[i11] * tx;
        h[c] = top * (1.f - ty) + bot * ty;
    }

    // the old ray quantizes to the pixel lattice (temporal.comp:99-103)
    const float qx = truncf(sx + 0.5f);
    const float qy = truncf(sy - 0.5f);
    float orx = qx * p[15] + qy * p[18] + p[21];
    float ory = qx * p[16] + qy * p[19] + p[22];
    float orz = qx * p[17] + qy * p[20] + p[23];
    norm_div3(orx, ory, orz);
    const float owx = p[12] + h[4] * orx;
    const float owy = p[13] + h[4] * ory;
    const float owz = p[14] + h[4] * orz;

    // world-distance validity scaled by depth and view angle
    float cdx = p[0] - wx, cdy = p[1] - wy, cdz = p[2] - wz;
    norm_div3(cdx, cdy, cdz);
    const float bias =
        max0(cdx * normal[o] + cdy * normal[plane + o] + cdz * normal[2 * plane + o]);
    const float ddx = owx - wx, ddy = owy - wy, ddz = owz - wz;
    const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
    const bool same_position = dist < bias * p[35] * d;

    const bool hit = d >= 0.f;
    const bool valid = in_range && same_position && hit && p[36] > 0.f;
    const float blending = valid ? h[3] : 1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float sc = color[c * plane + o];
        const float use = valid ? h[c] : 0.f;
        blended[c * plane + o] =
            hit ? use * (1.f - blending) + sc * blending : sc;
    }
    next_blend[o] = clampf((1.f - p[33]) * blending, 1.f - p[34], 1.f);
}

}  // namespace

// Parameters by value (`params_host`, a host pointer) or, where
// `params_host` is null, from device memory: `row` points at the
// kernel's slice of a frame row.  The current planes are `height` rows
// of the image from row `row0` on (a slab); the history is the whole
// image, `img_height` rows (one device: row0 0, img_height = height).
extern "C" int vt_temporal_launch(
    const float* params_host, const float* row, const float* color,
    const float* normal, const float* depth, const float* old_color,
    const float* old_blend, const float* old_depth, int height, int width,
    int row0, int img_height, float* blended, float* next_blend,
    void* stream) {
    if (row0 < 0 || row0 + height > img_height)
        return static_cast<int>(cudaErrorInvalidValue);
    Params P = {};
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((width + BLOCK_X - 1) / BLOCK_X,
                    (height + BLOCK_Y - 1) / BLOCK_Y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (params_host) {
        memcpy(P.p, params_host, sizeof(P.p));
        temporal_kernel<false><<<grid, block, 0, s>>>(
            P, color, normal, depth, old_color, old_blend, old_depth, height,
            width, row0, img_height, blended, next_blend);
    } else {
        if (!row) return static_cast<int>(cudaErrorInvalidValue);
        const cudaError_t err = cudaMemcpyToSymbolAsync(
            c_row, row, sizeof(Params), 0, cudaMemcpyDeviceToDevice, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        temporal_kernel<true><<<grid, block, 0, s>>>(
            P, color, normal, depth, old_color, old_blend, old_depth, height,
            width, row0, img_height, blended, next_blend);
    }
    return static_cast<int>(cudaGetLastError());
}
