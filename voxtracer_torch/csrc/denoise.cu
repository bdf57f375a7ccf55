// Cross-bilateral denoise kernel for NVIDIA Hopper (sm_90a): the
// (2r+1)^2 stencil of denoise.comp plus the albedo modulation, one
// thread per pixel, with the radius as a runtime argument.
//
// Replaces voxtracer/ops/denoise_pallas.py `_make_kernel` (reached
// through `denoise_from_stack` / `denoise`), the Pallas TPU kernel.  It
// is a per-thread transcription of voxtracer_torch/ops/denoise.py
// `denoise_plain`, which the CPU tests hold against the JAX package's
// `denoise.denoise` and the Pallas kernel in interpret mode: taps in the
// same order (dy outer, dx inner), each weight in the same
// floating-point operation order.  Built without FMA contraction
// (-fmad=false) and without fast math; only expf/logf may round
// differently from torch's.
//
// Design.  The TPU kernel DMA'd a haloed window of a materialised
// 12-plane stack (colour, normal, log|depth|, material id, albedo,
// valid) into VMEM and unrolled the taps (rolled rows for r > 2, a
// Mosaic compile-time limit).  Here no stack is built: each thread reads
// its taps' colour, normal, depth and node straight from the G-buffer
// planes and computes log|depth| and node >> 24 per tap.  A tap outside
// the frame is skipped, which adds exactly what the stack's valid=0
// zero padding added: nothing.  The radius is a loop bound, so one
// build serves every r.
//
// What bounds it: per tap about 30 flops, an expf and a logf, and 8
// loads that neighbouring threads share through L1.  At r=2 (25 taps)
// that is ~25 x 40 instructions per pixel, 2 M px at 1080p; the loads
// hit L1/L2, so issue rate and the special-function units bound it, and
// the cost grows as (2r+1)^2.  Shared-memory tiles of the planes and a
// log|depth| pre-pass are for a later, measured change.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// voxtracer_torch/engine/params.py pack_denoise_params layout
struct Params {
    float p[16];
};

__device__ __forceinline__ float max0(float a) {
    return (a != a) ? a : fmaxf(a, 0.f);
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) denoise_kernel(
    const Params P, const float* __restrict__ colors,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ albedo, const int* __restrict__ node,
    int height, int width, int radius, float* __restrict__ out) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const float* p = P.p;
    const size_t plane = (size_t)height * width;
    const size_t o = (size_t)y * width + x;
    const float pxf = (float)x, pyf = (float)y;

    // the pixel's ray, for the depth-bias term (denoise.comp:28-32,47)
    float rx = pxf * p[3] - pyf * p[6] + p[9];
    float ry = pxf * p[4] - pyf * p[7] + p[10];
    float rz = pxf * p[5] - pyf * p[8] + p[11];
    const float rn = sqrtf(rx * rx + ry * ry + rz * rz);
    rx = rx / rn;
    ry = ry / rn;
    rz = rz / rn;

    const float c_r = colors[o], c_g = colors[plane + o],
                c_b = colors[2 * plane + o];
    const float c_nx = normal[o], c_ny = normal[plane + o],
                c_nz = normal[2 * plane + o];
    const float c_logd = logf(fabsf(depth[o]));
    const int c_mat = node[o] >> 24;
    const float depth_bias = max0(c_nx * -rx + c_ny * -ry + c_nz * -rz);
    const float sigma_d2 = 2.0f * (p[12] * p[12]);
    const float sigma_r2 = 2.0f * (p[13] * p[13]);

    float norm_sum = 0.f, sum_r = 0.f, sum_g = 0.f, sum_b = 0.f;
    for (int dy = -radius; dy <= radius; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= height) continue;
        for (int dx = -radius; dx <= radius; ++dx) {
            const int xx = x + dx;
            if (xx < 0 || xx >= width) continue;
            const size_t q = (size_t)yy * width + xx;
            const float w_r = colors[q], w_g = colors[plane + q],
                        w_b = colors[2 * plane + q];
            const float cdr = c_r - w_r, cdg = c_g - w_g, cdb = c_b - w_b;
            const float ndx = c_nx - normal[q];
            const float ndy = c_ny - normal[plane + q];
            const float ndz = c_nz - normal[2 * plane + q];
            const float dd = c_logd - logf(fabsf(depth[q]));
            const float md = c_mat != (node[q] >> 24) ? 1.f : 0.f;
            const float bd = depth_bias * dd;
            const float factor_range =
                (cdr * cdr + cdg * cdg + cdb * cdb +
                 1e4f * (ndx * ndx + ndy * ndy + ndz * ndz) + 1e4f * (bd * bd) +
                 1e4f * md) /
                sigma_r2;
            const float factor_dist = (float)(dx * dx + dy * dy) / sigma_d2;
            const float f = expf(-factor_range - factor_dist);
            norm_sum = norm_sum + f;
            sum_r = sum_r + f * w_r;
            sum_g = sum_g + f * w_g;
            sum_b = sum_b + f * w_b;
        }
    }

    // albedo modulation: out * (1 - f + f * albedo)
    const float af = p[14];
    const float base = 1.0f - af;
    out[o] = (sum_r / norm_sum) * (base + af * albedo[o]);
    out[plane + o] = (sum_g / norm_sum) * (base + af * albedo[plane + o]);
    out[2 * plane + o] =
        (sum_b / norm_sum) * (base + af * albedo[2 * plane + o]);
}

}  // namespace

extern "C" int vt_denoise_launch(const float* params_host, const float* colors,
                                 const float* normal, const float* depth,
                                 const float* albedo, const int* node,
                                 int height, int width, int radius, float* out,
                                 void* stream) {
    Params P;
    memcpy(P.p, params_host, sizeof(P.p));
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((width + BLOCK_X - 1) / BLOCK_X,
                    (height + BLOCK_Y - 1) / BLOCK_Y);
    denoise_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        P, colors, normal, depth, albedo, node, height, width, radius, out);
    return static_cast<int>(cudaGetLastError());
}
