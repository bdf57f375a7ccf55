// Cross-bilateral denoise kernel for NVIDIA Hopper (sm_90a): the
// (2r+1)^2 stencil of denoise.comp plus the albedo modulation.
//
// Replaces voxtracer/ops/denoise_pallas.py `_make_kernel` (reached
// through `denoise_from_stack` / `denoise`), the Pallas TPU kernel.  It
// computes voxtracer_torch/ops/denoise.py `denoise_plain`, which the CPU
// tests hold against the JAX package's `denoise.denoise` and the Pallas
// kernel in interpret mode: each output sums its taps in the same order
// (dy outer, dx inner, ascending), each weight in the same floating-point
// operation order.  Built without FMA contraction (-fmad=false) and
// without fast math; only expf/logf may round differently from torch's.
//
// What bounds it.  Not bytes: 56 a pixel.  Per tap the function needs
// colour, normal, depth-bias and material differences (~26 float
// operations), an IEEE division by sigma_r^2 (2 * 1.5^2 = 4.5 by
// default, not a power of two, so no reciprocal multiply), one expf and
// four sums: about 60 instructions once -fmad=false forbids contracting
// them.  From r = 2 on (25 taps a pixel) the issue rate bounds the
// kernel, and the cost grows as (2r+1)^2; against a bound that counts
// the tap's 39 float operations at the FMA rate its share cannot pass
// ~0.3 (PERF.md).
//
// Design, so that each tap costs only those instructions:
// - A block of 32x8 threads owns a 32x32 tile of output pixels.  It
//   first copies the tile and an r-wide halo from the G-buffer into
//   shared memory, 8 planes (colour, normal, depth, node) of (32+2r)^2
//   elements, with coalesced cp.async copies all in flight at once (zero
//   fill outside the frame); meanwhile it computes its outputs' rays and
//   prefetches their albedo.  Then log|depth| and node >> 24 are
//   computed in place, once per element, not once per tap.
// - Each thread computes 4 outputs down one column.  It walks the 4+2r
//   source rows of their windows once, reads each element's 8 words once
//   per (row, dx) and adds it to every one of its outputs whose dy lies
//   in [-r, r].  Source rows ascend and dx ascends within a row, so each
//   output still sums dy outer, dx inner.
// - factor_dist = (dx^2 + dy^2) / sigma_d^2 comes from a host table of
//   (2r+1)^2 floats (ops/denoise.py `factor_dist_table`) in the by-value
//   params.
// - The radius is a template parameter for r = 1..8, the Pallas kernel's
//   static range and the GUI's, so the row loop unrolls and the dy tests
//   and table rows resolve at compile time; larger radii run the
//   instance with the radius at run time (R = 0).
// - A block whose haloed tile lies inside the frame runs with no bounds
//   test.  A border block marks the elements outside the frame and skips
//   their taps, which adds exactly what the stack's valid=0 zero padding
//   added: nothing.
// - A tap between equal elements has a zero dividend, which the IEEE
//   division sends down its slow path; the kernel divides a stand-in
//   there, so sky-filled frames run as fast as any other.
// - Above r = 26 the haloed tile no longer fits a block's 232,448 bytes
//   of shared memory.  Those radii run `denoise_global_kernel`: one
//   thread per pixel, every tap read from global memory (L1/L2 serve the
//   overlap of neighbouring windows), log|depth| per tap, factor_dist
//   computed per tap as float32(dx^2 + dy^2) / float32(sigma_d^2), the
//   table's values, in the same tap order.  No shipped configuration uses
//   such a radius; the instance exists so that none is refused.
// The launch geometry comes from the wrapper (ops/denoise.py
// `tile_plan`); the launcher checks it against the constants below.
//
// Slabs.  A row-sharded frame (voxtracer_torch/parallel/mesh.py) runs
// the stencil over a window: its slab and up to r rows of each neighbour
// around it, image rows row0 .., then keeps the slab's rows, which tap
// nothing beyond the window (the TPU kernel's top_halo / bot_halo,
// denoise_pallas.py:297-370).  A window edge inside the image pads with
// zeros like the image's edge, but no kept row reads it; so the kernel
// only needs the window's first image row for its pixel rays (the
// depth-bias term), by value.  One device: row0 0.
//
// Parameters.  The sigmas, the albedo factor and the factor_dist table
// are constant over a camera path and always come by value.  The camera
// rows come by value too, or, in the row-reading entries (ROW), from a
// device pointer to the kernel's slice of a frame row: the launcher
// copies them, device to device and in stream order, into `c_camera` in
// constant memory just before the launch, so a captured CUDA graph (a
// copy node, then the kernel) denoises by whichever row the device holds
// there at replay.  ROW is a template flag of the one body; both
// instances read the camera from a constant bank: staging it through
// shared memory instead, behind the tile's copies, keeps the rays from
// overlapping them, and measured 31% slower on an H100 at 1920x1080,
// r = 2 (PERF.md §6).  `c_camera` is one per process: the copy and the
// kernel that reads it are ordered on their stream and on no other, so
// row-reading launches (and graphs that hold them) from two streams at
// once would race on it.  The port renders on one stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int ROWS = 4;  // outputs a thread computes, down its column
constexpr int TILE_X = BLOCK_X;
constexpr int TILE_Y = BLOCK_Y * ROWS;
constexpr int PLANES = 8;  // r, g, b, nx, ny, nz, log|depth|, node >> 24
constexpr int STATIC_RADII = 8;  // instances 1..8; 0 takes the radius at run time
// the largest radius whose haloed tile fits 232,448 bytes of shared memory
constexpr int MAX_RADIUS = 26;
constexpr int OUTSIDE = INT_MIN;  // node >> 24 of an element outside the frame
constexpr int GLOBAL = -1;  // the instance for radii beyond MAX_RADIUS
constexpr int N_CAMERA = 12;  // the camera rows, slots 0-11 of the vector

constexpr int table_radius(int R) { return R > 0 ? R : MAX_RADIUS; }

constexpr int tile_bytes(int r) {
    return PLANES * 4 * (TILE_X + 2 * r) * (TILE_Y + 2 * r);
}

// voxtracer_torch/engine/params.py pack_denoise_params layout, then the
// factor_dist table, dy outer, dx inner
template <int R>
struct Params {
    float p[16];
    float fdist[(2 * table_radius(R) + 1) * (2 * table_radius(R) + 1)];
};

__device__ __forceinline__ float max0(float a) {
    return (a != a) ? a : fmaxf(a, 0.f);
}

// 4 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void copy4(float* dst, const void* src,
                                      bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void prefetch_l1(const float* a) {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(a));
}

// the row-reading entries' camera rows
__constant__ float c_camera[N_CAMERA];

// one output pixel: its own element, depth bias and running sums
struct Out {
    float r, g, b, nx, ny, nz, logd, bias;
    int mat;
    float norm, sum_r, sum_g, sum_b;
};

template <int R, bool BORDER>
__device__ __forceinline__ void taps(const Params<R>& P, const float* tile,
                                     int n, int tw, int r, int first,
                                     float sigma_r2, float zero_range,
                                     Out (&o)[ROWS]) {
    #pragma unroll (R > 0 ? ROWS + 2 * R : 1)
    for (int s = 0; s < ROWS + 2 * r; ++s) {
        const int row = first + s * tw;
        #pragma unroll (R == 1 ? 3 : 1)
        for (int dxi = 0; dxi <= 2 * r; ++dxi) {
            const int e = row + dxi;
            const int mat = __float_as_int(tile[7 * n + e]);
            if (BORDER && mat == OUTSIDE) continue;
            const float w_r = tile[e], w_g = tile[n + e], w_b = tile[2 * n + e];
            const float w_nx = tile[3 * n + e], w_ny = tile[4 * n + e],
                        w_nz = tile[5 * n + e];
            const float w_logd = tile[6 * n + e];
            #pragma unroll
            for (int j = 0; j < ROWS; ++j) {
                const int dyi = s - j;  // dy + r of this tap for output j
                if (dyi < 0 || dyi > 2 * r) continue;
                Out& q = o[j];
                const float cdr = q.r - w_r, cdg = q.g - w_g, cdb = q.b - w_b;
                const float ndx = q.nx - w_nx;
                const float ndy = q.ny - w_ny;
                const float ndz = q.nz - w_nz;
                const float dd = q.logd - w_logd;
                const float md = q.mat != mat ? 1.f : 0.f;
                const float bd = q.bias * dd;
                const float num = cdr * cdr + cdg * cdg + cdb * cdb +
                                  1e4f * (ndx * ndx + ndy * ndy + ndz * ndz) +
                                  1e4f * (bd * bd) + 1e4f * md;
                // A zero dividend (equal colour, normal, depth and node,
                // as between sky pixels) sends the IEEE division down its
                // slow path, ~1.7x the tap's cost: divide a stand-in and
                // take 0 / sigma_r2 instead.  The empty asm keeps the
                // compiler from folding the stand-in away.
                float den = num != 0.f ? num : 1.f;
                asm("" : "+f"(den));
                const float quot = den / sigma_r2;
                const float factor_range = num != 0.f ? quot : zero_range;
                const float factor_dist = P.fdist[dyi * (2 * r + 1) + dxi];
                const float f = expf(-factor_range - factor_dist);
                q.norm = q.norm + f;
                q.sum_r = q.sum_r + f * w_r;
                q.sum_g = q.sum_g + f * w_g;
                q.sum_b = q.sum_b + f * w_b;
            }
        }
    }
}

// At r = 1 an element feeds 2 taps on average, too little work between
// shared loads for 24 resident warps to hide their latency: that
// instance unrolls its dx loop and keeps 64 registers for 32 warps a SM
// (13% faster at 1080p than with the rolled loop; PERF.md, PR 5).
template <int R, bool ROW>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, R == 1 ? 4 : 1)
denoise_kernel(
    const Params<R> P, const float* __restrict__ colors,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ albedo, const int* __restrict__ node,
    int height, int width, int row0, int radius, float* __restrict__ out) {
    extern __shared__ float tile[];
    const int r = R > 0 ? R : radius;
    const int tw = TILE_X + 2 * r, th = TILE_Y + 2 * r;
    const int n = tw * th;
    const int x0 = blockIdx.x * TILE_X - r, y0 = blockIdx.y * TILE_Y - r;
    const size_t plane = (size_t)height * width;

    // the haloed tile: every copy in flight at once (cp.async, zero-fill
    // outside the frame), then log|depth| and node >> 24 in place
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    for (int i = tid; i < n; i += BLOCK_X * BLOCK_Y) {
        const int gy = y0 + i / tw, gx = x0 + i % tw;
        const bool in = gx >= 0 && gx < width && gy >= 0 && gy < height;
        const size_t q = in ? (size_t)gy * width + gx : 0;
        copy4(tile + i, colors + q, in);
        copy4(tile + n + i, colors + plane + q, in);
        copy4(tile + 2 * n + i, colors + 2 * plane + q, in);
        copy4(tile + 3 * n + i, normal + q, in);
        copy4(tile + 4 * n + i, normal + plane + q, in);
        copy4(tile + 5 * n + i, normal + 2 * plane + q, in);
        copy4(tile + 6 * n + i, depth + q, in);
        copy4(tile + 7 * n + i, node + q, in);
    }
    // while the copies are in flight: each output's ray (for the
    // depth-bias term, denoise.comp:28-32,47), and its albedo into L1
    const float* p = P.p;
    const float* c = ROW ? c_camera : P.p;
    const int x = blockIdx.x * TILE_X + threadIdx.x;
    const int ty = threadIdx.y * ROWS;  // the first output's row in the tile
    const float pxf = (float)x;
    float ray[ROWS][3];
    #pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const int y = blockIdx.y * TILE_Y + ty + j;
        const float pyf = (float)(row0 + y);
        float rx = pxf * c[3] - pyf * c[6] + c[9];
        float ry = pxf * c[4] - pyf * c[7] + c[10];
        float rz = pxf * c[5] - pyf * c[8] + c[11];
        const float rn = sqrtf(rx * rx + ry * ry + rz * rz);
        ray[j][0] = rx / rn;
        ray[j][1] = ry / rn;
        ray[j][2] = rz / rn;
        if (x < width && y < height) {
            const float* a = albedo + (size_t)y * width + x;
            prefetch_l1(a);
            prefetch_l1(a + plane);
            prefetch_l1(a + 2 * plane);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int i = tid; i < n; i += BLOCK_X * BLOCK_Y) {
        const int gy = y0 + i / tw, gx = x0 + i % tw;
        const bool in = gx >= 0 && gx < width && gy >= 0 && gy < height;
        tile[6 * n + i] = in ? logf(fabsf(tile[6 * n + i])) : 0.f;
        tile[7 * n + i] = __int_as_float(
            in ? __float_as_int(tile[7 * n + i]) >> 24 : OUTSIDE);
    }
    __syncthreads();

    const float sigma_r2 = 2.0f * (p[13] * p[13]);
    const float zero_range = 0.f / sigma_r2;
    Out o[ROWS];
    #pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const int e = (ty + j + r) * tw + threadIdx.x + r;
        Out& q = o[j];
        q.r = tile[e];
        q.g = tile[n + e];
        q.b = tile[2 * n + e];
        q.nx = tile[3 * n + e];
        q.ny = tile[4 * n + e];
        q.nz = tile[5 * n + e];
        q.logd = tile[6 * n + e];
        q.mat = __float_as_int(tile[7 * n + e]);
        q.bias = max0(q.nx * -ray[j][0] + q.ny * -ray[j][1] +
                      q.nz * -ray[j][2]);
        q.norm = q.sum_r = q.sum_g = q.sum_b = 0.f;
    }

    const int first = ty * tw + threadIdx.x;  // the window's top-left element
    if (x0 >= 0 && y0 >= 0 && x0 + tw <= width && y0 + th <= height)
        taps<R, false>(P, tile, n, tw, r, first, sigma_r2, zero_range, o);
    else
        taps<R, true>(P, tile, n, tw, r, first, sigma_r2, zero_range, o);

    // albedo modulation: out * (1 - f + f * albedo)
    if (x >= width) return;
    const float af = p[14];
    const float base = 1.0f - af;
    #pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const int y = blockIdx.y * TILE_Y + ty + j;
        if (y >= height) break;
        const size_t q = (size_t)y * width + x;
        out[q] = (o[j].sum_r / o[j].norm) * (base + af * albedo[q]);
        out[plane + q] =
            (o[j].sum_g / o[j].norm) * (base + af * albedo[plane + q]);
        out[2 * plane + q] =
            (o[j].sum_b / o[j].norm) * (base + af * albedo[2 * plane + q]);
    }
}

// The instance for radii whose tile does not fit: one thread per pixel,
// taps from global memory, in denoise_plain's operation order.
template <bool ROW>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) denoise_global_kernel(
    const Params<1> P, const float* __restrict__ colors,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ albedo, const int* __restrict__ node,
    int height, int width, int row0, int radius, float* __restrict__ out) {
    const float* p = P.p;
    const float* c = ROW ? c_camera : P.p;
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t plane = (size_t)height * width;
    const size_t o = (size_t)y * width + x;
    const float pxf = (float)x, pyf = (float)(row0 + y);

    float rx = pxf * c[3] - pyf * c[6] + c[9];
    float ry = pxf * c[4] - pyf * c[7] + c[10];
    float rz = pxf * c[5] - pyf * c[8] + c[11];
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

struct Planes {
    const float* colors;
    const float* normal;
    const float* depth;
    const float* albedo;
    const int* node;
    float* out;
};

template <int R, bool ROW>
cudaError_t launch(const float* params_host, const float* fdist_host,
                   const Planes& g, int height, int width, int row0,
                   int radius, dim3 grid, int shared, cudaStream_t stream) {
    // above 48 KB a block's dynamic shared memory needs the attribute;
    // set once per instance, for its largest tile
    static const cudaError_t attr = cudaFuncSetAttribute(
        denoise_kernel<R, ROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tile_bytes(table_radius(R)));
    if (attr != cudaSuccess) return attr;
    Params<R> P;
    memcpy(P.p, params_host, sizeof(P.p));
    memcpy(P.fdist, fdist_host, sizeof(float) * (2 * radius + 1) * (2 * radius + 1));
    denoise_kernel<R, ROW><<<grid, dim3(BLOCK_X, BLOCK_Y), shared, stream>>>(
        P, g.colors, g.normal, g.depth, g.albedo, g.node, height, width,
        row0, radius, g.out);
    return cudaGetLastError();
}

template <bool ROW>
cudaError_t launch_global(const float* params_host, const Planes& g,
                          int height, int width, int row0, int radius,
                          dim3 grid, cudaStream_t stream) {
    Params<1> P = {};
    memcpy(P.p, params_host, sizeof(P.p));
    denoise_global_kernel<ROW><<<grid, dim3(BLOCK_X, BLOCK_Y), 0, stream>>>(
        P, g.colors, g.normal, g.depth, g.albedo, g.node, height, width,
        row0, radius, g.out);
    return cudaGetLastError();
}

template <bool ROW>
cudaError_t launch_instance(int instance, const float* params_host,
                            const float* fdist_host, const Planes& g,
                            int height, int width, int row0, int radius,
                            dim3 grid, int shared, cudaStream_t stream) {
    switch (instance) {
        case GLOBAL:
            return launch_global<ROW>(params_host, g, height, width, row0,
                                      radius, grid, stream);
#define VT_DENOISE_CASE(R)                                                   \
    case R:                                                                  \
        return launch<R, ROW>(params_host, fdist_host, g, height, width,     \
                              row0, radius, grid, shared, stream);
        VT_DENOISE_CASE(0)
        VT_DENOISE_CASE(1)
        VT_DENOISE_CASE(2)
        VT_DENOISE_CASE(3)
        VT_DENOISE_CASE(4)
        VT_DENOISE_CASE(5)
        VT_DENOISE_CASE(6)
        VT_DENOISE_CASE(7)
        VT_DENOISE_CASE(8)
#undef VT_DENOISE_CASE
        default:
            return cudaErrorInvalidConfiguration;
    }
}

}  // namespace

// The plan (instance, block, rows per thread, grid, shared bytes) is
// ops/denoise.py `tile_plan`'s; a plan that disagrees with this build's
// constants is refused with cudaErrorInvalidConfiguration.  `params_host`
// (a host pointer) holds the whole vector; where `row` (a device pointer
// to the kernel's slice of a frame row) is not null, the camera rows come
// from there instead.  `fdist_host` is the tiled instances' table and is
// not read by the GLOBAL one.
extern "C" int vt_denoise_launch(
    const float* params_host, const float* fdist_host, const float* row,
    const float* colors, const float* normal, const float* depth,
    const float* albedo, const int* node, int height, int width, int row0,
    int radius, int instance, int block_x, int block_y, int rows_per_thread,
    int grid_x, int grid_y, int shared, float* out, void* stream) {
    const bool tiled = radius <= MAX_RADIUS;
    const int tile_x = tiled ? TILE_X : BLOCK_X;
    const int tile_y = tiled ? TILE_Y : BLOCK_Y;
    const bool fits =
        radius >= 1 && row0 >= 0 && params_host && (fdist_host || !tiled) &&
        instance ==
            (tiled ? (radius <= STATIC_RADII ? radius : 0) : GLOBAL) &&
        block_x == BLOCK_X && block_y == BLOCK_Y &&
        rows_per_thread == (tiled ? ROWS : 1) &&
        grid_x == (width + tile_x - 1) / tile_x &&
        grid_y == (height + tile_y - 1) / tile_y &&
        shared == (tiled ? tile_bytes(radius) : 0);
    if (!fits) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(grid_x, grid_y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Planes g = {colors, normal, depth, albedo, node, out};
    if (!row)
        return static_cast<int>(launch_instance<false>(
            instance, params_host, fdist_host, g, height, width, row0, radius,
            grid, shared, s));
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_camera, row, sizeof(c_camera), 0, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_instance<true>(
        instance, params_host, fdist_host, g, height, width, row0, radius,
        grid, shared, s));
}
