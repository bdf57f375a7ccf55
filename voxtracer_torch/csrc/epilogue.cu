// Frame epilogue kernels for NVIDIA Hopper (sm_90a): the tail of a frame
// after its trace (and its temporal or denoise kernel), one pass over the
// image, four horizontally adjacent pixels a thread.
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
//   frame that the denoise kernel filters next).  In place it blends
//   into the history it reads (the sequence path's carried state): the
//   launcher passes `old_color` as `blended`, `old_blend` as
//   `next_blend` and `old_depth` as `depth_out`, which takes this
//   frame's depth (null out of place).  Every pixel is read and written
//   by one thread, reads first, and none of the pointers that may alias
//   is declared __restrict__.
// - encode_kernel: the u8 encode of a linear (3, Hp, Wp) plane that the
//   temporal or the denoise kernel wrote, cropped to (H, W); given an
//   albedo plane the radius-0 modulate first, and then, given a
//   pointer, the modulated linear too.
//
// Both write the image at `image + slot * H * W * 3` where `slot` is a
// device pointer (the sequence path's frame slot, advanced by its graph),
// else at `image`; a slot outside [0, n_images) writes no image.
//
// Parity.  Each is a per-pixel transcription of those plain torch ops,
// in their floating-point operation order, built without FMA contraction
// (-fmad=false) and without fast math: IEEE division and square root as
// torch's CUDA kernels do them.  torch.clamp / clamp_min keep a NaN and
// are min(max(x, lo), hi) otherwise (clampf, max0 below).  The encode
// calls what torch's CUDA kernels call: `powf` with the exponent 1 / 2.4
// rounded to float32 (pow_tensor_scalar_kernel's `::pow(base, exp)` on
// float32), float32 products and sums of the constants rounded to
// float32, `rintf` for torch.round (half to even), and the u8 conversion
// through int64 as c10's static_cast_with_inter_type.  The 4-pixel path
// and the scalar path run one function (`still_pixels`, `encode_pixels`)
// whose width is a template parameter: the same operations on each
// pixel.
//
// What bounds it.  Memory: the still epilogue at radius 0 reads colour,
// depth and albedo (28 B a pixel) and writes blend, next blend and the
// u8 image (19 B; 31 with the linear) on every pixel; a hit with live
// history also reads the normal and the old depth (16 B) that decide
// whether it keeps the history, and a pixel that keeps it the old colour
// and old blend (16 B): 47 to 79 B a pixel, so the bound follows the
// frame's data (app/renderbench.py still_bytes; 50 B a pixel on castle
// at 3840x2160, whose pixels are 89% sky: 0.125 ms at 3.35 TB/s, where a
// device copy of as many bytes reaches 0.72 of that rate).  The encode
// reads 12 B (24 with the albedo) and writes 3 (15 with the linear).
// But the parity
// recipe's arithmetic is not free: the IEEE powf of the sRGB curve
// (three a pixel) and the validity test (two unit rays, two world
// points, the view-angle bias, the world distance: 9 IEEE divisions and
// 4 square roots a pixel) are long instruction sequences, and the
// encode is issue-bound on powf (at 1920x1080 a plane that takes the
// curve's linear branch encodes in a third of the time one that takes
// its power branch does; PERF.md section 6).  So the design moves the
// bytes in few, wide accesses, skips the arithmetic and the bytes that
// cannot change the result, and keeps enough warps resident to overlap
// the rest with memory:
// - four horizontally adjacent pixels a thread, 32x8 threads a block (a
//   128x8-pixel tile): each plane is read and written with 16-byte
//   (float4) accesses, a warp's 512 contiguous bytes, and the u8 image
//   with three aligned 32-bit stores a thread (12 bytes at a multiple of
//   12 when x and the width are multiples of 4), a warp's 384 contiguous
//   bytes.  Every width of the main path is a multiple of 4 (1280, 1920,
//   3840, 640); another width, unaligned planes, and the encode's crop
//   where it is no multiple of 4 run the instance that takes the four
//   pixels one by one (VEC false);
// - the validity test runs only where it can change the result: on a
//   hit with live history.  On a miss, or on the first frame after a
//   reset (history_valid 0), `valid` is false whatever the test gives;
//   the planes only the test reads (normal, old depth) are read only
//   where some pixel of a thread's four needs the test, old colour and
//   old blend only where some pixel of the four keeps its history;
// - every plane is read and written with streaming (evict-first) cache
//   hints, __ldcs / __stcs: nothing in a frame reads them again before
//   the next frame's trace has written more than the 50 MB L2 holds, and
//   the outputs then leave in the L2 the planes the trace has just
//   written and the kernel has yet to read (12-20% faster at 1280x720
//   and 1920x1080 in a frame's cache state, the same at 3840x2160);
// - one tile a block and each variant its own instance (by value or by
//   row, four pixels or one by one), so that no instance carries
//   another's registers: the 4-pixel still epilogue holds 64 registers
//   (4 blocks, 32 warps an SM), the encode 29.
//   Measured and not kept (PERF.md section 6): a grid sized to the card
//   with blocks striding over the tiles, 2 and 1 pixels a thread, the
//   history read with the test's planes, a 4- or 5-block register cap.
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

constexpr int PX = 4;           // pixels a thread, along x
constexpr int BLOCK_X = 32;     // threads of a block along x: one warp
constexpr int BLOCK_Y = 8;      // rows of a tile
constexpr int TILE_W = BLOCK_X * PX;  // 128 pixels
constexpr int BLOCK = BLOCK_X * BLOCK_Y;

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

// The same-position test of a hit pixel: the first-hit world points of
// the new and the old camera, their distance against the depth scaled
// by the view angle's bias.
__device__ __forceinline__ bool same_position(const float* p, float pxf,
                                              float pyf, float d, float od,
                                              float nx, float ny, float nz) {
    const float* old = p + P_OLD_CAM;
    float rx, ry, rz;
    unit_ray(p, pxf, pyf, rx, ry, rz);
    const float wx = p[0] + d * rx;
    const float wy = p[1] + d * ry;
    const float wz = p[2] + d * rz;
    float orx, ory, orz;
    unit_ray(old, pxf, pyf, orx, ory, orz);
    const float owx = old[0] + od * orx;
    const float owy = old[1] + od * ory;
    const float owz = old[2] + od * orz;
    const float cdx = p[0] - wx, cdy = p[1] - wy, cdz = p[2] - wz;
    const float cn = sqrtf(cdx * cdx + cdy * cdy + cdz * cdz);
    const float bias =
        max0((cdx / cn) * nx + (cdy / cn) * ny + (cdz / cn) * nz);
    const float dx = owx - wx, dy = owy - wy, dz = owz - wz;
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    return dist < bias * p[P_CUTOFF] * d;
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

// N adjacent float32 values of one plane: 4 as one 16-byte access
template <int N>
struct Fv {
    float v[N];
};

template <int N>
__device__ __forceinline__ Fv<N> load(const float* q) {
    Fv<N> a;
    if constexpr (N == 4) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(q));
        a.v[0] = t.x;
        a.v[1] = t.y;
        a.v[2] = t.z;
        a.v[3] = t.w;
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) a.v[i] = __ldcs(q + i);
    }
    return a;
}

template <int N>
__device__ __forceinline__ void store(float* q, const Fv<N>& a) {
    if constexpr (N == 4) {
        __stcs(reinterpret_cast<float4*>(q),
               make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) __stcs(q + i, a.v[i]);
    }
}

// the u8 codes of N pixels, interleaved (r, g, b a pixel), at q: four
// pixels as three 32-bit stores (q on a multiple of 4)
template <int N>
__device__ __forceinline__ void store_u8(uint8_t* q,
                                         const uint8_t (&u)[N][3]) {
    if constexpr (N == 4) {
        unsigned int* w = reinterpret_cast<unsigned int*>(q);
        __stcs(w, (unsigned int)u[0][0] | ((unsigned int)u[0][1] << 8) |
                      ((unsigned int)u[0][2] << 16) |
                      ((unsigned int)u[1][0] << 24));
        __stcs(w + 1, (unsigned int)u[1][1] | ((unsigned int)u[1][2] << 8) |
                          ((unsigned int)u[2][0] << 16) |
                          ((unsigned int)u[2][1] << 24));
        __stcs(w + 2, (unsigned int)u[2][2] | ((unsigned int)u[3][0] << 8) |
                          ((unsigned int)u[3][1] << 16) |
                          ((unsigned int)u[3][2] << 24));
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int c = 0; c < 3; ++c) __stcs(q + 3 * i + c, u[i][c]);
        }
    }
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

// The still epilogue of N adjacent pixels (x .. x + N - 1 of image row
// pyf, at plane offset o).  In place, `blended` is `old_color`,
// `next_blend` is `old_blend` and `depth_out` is `old_depth`.
template <int N>
__device__ __forceinline__ void still_pixels(
    const float* p, int x, float pyf, size_t o, size_t plane,
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ depth, const float* old_color,
    const float* old_blend, const float* old_depth,
    const float* __restrict__ albedo, float* blended, float* next_blend,
    float* depth_out, float* __restrict__ linear,
    uint8_t* __restrict__ px) {
    const Fv<N> d = load<N>(depth + o);
    Fv<N> sc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) sc[c] = load<N>(color + c * plane + o);

    // valid: the same-position test, which matters only on a hit with
    // live history (elsewhere valid is false whatever it gives)
    bool hit[N], valid[N];
    bool test = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        hit[i] = d.v[i] >= 0.f;
        valid[i] = false;
        test = test || hit[i];
    }
    bool keep = false;
    if (test && p[P_HISTORY_VALID] > 0.f) {
        const Fv<N> od = load<N>(old_depth + o);
        const Fv<N> nx = load<N>(normal + o);
        const Fv<N> ny = load<N>(normal + plane + o);
        const Fv<N> nz = load<N>(normal + 2 * plane + o);
#pragma unroll
        for (int i = 0; i < N; ++i) {
            if (hit[i]) {
                valid[i] = same_position(p, (float)(x + i), pyf, d.v[i],
                                         od.v[i], nx.v[i], ny.v[i], nz.v[i]);
            }
            keep = keep || valid[i];
        }
    }
    // the history, read only where some pixel keeps it
    Fv<N> ob, oc[3];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        ob.v[i] = 1.f;
        oc[0].v[i] = oc[1].v[i] = oc[2].v[i] = 0.f;
    }
    if (keep) {
        ob = load<N>(old_blend + o);
#pragma unroll
        for (int c = 0; c < 3; ++c) oc[c] = load<N>(old_color + c * plane + o);
    }

    float blending[N];
    Fv<N> nb, b[3];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        blending[i] = valid[i] ? ob.v[i] : 1.f;
        nb.v[i] = clampf(p[P_KEEP_SAMPLE] * blending[i], p[P_KEEP_FLOOR], 1.f);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const float use = valid[i] ? oc[c].v[i] : 0.f;
            b[c].v[i] = hit[i] ? use * (1.f - blending[i])
                                     + sc[c].v[i] * blending[i]
                               : sc[c].v[i];
        }
    }
    if (depth_out) store<N>(depth_out + o, d);
    store<N>(next_blend + o, nb);
#pragma unroll
    for (int c = 0; c < 3; ++c) store<N>(blended + c * plane + o, b[c]);
    if (!albedo) return;
    uint8_t u[N][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const Fv<N> a = load<N>(albedo + c * plane + o);
        Fv<N> m;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            m.v[i] = modulate(b[c].v[i], a.v[i], p);
            if (px) u[i][c] = srgb_u8(m.v[i]);
        }
        if (linear) store<N>(linear + c * plane + o, m);
    }
    if (px) store_u8<N>(px, u);
}

// One thread: PX adjacent pixels of a row, as one group (VEC: the width
// a multiple of PX and the planes aligned for it) or one by one.
template <bool ROW, bool VEC>
__global__ void __launch_bounds__(BLOCK) still_epilogue_kernel(
    const Params P, const float* __restrict__ color,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* old_color, const float* old_blend, const float* old_depth,
    const float* __restrict__ albedo, int height, int width, int row0,
    float* blended, float* next_blend, float* depth_out,
    float* __restrict__ linear, uint8_t* __restrict__ image,
    const int64_t* __restrict__ slot, int n_images) {
    const int x = (blockIdx.x * BLOCK_X + threadIdx.x) * PX;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (y >= height || x >= width) return;
    const float* p = ROW ? c_row.p : P.p;
    const float pyf = (float)(row0 + y);  // the image row (a slab's)
    const size_t plane = (size_t)height * width;
    const size_t o = (size_t)y * width + x;
    uint8_t* img =
        albedo ? image_base(image, slot, n_images, plane * 3) : nullptr;
    if constexpr (VEC) {
        still_pixels<PX>(p, x, pyf, o, plane, color, normal, depth, old_color,
                         old_blend, old_depth, albedo, blended, next_blend,
                         depth_out, linear, img ? img + o * 3 : nullptr);
    } else {
        const int n = min(PX, width - x);
        for (int i = 0; i < n; ++i) {
            still_pixels<1>(p, x + i, pyf, o + i, plane, color, normal, depth,
                            old_color, old_blend, old_depth, albedo, blended,
                            next_blend, depth_out, linear,
                            img ? img + (o + i) * 3 : nullptr);
        }
    }
}

// The encode of N adjacent pixels at plane offset o (the image's pixels
// at px, or none where px is null).
template <int N>
__device__ __forceinline__ void encode_pixels(
    const float* p, size_t o, size_t plane, const float* __restrict__ src,
    const float* __restrict__ albedo, float* __restrict__ linear,
    uint8_t* __restrict__ px) {
    if (!px && !(albedo && linear)) return;  // outside the crop
    uint8_t u[N][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        Fv<N> v = load<N>(src + c * plane + o);
        if (albedo) {
            const Fv<N> a = load<N>(albedo + c * plane + o);
#pragma unroll
            for (int i = 0; i < N; ++i) v.v[i] = modulate(v.v[i], a.v[i], p);
            if (linear) store<N>(linear + c * plane + o, v);
        }
        if (px) {
#pragma unroll
            for (int i = 0; i < N; ++i) u[i][c] = srgb_u8(v.v[i]);
        }
    }
    if (px) store_u8<N>(px, u);
}

template <bool ROW, bool VEC>
__global__ void __launch_bounds__(BLOCK) encode_kernel(
    const Params P, const float* __restrict__ src,
    const float* __restrict__ albedo, int in_h, int in_w, int height,
    int width, float* __restrict__ linear, uint8_t* __restrict__ image,
    const int64_t* __restrict__ slot, int n_images) {
    const int x = (blockIdx.x * BLOCK_X + threadIdx.x) * PX;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    if (y >= in_h || x >= in_w) return;
    const float* p = ROW ? c_row.p : P.p;
    const size_t plane = (size_t)in_h * in_w;
    const size_t o = (size_t)y * in_w + x;
    uint8_t* img =
        y < height
            ? image_base(image, slot, n_images, (size_t)height * width * 3)
            : nullptr;
    if constexpr (VEC) {  // the width a multiple of PX: all in or all out
        encode_pixels<PX>(
            p, o, plane, src, albedo, linear,
            img && x < width ? img + ((size_t)y * width + x) * 3 : nullptr);
    } else {
        const int n = min(PX, in_w - x);
        for (int i = 0; i < n; ++i) {
            encode_pixels<1>(
                p, o + i, plane, src, albedo, linear,
                img && x + i < width
                    ? img + ((size_t)y * width + x + i) * 3 : nullptr);
        }
    }
}

// The parameters by value (`params_host`, a host pointer to the 59
// floats) or, where it is null, copied from the device slice `row` into
// `c_row`; returns whether the row-reading instance runs, or an error.
cudaError_t stage_params(const float* params_host, const float* row,
                         bool needed, cudaStream_t s, Params& P,
                         bool& by_row) {
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

// a pointer the PX-pixel groups can use: null, or on `align` bytes
bool aligned(const void* q, uintptr_t align) {
    return !q || (reinterpret_cast<uintptr_t>(q) % align) == 0;
}

dim3 grid_of(int height, int width) {
    return dim3((width + TILE_W - 1) / TILE_W,
                (height + BLOCK_Y - 1) / BLOCK_Y);
}

// One launch of the instance for `vec` (the PX-pixel groups or the
// pixels one by one), then the launch check.
template <bool ROW, typename... Args>
cudaError_t launch_still(bool vec, int height, int width, cudaStream_t s,
                         Args... args) {
    const dim3 grid = grid_of(height, width), block(BLOCK_X, BLOCK_Y);
    if (vec) {
        still_epilogue_kernel<ROW, true><<<grid, block, 0, s>>>(args...);
    } else {
        still_epilogue_kernel<ROW, false><<<grid, block, 0, s>>>(args...);
    }
    return cudaGetLastError();
}

template <bool ROW, typename... Args>
cudaError_t launch_encode(bool vec, int in_h, int in_w, cudaStream_t s,
                          Args... args) {
    const dim3 grid = grid_of(in_h, in_w), block(BLOCK_X, BLOCK_Y);
    if (vec) {
        encode_kernel<ROW, true><<<grid, block, 0, s>>>(args...);
    } else {
        encode_kernel<ROW, false><<<grid, block, 0, s>>>(args...);
    }
    return cudaGetLastError();
}

}  // namespace

// The still blend of a (height, width) frame (image rows row0 .., a slab
// of a row-sharded frame, its history the same rows; 0 on one device)
// into `blended` (3, H, W) and `next_blend` (H, W); with `albedo` also
// the radius-0 modulate, the u8 image (at `image`, or at frame *slot of
// `n_images` where `slot` is not null) and, where `linear` is not null,
// the modulated linear.  With
// `in_place` the blend goes over `old_color`, the next blend over
// `old_blend` and `depth` over `old_depth` (`blended` and `next_blend`
// are then not used).
extern "C" int vt_still_epilogue_launch(
    const float* params_host, const float* row, const float* color,
    const float* normal, const float* depth, float* old_color,
    float* old_blend, float* old_depth, const float* albedo, int height,
    int width, int row0, float* blended, float* next_blend, float* linear,
    uint8_t* image, const int64_t* slot, int n_images, int in_place,
    void* stream) {
    if (height <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
    if (row0 < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (albedo && !image) return static_cast<int>(cudaErrorInvalidValue);
    if (!in_place && (!blended || !next_blend))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Params P = {};
    bool by_row;
    cudaError_t err = stage_params(params_host, row, true, s, P, by_row);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec =
        width % PX == 0 && aligned(color, 4 * PX) &&
        aligned(normal, 4 * PX) && aligned(depth, 4 * PX) &&
        aligned(old_color, 4 * PX) && aligned(old_blend, 4 * PX) &&
        aligned(old_depth, 4 * PX) && aligned(albedo, 4 * PX) &&
        aligned(blended, 4 * PX) && aligned(next_blend, 4 * PX) &&
        aligned(linear, 4 * PX) && aligned(image, PX);
    float* depth_out = nullptr;
    if (in_place) {
        blended = old_color;
        next_blend = old_blend;
        depth_out = old_depth;
    }
    err = by_row ? launch_still<true>(vec, height, width, s, P, color, normal,
                                      depth, old_color, old_blend, old_depth,
                                      albedo, height, width, row0, blended,
                                      next_blend, depth_out, linear, image,
                                      slot, n_images)
                 : launch_still<false>(vec, height, width, s, P, color,
                                       normal, depth, old_color, old_blend,
                                       old_depth, albedo, height, width,
                                       row0, blended, next_blend, depth_out,
                                       linear, image, slot, n_images);
    return static_cast<int>(err);
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
    cudaError_t err =
        stage_params(params_host, row, albedo != nullptr, s, P, by_row);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = in_w % PX == 0 && width % PX == 0 &&
                     aligned(src, 4 * PX) && aligned(albedo, 4 * PX) &&
                     aligned(linear, 4 * PX) && aligned(image, PX);
    err = by_row ? launch_encode<true>(vec, in_h, in_w, s, P, src, albedo,
                                       in_h, in_w, height, width, linear,
                                       image, slot, n_images)
                 : launch_encode<false>(vec, in_h, in_w, s, P, src, albedo,
                                        in_h, in_w, height, width, linear,
                                        image, slot, n_images);
    return static_cast<int>(err);
}
