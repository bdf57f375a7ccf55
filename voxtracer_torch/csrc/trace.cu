// Path-trace kernel for NVIDIA Hopper (sm_90a): one sample per pixel,
// 3 bounces with sun next-event estimation, over the scene's table
// hierarchy (meta halfwords -> 64-bit brick masks -> 10-bit fine slots).
//
// Replaces voxtracer/ops/trace_pallas.py `_make_kernel` (with
// `_make_traverse` and `finish`), the Pallas TPU kernel.  What it
// computes is that kernel's per-ray semantics; it is a per-thread
// transcription of voxtracer_torch/ops/trace.py `render_sample_plain`,
// which the CPU tests hold against the JAX package, step for step and
// in the same floating-point operation order.  Build without FMA
// contraction (-fmad=false) and without fast math so it rounds as the
// plain version does; only expf/logf/cosf/sinf round differently.
//
// Design.  One thread per pixel in 16x16 blocks (the image edge is
// masked).  The TPU kernel's row-serve gather ladders, lane ray queues,
// lane scrambling and noise parity quads existed because a TPU lane
// cannot load from an address of its own; here every table read is a
// plain indexed load.  The tables stay in global memory (menger's total
// about 1 MB and stay resident in the 50 MB L2); the 1024-entry palette
// sits in shared memory; the (S, 128, 128) noise buffer is read raw.
// A miss adds the sky and ends its path, and the last bounce traces no
// next ray, so neither computes the shading terms the plain version
// computes for every lane and then discards.
//
// Counters.  Exact per-phase `rays` (traversals started) and `steps`
// (outer DDA steps plus advancing micro-DDA steps; the plain version
// counts the same), and `slots`: over the warps and phases, the largest
// step count among a warp's lanes, the step slots a warp spends when
// its lanes march in lockstep, so steps / (32 x slots) is the SIMT
// efficiency of the traversal.  Each warp reduces its lanes' counts
// once per phase into per-block shared counters; a block adds them to
// the output with one atomic each (on an H100, cheaper than keeping
// each thread's steps in shared memory for one reduction at the
// block's end; PERF.md §6).
//
// Parameters.  The by-value entry copies the host's (32,) vector and the
// frame number into the launch.  The row-reading entry (ROW) takes a
// device pointer to its slice of a frame row instead: the launcher
// copies vector and frame number, device to device and in stream order,
// into `c_row` in constant memory just before the launch, so a captured
// CUDA graph (a copy node, then the kernel) renders whichever row the
// device holds there at replay.  Both instances run the one body below
// and read their parameters from a constant bank: staging the row through
// shared memory instead takes 97 registers, not 80, so 16 warps a SM
// instead of 24, and measured 6% slower on an H100 at monu9 1920x1080
// (PERF.md §6).  `c_row` is one per process: the copy and the kernel that
// reads it are ordered on their stream and on no other, so row-reading
// launches (and graphs that hold them) from two streams at once would
// race on it.  The port renders on one stream.
//
// Slabs.  A launch renders `height` rows of the image, local row y being
// image row (y / 16) * row_stride * 16 + row0 + y % 16 (a band of 16 rows
// is a row of blocks: blockIdx.y and threadIdx.y, no division), and reads
// that row for its ray and its noise row: a contiguous slab of a
// row-sharded frame (row_stride 1, row0 its first row) or the cyclic
// layout's every n-th band (voxtracer_torch/parallel/mesh.py).  The
// TPU kernel reads the slab's first row from param slot 30
// (trace_pallas.py:279); here the three integers come by value, outside
// the frame row, so the row-reading entry and captured graphs are as
// they were.  One device: row0 0, row_stride 1.
//
// What bounds it: each DDA step is a chain of dependent loads (meta
// word, then brick mask) plus divergence between the rays of a warp,
// whose step counts differ (SIMT efficiency 0.28 at menger 720p, 0.45
// at castle 4K).  Two alternatives were measured slower on an H100
// (PERF.md §6 has the numbers): a persistent variant (warps claiming
// pixel tiles from a global queue, per-lane path state machines
// refilled in batched shading rounds, tables in shared memory), whose
// shading rounds run the union of the lanes' divergent paths; and
// capping this kernel at 64 registers for 32 resident warps instead of
// 24, which spills.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_BOUNCES = 3;
constexpr int RANDS_PER_BOUNCE = 8;
constexpr int N_PHASES = 2 * MAX_BOUNCES;
// per-ray cap on outer DDA steps; a ray still marching after the last
// one becomes an opaque black leaf at its current cell
constexpr int MAX_RAY_STEPS = 2048;
constexpr int MICRO_STEPS = 5;
constexpr float CELL_SIZE = 0.5f;
constexpr float RAY_EPS = 1e-5f;
constexpr float ALMOST_INFINITY = 1073741824.0f;
constexpr int LEAF_BIT = INT32_MIN;
constexpr int EMISSIVE_BIT = 1 << 30;
constexpr int MISS_NODE = 0xFFFFFF;
constexpr int NOISE_SIZE = 128;
constexpr int PALETTE_SLOTS = 1024;
constexpr int BLOCK_X = 16;
constexpr int BLOCK_Y = 16;

constexpr int N_PARAMS = 32;

// voxtracer_torch/engine/params.py pack_trace_params layout
struct Params {
    float p[N_PARAMS];
};

// the row-reading entry's parameters: the vector, then the frame number
// (not yet reduced modulo n_slices)
struct Row {
    float p[N_PARAMS];
    int frame;
};
__constant__ Row c_row;

// voxtracer_torch/engine/scene.py SceneTables.geometry layout
struct Geometry {
    int X, Y, Z;
    int ox, oy, oz;
    int zw;
    int QX, QY, QZ;
    int dedup;        // 1: (3, rows, 128) dedup bricks; 0: per-node (2, ...)
    int brick_plane;  // words per brick table plane
};

struct Tables {
    const int* __restrict__ packed;
    const int* __restrict__ meta;
    const int* __restrict__ brick;
};

struct Hit {
    bool hit;
    bool fused;
    float t;
    int slot;
    float nx, ny, nz;
    int steps;  // outer steps plus advancing micro steps
};

// the counters: rays[N_PHASES], steps[N_PHASES], slots
constexpr int N_COUNTERS = 2 * N_PHASES + 1;

// min / max that return NaN when either operand is NaN, as torch.minimum
// and jnp.minimum do (fminf would drop it).  Only the slab test can see
// a NaN: 0 * inf for an origin on a box plane with a zero direction.
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ int sign_i(float d) {
    return d > 0.f ? 1 : (d < 0.f ? -1 : 0);
}

__device__ __forceinline__ float sign_f(float d) {
    return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// cell containing o + t*d; a point exactly on a face, travelling in -d,
// belongs to the cell below
__device__ __forceinline__ int cell_from_float(float o, float d, float t,
                                               float og) {
    float p = o + t * d;
    float cf = p / CELL_SIZE - og;
    float c = floorf(cf);
    if (cf == c && d < 0.f) c = c - 1.0f;
    return (int)c;
}

// ray parameter where it leaves [lo, hi) (fine-cell bounds) on one axis
__device__ __forceinline__ float bt_axis(int lo, int hi, float og, int sgn,
                                         float o, float inv) {
    int bnd = sgn > 0 ? hi : lo;
    float nb = (og + (float)bnd) * CELL_SIZE;
    return sgn != 0 ? (nb - o) * inv : CUDART_INF_F;
}

__device__ __forceinline__ bool brick_bit(int b_lo, int b_hi, int cx, int cy,
                                          int cz) {
    int cxm = cx & 3;
    int w = cxm < 2 ? b_lo : b_hi;
    int bitk = ((cxm & 1) << 4) | ((cy & 3) << 2) | (cz & 3);
    return ((w >> bitk) & 1) == 1;
}

__device__ Hit traverse(const Geometry& g, const Tables& tb, float ox,
                        float oy, float oz, float dx, float dy, float dz) {
    Hit r = {false, false, 0.f, 0, 0.f, 0.f, 0.f, 0};
    const float ogx = (float)g.ox, ogy = (float)g.oy, ogz = (float)g.oz;
    const float invx = dx != 0.f ? 1.0f / dx : CUDART_INF_F;
    const float invy = dy != 0.f ? 1.0f / dy : CUDART_INF_F;
    const float invz = dz != 0.f ? 1.0f / dz : CUDART_INF_F;

    // slab test against the grid's world box
    float ax = ((float)g.ox * CELL_SIZE - ox) * invx;
    float bx = ((float)(g.ox + g.X) * CELL_SIZE - ox) * invx;
    float ay = ((float)g.oy * CELL_SIZE - oy) * invy;
    float by = ((float)(g.oy + g.Y) * CELL_SIZE - oy) * invy;
    float az = ((float)g.oz * CELL_SIZE - oz) * invz;
    float bz = ((float)(g.oz + g.Z) * CELL_SIZE - oz) * invz;
    float t_entry = nan_max(nan_max(nan_min(ax, bx), nan_min(ay, by)),
                            nan_min(az, bz));
    float t_exit = nan_min(nan_min(nan_max(ax, bx), nan_max(ay, by)),
                           nan_max(az, bz));
    if (!(t_exit >= 0.f && t_entry < t_exit)) return r;

    float t = fmaxf(t_entry, 0.f);
    int cx = clampi(cell_from_float(ox, dx, t, ogx), 0, g.X - 1);
    int cy = clampi(cell_from_float(oy, dy, t, ogy), 0, g.Y - 1);
    int cz = clampi(cell_from_float(oz, dz, t, ogz), 0, g.Z - 1);
    const int sx = sign_i(dx), sy = sign_i(dy), sz = sign_i(dz);
    const int QZW2 = (g.QZ + 1) / 2;
    const int QY4 = (g.QY + 3) / 4;
    const int PY4 = (g.Y + 3) / 4;
    const int plane = g.brick_plane;

    bool active = true;
    bool hit = false;
    int hslot_u = 0, hcx = 0, hcy = 0, hcz = 0, steps = 0;
    float hit_t = 0.f;
    for (int step = 0; step < MAX_RAY_STEPS; ++step) {
        // 1. bounds check: a ray that left the grid misses
        if (cx < 0 || cx >= g.X || cy < 0 || cy >= g.Y || cz < 0 ||
            cz >= g.Z) {
            active = false;
            break;
        }
        ++steps;
        // 2. the node's 16-bit meta halfword: bit 15 = occupied (with the
        // brick index or uniform slot below it); else a chebyshev
        // distance in nodes
        const int qx = cx >> 2, qy = cy >> 2, qz = cz >> 2;
        const int l3_col =
            ((qx >> 2) * QY4 + (qy >> 2)) * 16 + ((qx & 3) << 2) + (qy & 3);
        const int m_word = __ldg(tb.meta + l3_col * QZW2 + (qz >> 1));
        const int val = (m_word >> ((qz & 1) << 4)) & 0xFFFF;
        if (val & 0x8000) {
            // 3. the node's 64-bit fine mask (+ uniform slot, 0 if mixed)
            int baddr, b_slot;
            if (g.dedup) {
                baddr = val & 0x7FFF;
                b_slot = __ldg(tb.brick + 2 * plane + baddr);
            } else {
                baddr = l3_col * g.QZ + qz;
                b_slot = val & 0x3FF;
            }
            const int b_lo = __ldg(tb.brick + baddr);
            const int b_hi = __ldg(tb.brick + plane + baddr);
            // 4a. micro-DDA over the fine cells: stop on a set bit or on
            // leaving the node
            for (int k = 0; k < MICRO_STEPS; ++k) {
                if (brick_bit(b_lo, b_hi, cx, cy, cz)) break;
                float btx = bt_axis(cx, cx + 1, ogx, sx, ox, invx);
                float bty = bt_axis(cy, cy + 1, ogy, sy, oy, invy);
                float btz = bt_axis(cz, cz + 1, ogz, sz, oz, invz);
                float bt = fminf(fminf(btx, bty), btz);
                bool bsx = btx <= bty && btx <= btz;
                bool bsy = !bsx && bty <= btz;
                if (bsx) cx += sx;
                else if (bsy) cy += sy;
                else cz += sz;
                t = fmaxf(t, bt);
                ++steps;
                if ((cx >> 2) != qx || (cy >> 2) != qy || (cz >> 2) != qz)
                    break;
            }
            if ((cx >> 2) == qx && (cy >> 2) == qy && (cz >> 2) == qz &&
                brick_bit(b_lo, b_hi, cx, cy, cz)) {
                hit = true;
                hit_t = t;
                hcx = cx;
                hcy = cy;
                hcz = cz;
                hslot_u = b_slot;
                active = false;
                break;
            }
        } else {
            // 4b. empty node: distance d certifies the node box
            // [(q-d+1)*4, (q+d)*4) empty; exit it exactly on the crossing
            // axis, the other axes follow the ray
            const int d = max(val & 0x1FF, 1);
            const int lox = (qx - d + 1) * 4, hix = (qx + d) * 4;
            const int loy = (qy - d + 1) * 4, hiy = (qy + d) * 4;
            const int loz = (qz - d + 1) * 4, hiz = (qz + d) * 4;
            float btx = bt_axis(lox, hix, ogx, sx, ox, invx);
            float bty = bt_axis(loy, hiy, ogy, sy, oy, invy);
            float btz = bt_axis(loz, hiz, ogz, sz, oz, invz);
            float bt = fminf(fminf(btx, bty), btz);
            bool bsx = btx <= bty && btx <= btz;
            bool bsy = !bsx && bty <= btz;
            int fxc = cell_from_float(ox, dx, bt, ogx);
            int fyc = cell_from_float(oy, dy, bt, ogy);
            int fzc = cell_from_float(oz, dz, bt, ogz);
            cx = bsx ? (sx > 0 ? hix : lox - 1) : fxc;
            cy = bsy ? (sy > 0 ? hiy : loy - 1) : fyc;
            cz = (!bsx && !bsy) ? (sz > 0 ? hiz : loz - 1) : fzc;
            t = fmaxf(t, bt);
        }
    }
    r.steps = steps;
    bool fused = false;
    if (active) {
        // step cap: opaque black leaf at the current cell
        hit = true;
        fused = true;
        hit_t = t;
        hcx = cx;
        hcy = cy;
        hcz = cz;
    }
    if (!hit) return r;

    // hit resolve: mixed nodes read the 3-slots-per-word fine table
    int slot = 0;
    if (!fused) {
        slot = hslot_u;
        if (hslot_u == 0) {
            const int fzw = hcz / 3;
            const int fcol = ((hcx >> 2) * PY4 + (hcy >> 2)) * 16 +
                             ((hcx & 3) << 2) + (hcy & 3);
            const int fword = __ldg(tb.packed + fcol * g.zw + fzw);
            slot = (fword >> ((hcz - fzw * 3) * 10)) & 1023;
        }
    }
    // normal: dominant axis of (hit point - cell center), opposing the ray
    float px = ox + hit_t * dx;
    float py = oy + hit_t * dy;
    float pz = oz + hit_t * dz;
    float ccx = (ogx + (float)hcx) * CELL_SIZE + 0.5f * CELL_SIZE;
    float ccy = (ogy + (float)hcy) * CELL_SIZE + 0.5f * CELL_SIZE;
    float ccz = (ogz + (float)hcz) * CELL_SIZE + 0.5f * CELL_SIZE;
    float adx = fabsf(px - ccx), ady = fabsf(py - ccy), adz = fabsf(pz - ccz);
    float m = fmaxf(fmaxf(adx, ady), adz);
    r.hit = true;
    r.fused = fused;
    r.t = hit_t;
    r.slot = slot;
    r.nx = adx == m ? -sign_f(dx) : 0.f;
    r.ny = ady == m ? -sign_f(dy) : 0.f;
    r.nz = adz == m ? -sign_f(dz) : 0.f;
    return r;
}

__device__ __forceinline__ void norm_div3(float& x, float& y, float& z) {
    float n = sqrtf(x * x + y * y + z * z);
    x = x / n;
    y = y / n;
    z = z / n;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
    return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void node_rgb(int node, float& r, float& g,
                                         float& b) {
    r = (float)((node >> 16) & 0xFF) / 255.0f;
    g = (float)((node >> 8) & 0xFF) / 255.0f;
    b = (float)(node & 0xFF) / 255.0f;
}

// adds the steps of one phase's rays of the converged lanes to the
// block's counters: their sum to steps[phase], their largest to slots
__device__ __forceinline__ void count_steps(unsigned* cnt, int phase,
                                            int steps) {
    const unsigned lanes = __activemask();
    const unsigned sum = __reduce_add_sync(lanes, (unsigned)steps);
    const unsigned most = __reduce_max_sync(lanes, (unsigned)steps);
    const int lane = (threadIdx.y * BLOCK_X + threadIdx.x) & 31;
    if (lane == __ffs(lanes) - 1 && sum) {
        atomicAdd(cnt + N_PHASES + phase, sum);
        atomicAdd(cnt + 2 * N_PHASES, most);
    }
}

template <bool ROW>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
trace_kernel(const Params P, const Geometry g, const Tables tb,
             const int* __restrict__ palette, const float* __restrict__ noise,
             int n_slices, int frame_value, int height, int width, int row0,
             int row_stride, float* __restrict__ color,
             float* __restrict__ normal,
             float* __restrict__ albedo, float* __restrict__ depth,
             int* __restrict__ node_out,
             unsigned long long* __restrict__ counters) {
    __shared__ int pal[PALETTE_SLOTS];
    // this block's counters (a block's steps fit 32 bits: 256 rays of at
    // most 6 x MAX_RAY_STEPS steps a phase)
    __shared__ unsigned cnt[N_COUNTERS];
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    for (int i = tid; i < PALETTE_SLOTS; i += BLOCK_X * BLOCK_Y)
        pal[i] = palette[i];
    if (tid < N_COUNTERS) cnt[tid] = 0;
    __syncthreads();
    const float* pp = ROW ? c_row.p : P.p;
    const int frame = ROW ? c_row.frame % n_slices : frame_value;

    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    // bit k: this pixel's ray entered traversal phase k of
    // [b0, s0, b1, s1, b2, s2]
    unsigned traced = 0;

    if (x < width && y < height) {
        const float TWO_PI = 2.0f * 3.14159265358979323846f;
        // the image row this local row renders (ops/trace.py image_rows;
        // a band is a row of blocks): its ray and its noise row
        const int gy = blockIdx.y * row_stride * BLOCK_Y + row0 + threadIdx.y;
        const float px = (float)x, py = (float)gy;
        float rdx = px * pp[3] - py * pp[6] + pp[9];
        float rdy = px * pp[4] - py * pp[7] + pp[10];
        float rdz = px * pp[5] - py * pp[8] + pp[11];
        norm_div3(rdx, rdy, rdz);
        float rox = pp[0], roy = pp[1], roz = pp[2];

        const float sun_size = pp[14], sun_strength = pp[15];
        const float emit = pp[16], specularity = pp[17];
        const float scol[3] = {pp[18] * sun_strength, pp[19] * sun_strength,
                               pp[20] * sun_strength};
        const float sdx = pp[24], sdy = pp[25], sdz = pp[26];
        const float nsx = pp[27], nsy = pp[28], nsz = pp[29];
        const bool sun_on = sun_strength > 0.f;
        const float glow_div = fmaxf(sun_size * sun_size, 1e-12f);

        float sample[3] = {0.f, 0.f, 0.f};
        float blend[3] = {1.f, 1.f, 1.f};
        float ambient = 1.f;
        int first_node = MISS_NODE;
        float fn[3] = {ALMOST_INFINITY, ALMOST_INFINITY, ALMOST_INFINITY};
        float first_t = -1.f;

        const int pix = (gy % NOISE_SIZE) * NOISE_SIZE + (x % NOISE_SIZE);
        auto rnd = [&](int k) {
            int s = (frame + 1 + k) % n_slices;
            return __ldg(noise + (size_t)s * NOISE_SIZE * NOISE_SIZE + pix);
        };

        // a path that stops hitting adds nothing at later bounces
        for (int bounce = 0; bounce < MAX_BOUNCES; ++bounce) {
            const int k0 = RANDS_PER_BOUNCE * bounce;
            traced |= 1u << (2 * bounce);
            const Hit h = traverse(g, tb, rox, roy, roz, rdx, rdy, rdz);
            count_steps(cnt, 2 * bounce, h.steps);
            if (!h.hit) {
                // a miss adds the sky, with the sun disk on the primary
                // ray only, and ends the path
                float sky[3] = {pp[21], pp[22], pp[23]};
                if (bounce == 0) {
                    const float base =
                        fmaxf(dot3(rdx, rdy, rdz, -nsx, -nsy, -nsz), 1e-38f);
                    const float glow = expf(logf(base) / glow_div);
                    for (int i = 0; i < 3; ++i)
                        sky[i] = sky[i] + scol[i] * glow;
                }
                for (int i = 0; i < 3; ++i)
                    sample[i] = sample[i] + sky[i] * blend[i];
                break;
            }
            const int node = h.fused ? LEAF_BIT : pal[h.slot];
            const float hx = rox + h.t * rdx;
            const float hy = roy + h.t * rdy;
            const float hz = roz + h.t * rdz;
            float c[3];
            node_rgb(node, c[0], c[1], c[2]);
            float col[3] = {1.f, 1.f, 1.f};
            if (bounce > 0) {
                col[0] = c[0];
                col[1] = c[1];
                col[2] = c[2];
            }
            const float emissive = (node & EMISSIVE_BIT) ? 1.f : 0.f;
            for (int i = 0; i < 3; ++i)
                sample[i] = sample[i] + emissive * emit * c[i] * blend[i];
            if (bounce == 0) {
                first_node = node;
                fn[0] = h.nx;
                fn[1] = h.ny;
                fn[2] = h.nz;
                first_t = h.t;
            }
            const float nx = h.nx, ny = h.ny, nz = h.nz;
            const bool specular = rnd(k0) < specularity;

            // sun next-event estimation: a jittered direction in the disk
            const float rdax = rnd(k0 + 1), rday = rnd(k0 + 2),
                        rdaz = rnd(k0 + 3);
            float upx = rday * sdz - rdaz * sdy;
            float upy = rdaz * sdx - rdax * sdz;
            float upz = rdax * sdy - rday * sdx;
            norm_div3(upx, upy, upz);
            float rix = sdy * upz - sdz * upy;
            float riy = sdz * upx - sdx * upz;
            float riz = sdx * upy - sdy * upx;
            norm_div3(rix, riy, riz);
            const float ddx = 2.0f * rnd(k0 + 4) - 1.0f;
            const float ddy = 2.0f * rnd(k0 + 5) - 1.0f;
            float shx = -(nsx + (ddx * rix + ddy * upx) * sun_size);
            float shy = -(nsy + (ddx * riy + ddy * upy) * sun_size);
            float shz = -(nsz + (ddx * riz + ddy * upz) * sun_size);
            norm_div3(shx, shy, shz);
            const float sox = hx + RAY_EPS * nx;
            const float soy = hy + RAY_EPS * ny;
            const float soz = hz + RAY_EPS * nz;
            // the shadow ray is skipped where the sun is behind the
            // surface: its contribution is clamped to zero regardless
            const float cos_term = fmaxf(dot3(nx, ny, nz, shx, shy, shz), 0.f);
            const bool s_mask = !specular && sun_on && cos_term > 0.f;
            ambient = ambient + ((!specular && sun_on) ? 1.f : 0.f);

            // the sun add below uses the blend from before this update
            const float lt_blend[3] = {blend[0], blend[1], blend[2]};
            // the next ray, which the last bounce does not need
            if (bounce + 1 < MAX_BOUNCES) {
                if (specular) {
                    // specular reflection
                    const float ddn = dot3(nx, ny, nz, rdx, rdy, rdz);
                    float rfx = rdx - 2.0f * ddn * nx;
                    float rfy = rdy - 2.0f * ddn * ny;
                    float rfz = rdz - 2.0f * ddn * nz;
                    norm_div3(rfx, rfy, rfz);
                    const float bf_spec =
                        2.0f * dot3(rfx, rfy, rfz, nx, ny, nz);
                    for (int i = 0; i < 3; ++i)
                        blend[i] = blend[i] * col[i] * bf_spec;
                    rdx = rfx;
                    rdy = rfy;
                    rdz = rfz;
                } else {
                    // hemisphere sample
                    const float phi = TWO_PI * rnd(k0 + 6);
                    const float hxs = 2.0f * rnd(k0 + 7) - 1.0f;
                    const float pr = sqrtf(fmaxf(1.0f - hxs * hxs, 0.f));
                    const float spx = hxs, spy = pr * cosf(phi),
                                spz = pr * sinf(phi);
                    const float flip =
                        fminf(2.0f * dot3(nx, ny, nz, spx, spy, spz), 0.f);
                    const float hmx = spx - nx * flip;
                    const float hmy = spy - ny * flip;
                    const float hmz = spz - nz * flip;
                    const float diff_dot = dot3(nx, ny, nz, hmx, hmy, hmz);
                    for (int i = 0; i < 3; ++i)
                        blend[i] = blend[i] * col[i] * diff_dot;
                    rdx = hmx;
                    rdy = hmy;
                    rdz = hmz;
                }
                rox = sox;
                roy = soy;
                roz = soz;
            }

            bool obst = false;
            int shadow_steps = 0;
            if (s_mask) {
                traced |= 1u << (2 * bounce + 1);
                const Hit s = traverse(g, tb, sox, soy, soz, shx, shy, shz);
                obst = s.hit;
                shadow_steps = s.steps;
            }
            count_steps(cnt, 2 * bounce + 1, shadow_steps);
            if (!specular && !obst && sun_on)
                for (int i = 0; i < 3; ++i)
                    sample[i] =
                        sample[i] + scol[i] * col[i] * lt_blend[i] * cos_term;
        }

        const size_t plane = (size_t)height * width;
        const size_t o = (size_t)y * width + x;
        for (int i = 0; i < 3; ++i) {
            color[i * plane + o] = sample[i] / ambient;
            normal[i * plane + o] = fn[i];
        }
        depth[o] = first_t;
        node_out[o] = first_node;
        float ar, ag, ab;
        node_rgb(first_node, ar, ag, ab);
        const bool emiss_first = (first_node & EMISSIVE_BIT) != 0;
        albedo[o] = emiss_first ? 1.f : ar;
        albedo[plane + o] = emiss_first ? 1.f : ag;
        albedo[2 * plane + o] = emiss_first ? 1.f : ab;
    }

    // exact per-phase ray counts: one shared atomic per warp and phase,
    // then one global atomic per block and counter
    const int lane = tid & 31;
    for (int k = 0; k < N_PHASES; ++k) {
        const unsigned bal = __ballot_sync(0xffffffffu, (traced >> k) & 1u);
        if (lane == 0 && bal) atomicAdd(cnt + k, (unsigned)__popc(bal));
    }
    __syncthreads();
    if (tid < N_COUNTERS && cnt[tid])
        atomicAdd(counters + tid, (unsigned long long)cnt[tid]);
}

}  // namespace

// Parameters by value (`params_host`, a host pointer, and `frame`, already
// reduced modulo n_slices) or, where `params_host` is null, from device
// memory: `row` points at the kernel's slice of a frame row (its vector,
// then the frame number as an int32 bit pattern: a `Row`).  Local row y
// of the `height` rows renders image row
// (y / BLOCK_Y) * row_stride * BLOCK_Y + row0 + y % BLOCK_Y: row0 + y for
// a contiguous slab (row_stride 1), every row_stride-th band of BLOCK_Y
// rows for the cyclic slab layout; by value, never through the frame row.
extern "C" int vt_trace_launch(
    const float* params_host, const float* row, const int* geometry_host,
    const int* packed, const int* meta, const int* brick, const int* palette,
    const float* noise, int n_slices, int frame, int height, int width,
    int row0, int row_stride, float* color, float* normal, float* albedo,
    float* depth, int* node, unsigned long long* counters, void* stream) {
    if (row0 < 0 || row_stride < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params P = {};
    Geometry g;
    memcpy(&g, geometry_host, sizeof(g));
    const Tables tb = {packed, meta, brick};
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((width + BLOCK_X - 1) / BLOCK_X,
                    (height + BLOCK_Y - 1) / BLOCK_Y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (params_host) {
        memcpy(P.p, params_host, sizeof(P.p));
        trace_kernel<false><<<grid, block, 0, s>>>(
            P, g, tb, palette, noise, n_slices, frame, height, width, row0,
            row_stride, color, normal, albedo, depth, node, counters);
    } else {
        if (!row) return static_cast<int>(cudaErrorInvalidValue);
        const cudaError_t err = cudaMemcpyToSymbolAsync(
            c_row, row, sizeof(Row), 0, cudaMemcpyDeviceToDevice, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        trace_kernel<true><<<grid, block, 0, s>>>(
            P, g, tb, palette, noise, n_slices, 0, height, width, row0,
            row_stride, color, normal, albedo, depth, node, counters);
    }
    return static_cast<int>(cudaGetLastError());
}

// The by-value instance's resources: out[0] registers a thread, [1] local
// bytes a thread, [2] static shared bytes a block, [3] resident blocks per
// SM, [4] threads a block.
extern "C" int vt_trace_info(int* out) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, trace_kernel<false>);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trace_kernel<false>, BLOCK_X * BLOCK_Y, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = per_sm;
    out[4] = BLOCK_X * BLOCK_Y;
    return 0;
}
