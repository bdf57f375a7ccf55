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
//
// What bounds it: each DDA step is a chain of dependent loads (meta
// word, then brick mask) plus divergence between the rays of a warp,
// whose step counts differ.  Nothing here hides that latency beyond the
// warps the SM keeps resident; wavefront queues or persistent threads
// are for later, after a measurement on the card.

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

// voxtracer_torch/engine/params.py pack_trace_params layout
struct Params {
    float p[32];
};

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
};

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
    Hit r = {false, false, 0.f, 0, 0.f, 0.f, 0.f};
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
    int hslot_u = 0, hcx = 0, hcy = 0, hcz = 0;
    float hit_t = 0.f;
    for (int step = 0; step < MAX_RAY_STEPS; ++step) {
        // 1. bounds check: a ray that left the grid misses
        if (cx < 0 || cx >= g.X || cy < 0 || cy >= g.Y || cz < 0 ||
            cz >= g.Z) {
            active = false;
            break;
        }
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

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
trace_kernel(const Params P, const Geometry g, const Tables tb,
             const int* __restrict__ palette, const float* __restrict__ noise,
             int n_slices, int frame, int height, int width,
             float* __restrict__ color, float* __restrict__ normal,
             float* __restrict__ albedo, float* __restrict__ depth,
             int* __restrict__ node_out, unsigned long long* __restrict__ rays) {
    __shared__ int pal[PALETTE_SLOTS];
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    for (int i = tid; i < PALETTE_SLOTS; i += BLOCK_X * BLOCK_Y)
        pal[i] = palette[i];
    __syncthreads();

    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    // bit k: this pixel's ray entered traversal phase k of
    // [b0, s0, b1, s1, b2, s2]
    unsigned traced = 0;

    if (x < width && y < height) {
        const float TWO_PI = 2.0f * 3.14159265358979323846f;
        const float* pp = P.p;
        const float px = (float)x, py = (float)y;
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

        const int pix = (y % NOISE_SIZE) * NOISE_SIZE + (x % NOISE_SIZE);
        auto rnd = [&](int k) {
            int s = (frame + 1 + k) % n_slices;
            return __ldg(noise + (size_t)s * NOISE_SIZE * NOISE_SIZE + pix);
        };

        // a path that stops hitting adds nothing at later bounces
        for (int bounce = 0; bounce < MAX_BOUNCES; ++bounce) {
            const int k0 = RANDS_PER_BOUNCE * bounce;
            traced |= 1u << (2 * bounce);
            const Hit h = traverse(g, tb, rox, roy, roz, rdx, rdy, rdz);
            const bool hit = h.hit;
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
                sample[i] = sample[i] +
                            (hit ? emissive * emit * c[i] * blend[i] : 0.f);
            if (bounce == 0 && hit) {
                first_node = node;
                fn[0] = h.nx;
                fn[1] = h.ny;
                fn[2] = h.nz;
                first_t = h.t;
            }
            const float nx = h.nx, ny = h.ny, nz = h.nz;
            const bool specular = rnd(k0) < specularity;

            // specular reflection
            const float ddn = dot3(nx, ny, nz, rdx, rdy, rdz);
            float rfx = rdx - 2.0f * ddn * nx;
            float rfy = rdy - 2.0f * ddn * ny;
            float rfz = rdz - 2.0f * ddn * nz;
            norm_div3(rfx, rfy, rfz);
            const float spec_dot = dot3(rfx, rfy, rfz, nx, ny, nz);

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
            const bool s_mask = hit && !specular && sun_on && cos_term > 0.f;

            // hemisphere sample
            const float phi = TWO_PI * rnd(k0 + 6);
            const float hxs = 2.0f * rnd(k0 + 7) - 1.0f;
            const float pr = sqrtf(fmaxf(1.0f - hxs * hxs, 0.f));
            const float spx = hxs, spy = pr * cosf(phi), spz = pr * sinf(phi);
            const float flip = fminf(2.0f * dot3(nx, ny, nz, spx, spy, spz), 0.f);
            const float hmx = spx - nx * flip;
            const float hmy = spy - ny * flip;
            const float hmz = spz - nz * flip;
            const float diff_dot = dot3(nx, ny, nz, hmx, hmy, hmz);

            const bool spec_sel = specular && hit;
            const bool diff_sel = !specular && hit;
            ambient = ambient + ((diff_sel && sun_on) ? 1.f : 0.f);

            // sky on a miss, with the sun disk on the primary ray only
            float sky[3] = {pp[21], pp[22], pp[23]};
            if (bounce == 0) {
                const float base =
                    fmaxf(dot3(rdx, rdy, rdz, -nsx, -nsy, -nsz), 1e-38f);
                const float glow = expf(logf(base) / glow_div);
                for (int i = 0; i < 3; ++i) sky[i] = sky[i] + scol[i] * glow;
            }

            // the sun add below uses the blend from before this update
            const float lt_blend[3] = {blend[0], blend[1], blend[2]};
            const float bf_spec = 2.0f * spec_dot;
            for (int i = 0; i < 3; ++i) {
                if (spec_sel) blend[i] = blend[i] * col[i] * bf_spec;
                else if (diff_sel) blend[i] = blend[i] * col[i] * diff_dot;
            }
            for (int i = 0; i < 3; ++i)
                sample[i] = sample[i] + (!hit ? sky[i] * blend[i] : 0.f);
            if (spec_sel) {
                rdx = rfx;
                rdy = rfy;
                rdz = rfz;
            } else if (diff_sel) {
                rdx = hmx;
                rdy = hmy;
                rdz = hmz;
            }
            if (hit) {
                rox = sox;
                roy = soy;
                roz = soz;
            }

            if (s_mask) traced |= 1u << (2 * bounce + 1);
            const bool obst =
                s_mask && traverse(g, tb, sox, soy, soz, shx, shy, shz).hit;
            if (diff_sel && !obst && sun_on)
                for (int i = 0; i < 3; ++i)
                    sample[i] =
                        sample[i] + scol[i] * col[i] * lt_blend[i] * cos_term;
            if (!hit) break;
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

    // exact per-phase ray counts: one atomic per warp and phase
    const int lane = tid & 31;
    for (int k = 0; k < N_PHASES; ++k) {
        const unsigned bal = __ballot_sync(0xffffffffu, (traced >> k) & 1u);
        if (lane == 0 && bal)
            atomicAdd(rays + k, (unsigned long long)__popc(bal));
    }
}

}  // namespace

extern "C" int vt_trace_launch(
    const float* params_host, const int* geometry_host, const int* packed,
    const int* meta, const int* brick, const int* palette, const float* noise,
    int n_slices, int frame, int height, int width, float* color,
    float* normal, float* albedo, float* depth, int* node,
    unsigned long long* rays, void* stream) {
    Params P;
    memcpy(P.p, params_host, sizeof(P.p));
    Geometry g;
    memcpy(&g, geometry_host, sizeof(g));
    const Tables tb = {packed, meta, brick};
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((width + BLOCK_X - 1) / BLOCK_X,
                    (height + BLOCK_Y - 1) / BLOCK_Y);
    trace_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        P, g, tb, palette, noise, n_slices, frame, height, width, color,
        normal, albedo, depth, node, rays);
    return static_cast<int>(cudaGetLastError());
}
