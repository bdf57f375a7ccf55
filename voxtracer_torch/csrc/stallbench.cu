// Handoff-stall microbenchmark kernel for NVIDIA Hopper (sm_90a): one
// block computes the one (32, 128) int32 program of the TPU kernel.
//
// Replaces voxtracer/app/stallbench.py `_make_kernel` (launched by
// `run_case`), the Pallas TPU kernel.  It computes the int32 words of
// voxtracer_torch/app/stallbench.py `run_plain`, which the CPU tests
// hold against the interpreted Pallas kernel.
//
// What it measures.  Each trip runs dependent integer multiply-add
// chains (`pre` ops ahead of the reduce, `mid` ops between the reduce and
// its use), then `h` serve sweeps; a sweep yields, per element, the
// table word at its address where the address's row lies in a 24-row
// window [base, base + 24), else 0.  The window base comes from
//   static: the loop counter (no handoff; the control),
//   ser:    the minimum over the whole tile of the sweep's row addresses,
//           h times in series (each address depends on the last sweep),
//   ind:    h such minima from the trip-entry tile, all reduced before
//           any sweep uses one.
// The minimum is this card's vector->scalar handoff: a block-wide
// minimum that every thread receives.  (ser - static) cycles / h is the
// cost of one handoff.  The `mid` work runs between a warp's posting of
// its partial minimum and the barrier, where it can fill the wait for
// the other warps.  Thread 0 reads clock64() around the trip loop (after
// a barrier at each end, so the slowest warp is included) and writes the
// cycle count.
//
// Design for this card.  The TPU kernel fetched a sweep's word with a
// 24-row ladder (broadcast a window row, gather its column, select where
// the row matches: 24 shared loads and selects an element), the only
// gather its vector unit had; on this card the ladder was the probe
// (3,316 of static:1's cycles a trip, PERF.md §6).  Here the sweep is
// one guarded shared-memory gather: an address is row * 128 + col, so
// the word's byte offset from the window's first row is 4 x the address
// - 512 x base, and the element takes the word where that offset, as an
// unsigned number, is below 24 rows' bytes.  A predicated load and a
// predicated xor (inline PTX) fetch and fold it; lanes outside the
// window load nothing.  The address's floor-mod by 256 * 128 = 2^15 is a
// mask (two's complement keeps the low 15 bits), taken on the byte
// offset in uint32 like the multiply-adds, which wrap in int32 (signed
// overflow is undefined in C++).  The static base is known before the
// address, so it folds into the address's multiply-add and the masked
// result is the offset itself; it is kept as the trip count mod 232, not
// recomputed by floor-mods.  `>>` is arithmetic in C++, jnp and torch
// alike.  The table (128 KiB) lives in dynamic shared memory, as it
// lived in VMEM; it is loaded outside the clock64() window.  One
// instance per mode; 256 threads x 16 elements.
//
// The handoff: each warp reduces its lanes' minima with
// __reduce_min_sync and lane 0 writes the warp's word; after
// __syncthreads() every thread reads the 8 partials with two broadcast
// 16-byte loads and takes their minimum.  Two buffers, so one barrier a
// handoff suffices.  Measured against it and not shipped (PERF.md §6):
// the partials read back by __reduce_min_sync, an atomicMin word, 128 and
// 1024 threads.
//
// What bounds it on this card.  The program is one block, so its bound
// is one SM's issue: app/stallbench.py `stall_work` counts the lane
// operations the probe needs at the least, 7 an element and trip for
// static:1 and 8.5 for ser:1 (224 and 272 cycles a trip at 128 lanes a
// clock); the gathers (at most one word an element and sweep, 32 words
// a clock) never bind.  The sweep issues what that count holds (static:
// multiply-add, mask, compare, predicated load, predicated xor; ser and
// ind also subtract the base).  static:1 still takes 2.3-2.6x the count
// (PERF.md §6), latency with two warps a scheduler: each waits at every
// sweep's head for the base's uniform arithmetic and the shared window's
// base (ptxas reads SR_CgaCtaId again every sweep), and a predicated xor
// holds its predicate until its word arrives, 7 predicates for 16 loads
// in flight.  The earlier form, a zeroed load and a plain xor (which
// free it at once), measured 4% faster at static:1 but 14-21% slower at
// static:2 and 4 and 3-7% slower in ser and ind.  The `ser` modes are latency-bound by design:
// what ser:1 takes beyond static:1 is the handoff the probe exists to
// measure.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32, COLS = 128, TILE = ROWS * COLS;
constexpr int THREADS = 256, PER = TILE / THREADS, WARPS = THREADS / 32;
constexpr int WIN = 24;       // rows per serve window
constexpr int M_ROWS = 256;   // serve-table rows
constexpr int MAX_H = 8;      // sweeps per trip the kernel accepts
constexpr uint32_t BYTE_MASK = (M_ROWS * COLS - 1) << 2;  // floor-mod by 2^15, x 4
constexpr uint32_t ROW_BYTES = COLS * 4;
constexpr uint32_t WIN_BYTES = WIN * ROW_BYTES;
constexpr uint32_t A = 1103515245u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RED_WORDS = 2 * MAX_H * WARPS;
constexpr size_t SMEM_BYTES = (size_t)(M_ROWS * COLS + RED_WORDS) * sizeof(int);

enum Mode { STATIC = 0, SER = 1, IND = 2 };

// v * a + c wrapped to int32
__device__ __forceinline__ int madd(int v, uint32_t a, int c) {
    return (int)((uint32_t)v * a + (uint32_t)c);
}

// the dependent chain: n plane-ops, not foldable
__device__ __forceinline__ void vchain(int (&y)[PER], int n, int salt) {
    for (int i = 0; i < n; ++i) {
        const int c = 12345 + 97 * salt + i;
#pragma unroll
        for (int j = 0; j < PER; ++j) y[j] = madd(y[j], A, c);
    }
}

// A sweep address ((x >> 1) + 131 c) % 2^15 (ser, static) or ((x >> 1) *
// (2 c + 1) + 131 c) % 2^15 (ind), as the byte offset of its word in the
// table, 4 x the address, less `sub` (a multiple of 4) mod 2^17: (x >> 1)
// * 4 is x * 2 with its low two bits cleared, which the mask clears too.
__device__ __forceinline__ uint32_t addr_bytes(int x, int c, uint32_t sub = 0) {
    return ((uint32_t)x * 2u + (524u * c - sub)) & BYTE_MASK;
}

__device__ __forceinline__ uint32_t ind_addr_bytes(int x, int c) {
    return ((uint32_t)(x >> 1) * (8u * c + 4u) + 524u * c) & BYTE_MASK;
}

// v ^= the word at shared address `addr` where `off` (the word's byte
// offset from the window's first row, unsigned) < WIN_BYTES, else v: a
// predicated load and a predicated xor.  "memory": the load reads the
// table the block stored before the barrier that ends its fill, so it
// stays after that barrier.
__device__ __forceinline__ void sweep_xor(int& v, uint32_t off, uint32_t addr) {
    asm volatile("{\n\t.reg .pred p;\n\t.reg .b32 w;\n\t"
                 "setp.lt.u32 p, %1, %2;\n\t"
                 "@p ld.shared.b32 w, [%3];\n\t"
                 "@p xor.b32 %0, %0, w;\n\t}"
                 : "+r"(v)
                 : "r"(off), "n"(WIN_BYTES), "r"(addr)
                 : "memory");
}

// the window's first row as a byte offset
__device__ __forceinline__ uint32_t base_bytes(int r_min) {
    return (uint32_t)min(max(r_min, 0), M_ROWS - WIN) * ROW_BYTES;
}

// The block-wide minimum every thread receives: post(c, v) before the
// barrier, take(c) after it, next() once this handoff's minima are taken.
struct Handoff {
    int* words;  // two buffers of MAX_H x WARPS partials
    int slot;

    __device__ void post(int c, int v) {
        v = __reduce_min_sync(FULL, v);
        if ((threadIdx.x & 31) == 0)
            words[(slot * MAX_H + c) * WARPS + (threadIdx.x >> 5)] = v;
    }
    __device__ int take(int c) const {
        // every thread reads the WARPS partials, 16 bytes a load
        const int4* p =
            reinterpret_cast<const int4*>(words + (slot * MAX_H + c) * WARPS);
        int m = INT_MAX;
#pragma unroll
        for (int i = 0; i < WARPS / 4; ++i) {
            const int4 v = p[i];
            m = min(m, min(min(v.x, v.y), min(v.z, v.w)));
        }
        return m;
    }
    __device__ void next() { slot ^= 1; }
};

// the smallest row of the thread's addresses
__device__ __forceinline__ int row_min(const uint32_t (&bytes)[PER]) {
    uint32_t m = bytes[0];
#pragma unroll
    for (int j = 1; j < PER; ++j) m = min(m, bytes[j]);
    return (int)(m >> 9);
}

// one instance per mode
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) stall_kernel(
    const int* __restrict__ tab_g, const int* __restrict__ x_g, int trips,
    int h, int pre, int mid, int* __restrict__ out,
    long long* __restrict__ cycles) {
    extern __shared__ __align__(16) int smem[];
    int* tab = smem;
    const int4* src = reinterpret_cast<const int4*>(tab_g);
    int4* dst = reinterpret_cast<int4*>(tab);
#pragma unroll 4
    for (int i = threadIdx.x; i < M_ROWS * COLS / 4; i += THREADS) dst[i] = src[i];
    const uint32_t tab_s = (uint32_t)__cvta_generic_to_shared(tab);
    Handoff hand{smem + M_ROWS * COLS, 0};
    for (int i = threadIdx.x; i < RED_WORDS; i += THREADS) hand.words[i] = INT_MAX;
    int x[PER], y[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
        x[j] = x_g[threadIdx.x + j * THREADS];
        y[j] = x[j] ^ 0x5A5A5A5A;
    }
    uint32_t k_mod = 0;  // the trip count mod 232: the static bases
    __syncthreads();
    const long long t0 = clock64();
    for (int k = 0; k < trips; ++k) {
        // independent in-flight work ahead of the reduce
        vchain(y, pre, 1);
        if constexpr (MODE == IND) {
            // all h minima from the trip-entry tile, one barrier
            for (int c = 0; c < h; ++c) {
                uint32_t bytes[PER];
#pragma unroll
                for (int j = 0; j < PER; ++j) bytes[j] = ind_addr_bytes(x[j], c);
                hand.post(c, row_min(bytes));
            }
            vchain(y, mid, 2);
            __syncthreads();
            int acc[PER] = {};
            for (int c = 0; c < h; ++c) {
                const uint32_t base = base_bytes(hand.take(c));
#pragma unroll
                for (int j = 0; j < PER; ++j) {
                    const uint32_t b = ind_addr_bytes(x[j], c);
                    sweep_xor(acc[j], b - base, tab_s + b);
                }
            }
            hand.next();
#pragma unroll
            for (int j = 0; j < PER; ++j) x[j] ^= acc[j];
        } else if constexpr (MODE == SER) {
            for (int c = 0; c < h; ++c) {
                // chain c's address depends on chain c-1's word
                uint32_t bytes[PER];
#pragma unroll
                for (int j = 0; j < PER; ++j) bytes[j] = addr_bytes(x[j], c);
                hand.post(0, row_min(bytes));
                vchain(y, mid, 2 + c);
                __syncthreads();
                const uint32_t base = base_bytes(hand.take(0));
                hand.next();
#pragma unroll
                for (int j = 0; j < PER; ++j)
                    sweep_xor(x[j], bytes[j] - base, tab_s + bytes[j]);
            }
        } else {
            for (int c = 0; c < h; ++c) {
                // (k * (7 + 6 c)) % 232, k >= 0
                const uint32_t base =
                    k_mod * (7u + 6u * c) % (M_ROWS - WIN) * ROW_BYTES;
                vchain(y, mid, 2 + c);
                const uint32_t win = tab_s + base;
#pragma unroll
                for (int j = 0; j < PER; ++j) {
                    const uint32_t off = addr_bytes(x[j], c, base);
                    sweep_xor(x[j], off, win + off);
                }
            }
            k_mod = k_mod == M_ROWS - WIN - 1 ? 0 : k_mod + 1;
        }
        // fold y back so the chain stays on the next trip's critical path
#pragma unroll
        for (int j = 0; j < PER; ++j) x[j] ^= (y[j] >> 16);
    }
    __syncthreads();
    const long long t1 = clock64();
#pragma unroll
    for (int j = 0; j < PER; ++j)
        out[threadIdx.x + j * THREADS] = (int)((uint32_t)x[j] + (uint32_t)y[j]);
    if (threadIdx.x == 0) *cycles = t1 - t0;
}

template <int MODE>
cudaError_t launch(const int* tab, const int* x, int trips, int h, int pre,
                   int mid, int* out, long long* cycles, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        stall_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    stall_kernel<MODE><<<1, THREADS, SMEM_BYTES, stream>>>(
        tab, x, trips, h, pre, mid, out, cycles);
    return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; the host wrapper validates mode and h, and that
// the table is contiguous and 16-byte aligned.
extern "C" int vt_stall_launch(const int* tab, const int* x, int trips,
                               int mode, int h, int pre, int mid, int* out,
                               long long* cycles, void* stream) {
    if (h < 1 || h > MAX_H) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case STATIC: return launch<STATIC>(tab, x, trips, h, pre, mid, out, cycles, s);
        case SER: return launch<SER>(tab, x, trips, h, pre, mid, out, cycles, s);
        case IND: return launch<IND>(tab, x, trips, h, pre, mid, out, cycles, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
