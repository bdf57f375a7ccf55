// Handoff-stall microbenchmark kernel for NVIDIA Hopper (sm_90a): one
// block computes the one (32, 128) int32 program of the TPU kernel.
//
// Replaces voxtracer/app/stallbench.py `_make_kernel` (launched by
// `run_case`), the Pallas TPU kernel.  It is a per-thread transcription
// of voxtracer_torch/app/stallbench.py `run_plain`, which the CPU tests
// hold against the interpreted Pallas kernel; both give the same int32
// words.
//
// What it measures.  Each trip runs dependent integer multiply-add
// chains (`pre` ops ahead of the reduce, `mid` ops between the reduce and
// its use), then `h` serve sweeps: a 24-row compare/select walk over a
// window of the 256 x 128 table.  The window base comes from
//   static: the loop counter (no handoff; the control),
//   ser:    the minimum over the whole tile of the sweep's row addresses,
//           h times in series (each address depends on the last sweep),
//   ind:    h such minima from the trip-entry tile, all reduced before
//           any sweep uses one.
// The minimum is this card's vector->scalar handoff: a warp reduction
// (__reduce_min_sync), a shared-memory combine of the 32 warps and a
// __syncthreads().  (ser - static) cycles / h is the cost of one handoff.
// The `mid` work runs between a warp's posting of its partial minimum
// and the barrier, where it can fill the wait for the other warps.
// Thread 0 reads clock64() around the trip loop (after a barrier at each
// end, so the slowest warp is included) and writes the cycle count.
//
// Design.  1024 threads, 4 tile elements each (element t + 1024 j); the
// table (128 KiB) lives in dynamic shared memory, as it lived in VMEM;
// the partial minima are double-buffered so one barrier per reduction
// suffices.  Integer traps of the transcription: the multiply-adds wrap
// in int32, so they run in uint32 (signed overflow is undefined in C++);
// jnp's and torch's `%` are floor-mod while C's truncates, so
// floor_mod() corrects it; `>>` is arithmetic in all three.
//
// What bounds it: one SM.  It is a latency probe, not a throughput
// kernel: the chains are bound by instruction throughput and the sweeps
// by shared-memory loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32, COLS = 128, TILE = ROWS * COLS;
constexpr int THREADS = 1024, PER = TILE / THREADS, WARPS = THREADS / 32;
constexpr int WIN = 24;       // rows per serve window
constexpr int M_ROWS = 256;   // serve-table rows
constexpr int MAX_H = 8;      // sweeps per trip the kernel accepts
constexpr uint32_t A = 1103515245u;
constexpr int RED_WORDS = 2 * MAX_H * WARPS;
constexpr size_t SMEM_BYTES = (size_t)(M_ROWS * COLS + RED_WORDS) * sizeof(int);

enum Mode { STATIC = 0, SER = 1, IND = 2 };

// v * a + c wrapped to int32
__device__ __forceinline__ int madd(int v, uint32_t a, int c) {
    return (int)((uint32_t)v * a + (uint32_t)c);
}

// floor-mod, as jnp's and torch's `%` (m > 0)
__device__ __forceinline__ int floor_mod(int a, int m) {
    return ((a % m) + m) % m;
}

// the dependent chain: n plane-ops, not foldable
__device__ __forceinline__ void vchain(int (&y)[PER], int n, int salt) {
    for (int i = 0; i < n; ++i) {
        const int c = 12345 + 97 * salt + i;
#pragma unroll
        for (int j = 0; j < PER; ++j) y[j] = madd(y[j], A, c);
    }
}

// the serve sweep: tab[waddr >> 7, waddr & 127] where the row lies in
// [base, base + WIN), else 0, by a WIN-row compare/select walk
__device__ __forceinline__ int sweep(const int* tab, int waddr, int base) {
    const int off = (waddr >> 7) - base;
    const int col = waddr & (COLS - 1);
    int word = 0;
#pragma unroll
    for (int s = 0; s < WIN; ++s) {
        const int g = tab[(base + s) * COLS + col];
        word = (off == s) ? g : word;
    }
    return word;
}

__device__ __forceinline__ int clamp_base(int r_min) {
    return min(max(r_min, 0), M_ROWS - WIN);
}

// the block-wide minimum of the lanes' partial minima from the buffer
// the warps wrote before the last barrier
__device__ __forceinline__ int combine(const int* red) {
    return __reduce_min_sync(0xffffffffu, red[threadIdx.x & 31]);
}

__device__ __forceinline__ void post(int* red, int v) {
    v = __reduce_min_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
}

__device__ __forceinline__ int row_min(const int (&waddr)[PER]) {
    int m = waddr[0] >> 7;
#pragma unroll
    for (int j = 1; j < PER; ++j) m = min(m, waddr[j] >> 7);
    return m;
}

__global__ void __launch_bounds__(THREADS, 1) stall_kernel(
    const int* __restrict__ tab_g, const int* __restrict__ x_g, int trips,
    int mode, int h, int pre, int mid, int* __restrict__ out,
    long long* __restrict__ cycles) {
    extern __shared__ int smem[];
    int* tab = smem;
    int* red = smem + M_ROWS * COLS;  // [2][MAX_H][WARPS]
    for (int i = threadIdx.x; i < M_ROWS * COLS; i += THREADS) tab[i] = tab_g[i];
    int x[PER], y[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
        x[j] = x_g[threadIdx.x + j * THREADS];
        y[j] = x[j] ^ 0x5A5A5A5A;
    }
    __syncthreads();
    const long long t0 = clock64();
    int parity = 0;
    for (int k = 0; k < trips; ++k) {
        // independent in-flight work ahead of the reduce
        vchain(y, pre, 1);
        if (mode == IND) {
            // all h minima from the trip-entry tile, one barrier
            int* buf = red + parity * MAX_H * WARPS;
            parity ^= 1;
            int waddr[PER];
            for (int c = 0; c < h; ++c) {
#pragma unroll
                for (int j = 0; j < PER; ++j)
                    waddr[j] = floor_mod(madd(x[j] >> 1, 2 * c + 1, 131 * c),
                                         M_ROWS * COLS);
                post(buf + c * WARPS, row_min(waddr));
            }
            vchain(y, mid, 2);
            __syncthreads();
            int acc[PER] = {};
            for (int c = 0; c < h; ++c) {
                const int base = clamp_base(combine(buf + c * WARPS));
#pragma unroll
                for (int j = 0; j < PER; ++j) {
                    const int wa = floor_mod(madd(x[j] >> 1, 2 * c + 1, 131 * c),
                                             M_ROWS * COLS);
                    acc[j] ^= sweep(tab, wa, base);
                }
            }
#pragma unroll
            for (int j = 0; j < PER; ++j) x[j] ^= acc[j];
        } else {
            for (int c = 0; c < h; ++c) {
                int waddr[PER];
#pragma unroll
                for (int j = 0; j < PER; ++j)
                    waddr[j] = floor_mod((x[j] >> 1) + 131 * c, M_ROWS * COLS);
                int base;
                if (mode == SER) {
                    // chain c's address depends on chain c-1's word
                    int* buf = red + parity * MAX_H * WARPS;
                    parity ^= 1;
                    post(buf, row_min(waddr));
                    vchain(y, mid, 2 + c);
                    __syncthreads();
                    base = clamp_base(combine(buf));
                } else {
                    base = floor_mod(k * (7 + 6 * c), M_ROWS - WIN);
                    vchain(y, mid, 2 + c);
                }
#pragma unroll
                for (int j = 0; j < PER; ++j) x[j] ^= sweep(tab, waddr[j], base);
            }
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

}  // namespace

// Returns a cudaError_t; the host wrapper validates mode and h.
extern "C" int vt_stall_launch(const int* tab, const int* x, int trips,
                               int mode, int h, int pre, int mid, int* out,
                               long long* cycles, void* stream) {
    if (h < 1 || h > MAX_H) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        stall_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    stall_kernel<<<1, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        tab, x, trips, mode, h, pre, mid, out, cycles);
    return static_cast<int>(cudaGetLastError());
}
