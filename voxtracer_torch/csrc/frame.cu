// A viewer frame's device work in one host call: the counters' memset and
// the 2-4 kernel launches of engine/pipeline.py `frame_stages`, on one
// stream, with the parameters of one host row.
//
// Replaces no Pallas kernel and adds no kernel.  `Renderer.render` on the
// card used to reach each frame kernel through its Python wrapper, which
// checked its inputs, allocated its outputs and made a ctypes call of
// 15-21 arguments: some 300-400 us of host time a frame on the H100
// machine's host against 0.3 ms of device work at menger 1280x720 r=0,
// so the card waited for the host (PERF.md §5).  engine/direct.py checks
// all of that once per configuration (a frame plan), allocates one arena
// a frame and calls `vt_frame_launch` here, which calls the kernels'
// own by-value entries (vt_trace_launch, vt_still_epilogue_launch,
// vt_temporal_launch, vt_denoise_launch, vt_encode_launch) with the
// arguments their wrappers pass: the same instances on the same inputs,
// so the outputs are bit-equal to the eager frame's.
//
// The plan is an int64 block (`Slot`; engine/direct.py SLOTS in the same
// order): host pointers to the frame row and the geometry block, the
// tables' and noise's device pointers, sizes, the row's slice offsets,
// the denoise launch (ops/denoise.py tile_plan, its factor_dist table,
// `range_reciprocal`'s reciprocal as float32 bits and its corrections) and
// each output's byte offset in the arena.  The caller packs the row
// before each call; every entry copies its slice into the launch, so the
// row may change once the call has returned.  The kernels follow from
// `reproject` and the plan's radius, as frame_stages picks them
// (engine/direct.py frame_launches states the same set in Python).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

extern "C" int vt_trace_launch(
    const float* params_host, const float* row, const int* geometry_host,
    const int* packed, const int* meta, const int* brick, const int* palette,
    const float* noise, int n_slices, int frame, int height, int width,
    int row0, int row_stride, float* color, float* normal, float* albedo,
    float* depth, int* node, unsigned long long* counters, void* stream);
extern "C" int vt_temporal_launch(
    const float* params_host, const float* row, const float* color,
    const float* normal, const float* depth, const float* old_color,
    const float* old_blend, const float* old_depth, int height, int width,
    int row0, int img_height, float* blended, float* next_blend,
    void* stream);
extern "C" int vt_denoise_launch(
    const float* params_host, const float* fdist_host, const float* row,
    const float* colors, const float* normal, const float* depth,
    const float* albedo, const int* node, int height, int width, int row0,
    int radius, int instance, int block_x, int block_y, int rows_per_thread,
    int grid_x, int grid_y, int shared, float recip, int steps, float* out,
    void* stream);
extern "C" int vt_still_epilogue_launch(
    const float* params_host, const float* row, const float* color,
    const float* normal, const float* depth, float* old_color,
    float* old_blend, float* old_depth, const float* albedo, int height,
    int width, int row0, float* blended, float* next_blend, float* linear,
    uint8_t* image, const int64_t* slot, int n_images, int in_place,
    void* stream);
extern "C" int vt_encode_launch(
    const float* params_host, const float* row, const float* src,
    const float* albedo, int in_h, int in_w, int height, int width,
    float* linear, uint8_t* image, const int64_t* slot, int n_images,
    void* stream);

namespace {

enum Slot {
    ROW, GEOMETRY, PACKED, META, BRICK, PALETTE, NOISE, N_SLICES, HEIGHT,
    WIDTH, RADIUS, DEVICE, ROW_TRACE, ROW_FRAME, ROW_TEMPORAL, ROW_DENOISE,
    ROW_EPILOGUE, FDIST, DN_INSTANCE, DN_BLOCK_X, DN_BLOCK_Y, DN_ROWS,
    DN_GRID_X, DN_GRID_Y, DN_SHARED, DN_RECIP, DN_STEPS, AT_COLOR, AT_NORMAL,
    AT_ALBEDO, AT_DEPTH, AT_NODE, AT_COUNTERS, AT_BLENDED, AT_NEXT_BLEND,
    AT_IMAGE, AT_LINEAR, COUNTER_BYTES, N_SLOTS
};

template <typename T>
T* at(void* arena, int64_t offset) {
    return reinterpret_cast<T*>(static_cast<char*>(arena) + offset);
}

template <typename T>
T ptr(const int64_t* plan, int slot) {
    return reinterpret_cast<T>(static_cast<intptr_t>(plan[slot]));
}

// frame_stages' kernels: the trace; the still epilogue (which at radius 0
// also modulates and encodes) or, where a moved camera meets live history,
// the temporal kernel; at radius >= 1 the denoise; the encode unless the
// still epilogue did it
int frame(const int64_t* plan, void* arena, float* old_color,
          float* old_blend, float* old_depth, bool reproject,
          bool keep_linear, void* stream) {
    const int h = static_cast<int>(plan[HEIGHT]);
    const int w = static_cast<int>(plan[WIDTH]);
    const int radius = static_cast<int>(plan[RADIUS]);
    const int n_slices = static_cast<int>(plan[N_SLICES]);
    const float* row = ptr<const float*>(plan, ROW);
    // the frame number's int32 bit pattern; the noise slice as Python's %
    int32_t number;
    memcpy(&number, row + plan[ROW_FRAME], sizeof(number));
    int slice = number % n_slices;
    if (slice < 0) slice += n_slices;

    float* color = at<float>(arena, plan[AT_COLOR]);
    float* normal = at<float>(arena, plan[AT_NORMAL]);
    float* albedo = at<float>(arena, plan[AT_ALBEDO]);
    float* depth = at<float>(arena, plan[AT_DEPTH]);
    int* node = at<int>(arena, plan[AT_NODE]);
    auto* counters = at<unsigned long long>(arena, plan[AT_COUNTERS]);
    float* blended = at<float>(arena, plan[AT_BLENDED]);
    float* next_blend = at<float>(arena, plan[AT_NEXT_BLEND]);
    uint8_t* image = at<uint8_t>(arena, plan[AT_IMAGE]);
    // the denoise kernel's output, or at radius 0 the modulated linear
    float* linear = radius || keep_linear ? at<float>(arena, plan[AT_LINEAR])
                                          : nullptr;
    // radius 0: the modulate rides the still epilogue or the encode
    const float* modulate = radius ? nullptr : albedo;
    float* linear_out = radius ? nullptr : linear;
    const float* epilogue = row + plan[ROW_EPILOGUE];
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    cudaError_t err =
        cudaMemsetAsync(counters, 0, static_cast<size_t>(plan[COUNTER_BYTES]),
                        s);
    if (err != cudaSuccess) return static_cast<int>(err);
    int rc = vt_trace_launch(
        row + plan[ROW_TRACE], nullptr, ptr<const int*>(plan, GEOMETRY),
        ptr<const int*>(plan, PACKED), ptr<const int*>(plan, META),
        ptr<const int*>(plan, BRICK), ptr<const int*>(plan, PALETTE),
        ptr<const float*>(plan, NOISE), n_slices, slice, h, w, 0, 1, color,
        normal, albedo, depth, node, counters, stream);
    if (rc) return rc;
    if (!reproject) {
        rc = vt_still_epilogue_launch(
            epilogue, nullptr, color, normal, depth, old_color, old_blend,
            old_depth, modulate, h, w, 0, blended, next_blend, linear_out,
            radius ? nullptr : image, nullptr, radius ? 0 : 1, 0, stream);
    } else {
        rc = vt_temporal_launch(row + plan[ROW_TEMPORAL], nullptr, color,
                                normal, depth, old_color, old_blend,
                                old_depth, h, w, 0, h, blended, next_blend,
                                stream);
    }
    if (rc) return rc;
    const float* src = blended;
    if (radius) {
        const uint32_t recip_bits = static_cast<uint32_t>(plan[DN_RECIP]);
        float recip;
        memcpy(&recip, &recip_bits, sizeof(recip));
        rc = vt_denoise_launch(
            row + plan[ROW_DENOISE], ptr<const float*>(plan, FDIST), nullptr,
            blended, normal, depth, albedo, node, h, w, 0, radius,
            static_cast<int>(plan[DN_INSTANCE]),
            static_cast<int>(plan[DN_BLOCK_X]),
            static_cast<int>(plan[DN_BLOCK_Y]),
            static_cast<int>(plan[DN_ROWS]),
            static_cast<int>(plan[DN_GRID_X]),
            static_cast<int>(plan[DN_GRID_Y]),
            static_cast<int>(plan[DN_SHARED]), recip,
            static_cast<int>(plan[DN_STEPS]), linear, stream);
        if (rc) return rc;
        src = linear;
    }
    if (radius || reproject) {
        rc = vt_encode_launch(modulate ? epilogue : nullptr, nullptr, src,
                              modulate, h, w, h, w, linear_out, image,
                              nullptr, 1, stream);
    }
    return rc;
}

}  // namespace

// One viewer frame on `stream`, on the plan's device: its outputs in the
// fresh `arena` (at the plan's offsets), the history read from the three
// planes given; `reproject` (0 or 1) where a moved camera meets live
// history.  Returns 0 or the first CUDA error; on an error the launches
// before it stay enqueued.
extern "C" int vt_frame_launch(const int64_t* plan, void* arena,
                               float* old_color, float* old_blend,
                               float* old_depth, int reproject,
                               int keep_linear, void* stream) {
    if ((reproject != 0 && reproject != 1) || plan[RADIUS] < 0 || !arena)
        return static_cast<int>(cudaErrorInvalidValue);
    const int device = static_cast<int>(plan[DEVICE]);
    int previous;
    cudaError_t err = cudaGetDevice(&previous);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess)
        return static_cast<int>(err);
    int rc = frame(plan, arena, old_color, old_blend, old_depth,
                   reproject != 0, keep_linear != 0, stream);
    if (previous != device) {
        err = cudaSetDevice(previous);
        if (!rc) rc = static_cast<int>(err);
    }
    return rc;
}

// The number of plan slots this build reads, for the caller's check.
extern "C" int vt_frame_slots() { return N_SLOTS; }
