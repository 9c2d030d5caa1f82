// Row ends of a CSR5 tile and the streaming plane load, shared by K2/K2p
// (csr5_spmm.cu) and K4 (csr5_spmv_f64.cu).
//
// The window pass of a (sigma, 128) tile reads the tile prefix only at the
// positions win_map names: the last element of each window slot's row,
// nends <= min(capw, sigma * 128) distinct positions. A kernel therefore
// keeps its lane's running sums only there, numbered in element order
// (lane-major, then s), instead of the whole (sigma, 128) prefix. Two small
// planes describe the numbering, with nw = ceil(sigma / 32) words per lane:
//
//   mask[w * 128 + l], bit b   position (32 w + b, l) is a row end;
//   wbase[w * 128 + l]         the number of row ends before word w of lane
//                              l, the ends of lanes 0..l-1 included (uint16:
//                              the wrappers keep sigma * 128 < 65536).
//
// A thread walking its lane in s order numbers its ends on from the value
// mark_row_ends returns; end_index gives any position's number. The planes
// take nw * 128 * 6 B (768 B at sigma <= 32), where a uint16 id per element
// took sigma * 128 * 2 B (6 KB at sigma = 24).

#pragma once

#include "csr5_tile.cuh"

namespace csr5 {

// 32-bit words of the row-end mask per lane
__host__ __device__ constexpr int end_words(int sigma) { return (sigma + 31) >> 5; }

// bytes of the mask and wbase planes of a (sigma, 128) tile
inline size_t row_end_bytes(int sigma) {
    return (size_t)end_words(sigma) * kLanes * (sizeof(uint32_t) + sizeof(uint16_t));
}

// the lane of a win_map word (flag bits 23/24 off)
__device__ __forceinline__ int lane_of(int32_t word) { return (word >> 16) & kLaneMask; }

// Marks the row ends the slots of win_map row wm name (aligned maps: only
// slots d >= a are used) and numbers them; returns the number of the first
// row end of lane l. warp_count is (kWarps,) int scratch. Synchronises the
// block three times: shared memory written before the call is readable by
// every thread after it. mask and wbase are readable after the next barrier.
__device__ __forceinline__ int mark_row_ends(const int32_t* __restrict__ wm, int capw, int a,
                                             int win_rel, int sigma, uint32_t* mask,
                                             uint16_t* wbase, int* warp_count, int l) {
    const int nw = end_words(sigma);
    for (int w = 0; w < nw; ++w) mask[w * kLanes + l] = 0u;
    __syncthreads();
    for (int d = l; d < capw; d += kLanes) {
        if (win_rel || d >= a) {
            const int32_t word = __ldg(wm + d);
            const int sub = word & kSubMask;
            atomicOr(mask + (sub >> 5) * kLanes + lane_of(word), 1u << (sub & 31));
        }
    }
    __syncthreads();
    int cnt = 0;
    for (int w = 0; w < nw; ++w) cnt += __popc(mask[w * kLanes + l]);
    const int warp = l >> 5;
    const int wl = l & 31;
    int inc = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (wl >= o) inc += v;
    }
    if (wl == 31) warp_count[warp] = inc;
    __syncthreads();
    int first = inc - cnt;
    for (int w = 0; w < warp; ++w) first += warp_count[w];
    int run = first;
    for (int w = 0; w < nw; ++w) {
        wbase[w * kLanes + l] = (uint16_t)run;
        run += __popc(mask[w * kLanes + l]);
    }
    return first;
}

// A load of a plane element that is read once: through the read-only path
// without a line in L1 (ld.global.nc.L1::no_allocate), so that streaming
// the planes does not evict the x (or X) lines the gathers reuse from L1.
// L2 keeps its normal policy.
__device__ __forceinline__ int32_t ld_stream(const int32_t* p) {
    int32_t v;
    asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
    float v;
    asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ double ld_stream(const double* p) {
    double v;
    asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ __nv_bfloat16 ld_stream(const __nv_bfloat16* p) {
    unsigned short v;
    asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
    return __ushort_as_bfloat16(v);
}

// True when element s of the calling thread's lane l is a row end.
__device__ __forceinline__ bool is_end(const uint32_t* mask, int s, int l) {
    return (mask[(s >> 5) * kLanes + l] >> (s & 31)) & 1u;
}

// The number of the row end at the in-tile position of win_map word `word`.
__device__ __forceinline__ int end_index(int32_t word, const uint32_t* mask,
                                         const uint16_t* wbase) {
    const int sub = word & kSubMask;
    const int i = (sub >> 5) * kLanes + lane_of(word);
    return wbase[i] + __popc(mask[i] & ((1u << (sub & 31)) - 1u));
}

}  // namespace csr5
