// The CSR5 tile algorithm of K1, shared by K1 and K1p (csr5_spmv.cu) and
// K3 (csr5_sliced.cu): one (sigma, 128) tile per 128-thread block, one
// thread per lane.
//
//   1. each lane forms its sigma products in float32 and keeps their
//      inclusive within-lane prefix in shared memory (sigma * 128 * 4 B):
//      tile_products (raw int32 columns; K3's, while K1 forms the same
//      products in groups of rows loaded a group ahead,
//      csr5_spmv.cu::tile_products_grouped) or tile_products_packed (the
//      uint16 column codes of col_packed);
//   2. lane_carry: the 128 lane totals get an exclusive scan (warp shuffles
//      plus one combine through shared memory): carry[l];
//   3. window_pass: for every window slot d < capw, win_map[t, d] names the
//      in-tile position (sub | lane << 16, flag bits 23/24 masked off) of
//      the last element of the slot's row, so W_end[d] = carry[lane] +
//      prefix[sub][lane] is the tile prefix at that row's end, and the row's
//      partial sum is W_end[d] - W_end[d-1] under the wrapped or aligned
//      rules of ops/csr5_spmv.py::csr5_spmv_torch; it is added to y[row]
//      with atomicAdd.
//
// The planes are read through the read-only path (ld.global.nc): K3 reaches
// them through pointers held in a table, which the compiler cannot otherwise
// tell from shared memory, and it would then order every load after the
// previous prefix store. Where each load sits in the caches is a template
// parameter of steps 1 and 3: PlainLoads (K3) reads everything with __ldg;
// ResidentLoads (K1, K1p) streams the planes past L1 and first out of L2,
// and gathers x with an L2 evict-last policy on a share of its lines.
//
// grant_smem, the one-time grant of dynamic shared memory past 48 KB, serves
// every CSR5 kernel (K1, K1p, K2, K2p, K3, K4).
//
// __fmul_rn/__fadd_rn keep each product rounded on its own, as the plain
// version does (no fused multiply-add), and the prefix runs in s order in
// both column modes, so K1p's y is bit-equal to K1's on the same tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace csr5 {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
// bits 0-15 of a win_map word: the sub-row; bits 16-22: the lane
constexpr int kSubMask = 0xFFFF;
constexpr int kLaneMask = kLanes - 1;
// a packed code: lane in bits 0-6, the tile-local page in bits 7-15
constexpr uint32_t kPageMask = 0x1FF;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The column of a packed code: pages[local] * 128 + lane, where pages is
// the tile's row of the page plane. The list (at most 512 int32) is read
// through the read-only cache, where it stays after the first code that
// names each page; staging it in shared memory instead would hold every
// block at a barrier for one more round trip to device memory before its
// first product.
__device__ __forceinline__ int decode(uint32_t code, const int32_t* __restrict__ pages) {
    return __ldg(pages + ((code >> 7) & kPageMask)) * kLanes + (int)(code & kLaneMask);
}

// Loads of the planes (column or packed codes, values, window maps, tile
// pointers) and gathers of x through the read-only cache at normal priority.
struct PlainLoads {
    template <typename T>
    __device__ __forceinline__ T plane(const T* p) const { return __ldg(p); }
    __device__ __forceinline__ float gather(const float* p) const { return __ldg(p); }
};

// The planes are read once per product: they skip L1
// (ld.global.nc.L1::no_allocate) and enter L2 under an evict-first policy,
// so that streaming them evicts neither the x lines in L1 nor those in L2.
// x's gathers keep L1 and take an evict-last policy on the given share of
// x's lines (createpolicy.fractional; the rest evict_unchanged); the
// wrapper sizes the share to the persisting set-aside it grants, the only
// part of L2 where the card honours evict-last (ops/csr5_kernel.py
// ::resident_share). At share 0 the gathers take evict_normal, which is
// what a plain load gets.
struct ResidentLoads {
    uint64_t streamed;  // the planes' policy
    uint64_t held;      // x's policy
    __device__ __forceinline__ explicit ResidentLoads(float share) {
        asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(streamed));
        if (share > 0.f)
            asm("createpolicy.fractional.L2::evict_last.b64 %0, %1;" : "=l"(held) : "f"(share));
        else
            asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(held));
    }
    __device__ __forceinline__ int32_t plane(const int32_t* p) const {
        int32_t v;
        asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
            : "=r"(v) : "l"(p), "l"(streamed));
        return v;
    }
    __device__ __forceinline__ float plane(const float* p) const {
        float v;
        asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
            : "=f"(v) : "l"(p), "l"(streamed));
        return v;
    }
    __device__ __forceinline__ __nv_bfloat16 plane(const __nv_bfloat16* p) const {
        unsigned short v;
        asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b16 %0, [%1], %2;"
            : "=h"(v) : "l"(p), "l"(streamed));
        return __ushort_as_bfloat16(v);
    }
    __device__ __forceinline__ float gather(const float* p) const {
        float v;
        asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(held));
        return v;
    }
};

// Step 1 on raw int32 columns. col and val point at the tile's
// (sigma, 128) planes; returns the lane's total.
template <typename V, typename Loads = PlainLoads>
__device__ __forceinline__ float tile_products(const int32_t* __restrict__ col,
                                               const V* __restrict__ val,
                                               const float* __restrict__ x, int sigma,
                                               int l, float* prefix,
                                               const Loads& ld = Loads()) {
    float run = 0.f;
    for (int s = 0; s < sigma; ++s) {
        const int e = s * kLanes + l;
        run = __fadd_rn(run, __fmul_rn(to_f32(ld.plane(val + e)), ld.gather(x + ld.plane(col + e))));
        prefix[e] = run;
    }
    return run;
}

// Step 1 on the packed column plane: colp points at the tile's (sigma/2,
// 128) int32 words, each holding the codes of rows s (low half) and
// s + sigma/2 (high half). One word feeds two products; the second half's
// products wait in their prefix rows until the first half's prefix is done,
// so the prefix still runs in s order. Each word is read once (2 B/nnz).
template <typename V, typename Loads = PlainLoads>
__device__ __forceinline__ float tile_products_packed(const int32_t* __restrict__ colp,
                                                      const V* __restrict__ val,
                                                      const int32_t* __restrict__ pages,
                                                      const float* __restrict__ x, int sigma,
                                                      int l, float* prefix,
                                                      const Loads& ld = Loads()) {
    const int h = sigma >> 1;
    float run = 0.f;
    for (int s = 0; s < h; ++s) {
        const int e = s * kLanes + l;
        const int e2 = e + h * kLanes;
        const uint32_t w = (uint32_t)ld.plane(colp + e);
        const float lo = __fmul_rn(to_f32(ld.plane(val + e)), ld.gather(x + decode(w & 0xFFFFu, pages)));
        const float hi = __fmul_rn(to_f32(ld.plane(val + e2)), ld.gather(x + decode(w >> 16, pages)));
        run = __fadd_rn(run, lo);
        prefix[e] = run;
        prefix[e2] = hi;
    }
    for (int s = h; s < sigma; ++s) {
        const int e = s * kLanes + l;
        run = __fadd_rn(run, prefix[e]);
        prefix[e] = run;
    }
    return run;
}

// Step 2: carry[l] = the sum of the totals of lanes 0..l-1. Synchronises
// the block twice; prefix and carry are readable by every thread after it.
__device__ __forceinline__ void lane_carry(float run, int l, float* warp_total, float* carry) {
    const int warp = l >> 5;
    const int wl = l & 31;
    float inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (wl >= o) inc += v;
    }
    if (wl == 31) warp_total[warp] = inc;
    __syncthreads();
    float before = 0.f;
    for (int w = 0; w < warp; ++w) before += warp_total[w];
    carry[l] = before + (inc - run);
    __syncthreads();
}

// Steps 3-4 for the tile whose first row is rs and whose window map is wm
// (capw slots). Why atomics: a row that straddles tiles receives partial
// sums from several blocks, which run in no order. Slots whose difference
// is zero (rows beyond the tile or the matrix, empty rows) add nothing.
template <typename Loads = PlainLoads>
__device__ __forceinline__ void window_pass(const int32_t* __restrict__ wm, int rs, int capw,
                                            int win_rel, const float* prefix,
                                            const float* carry, float* __restrict__ y, int l,
                                            const Loads& ld = Loads()) {
    const int a = rs & (kLanes - 1);  // slot of the tile's first row
    const int base = rs - a;          // 128-aligned row of slot 0
    auto w_end = [&](int32_t word) {
        const int sub = word & kSubMask;
        const int lane = (word >> 16) & kLaneMask;  // bits 23/24 are flags
        return carry[lane] + prefix[sub * kLanes + lane];
    };
    for (int d = l; d < capw; d += kLanes) {
        float w2;
        int row;
        if (win_rel) {
            // wrapped maps: slot d is row base+d for d >= a and row
            // base+capw+d for d < a; the wrap seam (slot capw-1 -> slot 0)
            // is consecutive rows, and only the first row starts at zero
            const float prev = d == a ? 0.f : w_end(ld.plane(wm + (d == 0 ? capw - 1 : d - 1)));
            w2 = w_end(ld.plane(wm + d)) - prev;
            row = base + d + (d < a ? capw : 0);
        } else {
            // aligned maps: slots before the tile's first row are masked
            if (d < a) continue;
            const float prev = d - 1 >= a ? w_end(ld.plane(wm + d - 1)) : 0.f;
            w2 = w_end(ld.plane(wm + d)) - prev;
            row = base + d;
        }
        if (w2 != 0.f) atomicAdd(y + row, w2);
    }
}

// Lets Kernel take as much dynamic shared memory as a block of this device
// can have beside its static shared memory. A launch above 48 KB needs it;
// it is set once per kernel and device, not on every launch.
template <auto Kernel>
cudaError_t grant_smem(size_t need) {
    constexpr int kMaxDevices = 64;
    static std::atomic<unsigned long long> granted{0};
    if (need <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < kMaxDevices ? 1ull << dev : 0ull;
    if (bit && (granted.load() & bit)) return cudaSuccess;
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, Kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    granted.fetch_or(bit);
    return cudaSuccess;
}

}  // namespace csr5
