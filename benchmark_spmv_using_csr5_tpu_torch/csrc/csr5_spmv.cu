// K1 for Hopper (sm_90a): CSR5 SpMV, y += A @ x, one (sigma, 128) tile per
// block, one thread per lane.
//
// Replaces the TPU kernel benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py
// ::_spmv_kernel at R=1 (with its _pass2_scalar window pass), built by
// _make_pallas_call and called by _csr5_spmv_pallas_jit.
//
// What bounds it: HBM bytes. Every nonzero is streamed once, as a 4 B int32
// column and a 4 B float32 or 2 B bfloat16 value (6 B/nnz with bf16 values),
// and is used for two flops. Thread l of a block reads col[t, s, l] and
// val[t, s, l] for s = 0..sigma-1, so each warp reads 128 B (i32) or 64 B
// (bf16) contiguous segments: the (p, sigma, 128) planes are already laid
// out for coalesced loads. x is gathered through the read-only cache; on
// banded matrices neighbouring lanes hit the same lines.
//
// Per tile:
//   1. each lane forms its sigma products in float32 and keeps their
//      inclusive within-lane prefix in shared memory (sigma * 128 * 4 B);
//   2. the 128 lane totals get an exclusive scan (warp shuffles plus one
//      combine through shared memory): carry[l];
//   3. for every window slot d < capw, win_map[t, d] names the in-tile
//      position (sub | lane << 16, flag bits 23/24 masked off) of the last
//      element of the slot's row, so W_end[d] = carry[lane] + prefix[sub][lane]
//      is the tile prefix at that row's end, and the row's partial sum is
//      W_end[d] - W_end[d-1] under the wrapped or aligned rules of
//      ops/csr5_spmv.py::csr5_spmv_torch;
//   4. the partial sum is added to y[row] with atomicAdd.
//
// Why atomics: the TPU kernel adds a row that straddles tiles correctly
// only because its grid runs tiles in order on one core and y stays in VMEM
// across grid steps. CUDA blocks run in parallel in no order, so the first
// and last row of a tile (and a long row spanning many tiles) receive
// partial sums from several blocks. At most capw atomics per tile of
// sigma * 128 nonzeros, on distinct addresses except at tile seams; slots
// whose difference is zero (rows beyond the tile, empty rows) add nothing.
// The order of those additions changes from run to run; on integer-valued
// data every partial sum is an integer below 2^24 and the result is exact.
//
// Deferred: the packed uint16 column stream (col_packed), vectorised or TMA
// loads, and several tiles per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
// bits 0-15 of a win_map word: the sub-row; bits 16-22: the lane
constexpr int kSubMask = 0xFFFF;
constexpr int kLaneMask = kLanes - 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename V>
__global__ void __launch_bounds__(kLanes)
csr5_spmv_tile_kernel(const int32_t* __restrict__ col,
                      const V* __restrict__ val,
                      const int32_t* __restrict__ win_map,
                      const int32_t* __restrict__ tile_ptr,
                      const float* __restrict__ x,
                      float* __restrict__ y,
                      int sigma, int capw, int win_rel) {
    extern __shared__ float smem[];
    float* prefix = smem;                  // (sigma, 128) within-lane prefixes
    float* carry = smem + sigma * kLanes;  // (128,) exclusive lane carries
    __shared__ float warp_total[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const size_t tile0 = (size_t)t * sigma * kLanes;

    // 1. products and the inclusive within-lane prefix. __fmul_rn/__fadd_rn
    // keep the product rounded on its own, as the plain version does (no
    // fused multiply-add).
    float run = 0.f;
    for (int s = 0; s < sigma; ++s) {
        const size_t e = tile0 + (size_t)s * kLanes + l;
        run = __fadd_rn(run, __fmul_rn(to_f32(val[e]), __ldg(x + col[e])));
        prefix[s * kLanes + l] = run;
    }

    // 2. exclusive scan of the lane totals
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

    // 3-4. window slots: row-end prefixes, their differences, y
    const int rs = tile_ptr[t];
    const int a = rs & (kLanes - 1);  // slot of the tile's first row
    const int base = rs - a;          // 128-aligned row of slot 0
    const int32_t* wm = win_map + (size_t)t * capw;
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
            const float prev = d == a ? 0.f : w_end(wm[d == 0 ? capw - 1 : d - 1]);
            w2 = w_end(wm[d]) - prev;
            row = base + d + (d < a ? capw : 0);
        } else {
            // aligned maps: slots before the tile's first row are masked
            if (d < a) continue;
            const float prev = d - 1 >= a ? w_end(wm[d - 1]) : 0.f;
            w2 = w_end(wm[d]) - prev;
            row = base + d;
        }
        if (w2 != 0.f) atomicAdd(y + row, w2);
    }
}

template <typename V>
int launch(const void* col, const void* val, const void* win_map,
           const void* tile_ptr, const void* x, void* y, int p, int sigma,
           int capw, int win_rel, void* stream) {
    const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        csr5_spmv_tile_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    csr5_spmv_tile_kernel<V><<<p, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)col, (const V*)val, (const int32_t*)win_map,
        (const int32_t*)tile_ptr, (const float*)x, (float*)y, sigma, capw,
        win_rel);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (m_pad float32, zeroed by the caller) += A @ x for a CSR5 matrix with
// float32 values. Returns the CUDA error code of the launch (0 on success).
int csr5_spmv_f32(const void* col, const void* val, const void* win_map,
                  const void* tile_ptr, const void* x, void* y, int p,
                  int sigma, int capw, int win_rel, void* stream) {
    return launch<float>(col, val, win_map, tile_ptr, x, y, p, sigma, capw,
                         win_rel, stream);
}

// The same with bfloat16 values (products and sums stay float32).
int csr5_spmv_bf16(const void* col, const void* val, const void* win_map,
                   const void* tile_ptr, const void* x, void* y, int p,
                   int sigma, int capw, int win_rel, void* stream) {
    return launch<__nv_bfloat16>(col, val, win_map, tile_ptr, x, y, p, sigma,
                                 capw, win_rel, stream);
}

const char* csr5_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
