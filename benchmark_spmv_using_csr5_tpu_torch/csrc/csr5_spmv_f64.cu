// K4 for Hopper (sm_90a): CSR5 SpMV in native float64, y += A @ x, one
// (sigma, 128) tile per block, one thread per lane.
//
// Replaces the TPU kernel benchmark_spmv_using_csr5_tpu/ops/csr5_df64.py
// ::_df64_kernel, built by _make_df64_call and called by _df64_spmv_jit.
// That kernel carries every value as a double-single (hi, lo) pair of
// float32s, because the TPU has no float64 ALUs, and pays for it with
// error-free transformations (two-sum, Veltkamp/Dekker two-prod) on every
// add and product, for about 2^-48 relative per operation. Hopper has
// native fp64: this kernel computes the same y = alpha * A @ x on one
// float64 value plane with plain fp64 arithmetic (2^-53), and none of the
// double-single machinery is carried over.
//
// It is K1 (csr5_spmv.cu) on doubles. What changes with the width:
//   - the within-lane prefix in shared memory is (sigma + 1) * 128 * 8 B
//     (25.6 KB at sigma = 24), so sigma is limited to 224 (a block has at
//     most 227 KB), half of K1's limit;
//   - the lane-total scan shuffles doubles (__shfl_up_sync moves the two
//     32-bit halves);
//   - rows that straddle tiles go through the native 8 B atomicAdd(double*).
//
// What bounds it: HBM bytes. Every nonzero is streamed once, as a 4 B int32
// column and an 8 B float64 value (12 B/nnz, twice K1's 6 B with bfloat16
// values), plus 8 B x gathers through the read-only cache. Two flops per
// 12 B: the H100's fp64 rate is nowhere near the limit.
//
// Per tile, as in K1:
//   1. each lane forms its sigma products and keeps their inclusive
//      within-lane prefix in shared memory;
//   2. the 128 lane totals get an exclusive scan: carry[l];
//   3. for every window slot d < capw, win_map[t, d] names the in-tile
//      position of the last element of the slot's row, so W_end[d] =
//      carry[lane] + prefix[sub][lane], and the row's partial sum is
//      W_end[d] - W_end[d-1] under the wrapped or aligned rules of
//      ops/csr5_spmv.py::csr5_spmv_torch;
//   4. the partial sum is added to y[row] with atomicAdd.
//
// Rounding: __dmul_rn/__dadd_rn keep every product rounded on its own (no
// fused multiply-add), as the plain version computes it. The tile prefix
// is summed in another association than the plain version's cumsum, and
// the atomics at tile seams add in an order that changes from run to run,
// so on non-integer data y differs from the plain version in the last
// bits, within the classical bound of a prefix-difference method: a few
// units of 2^-53 times the mass of the row's tiles. On integer-valued data
// every partial sum is an integer below 2^53 and y is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
// bits 0-15 of a win_map word: the sub-row; bits 16-22: the lane
constexpr int kSubMask = 0xFFFF;
constexpr int kLaneMask = kLanes - 1;

__global__ void __launch_bounds__(kLanes)
csr5_spmv_f64_tile_kernel(const int32_t* __restrict__ col,
                          const double* __restrict__ val,
                          const int32_t* __restrict__ win_map,
                          const int32_t* __restrict__ tile_ptr,
                          const double* __restrict__ x,
                          double* __restrict__ y,
                          int sigma, int capw, int win_rel) {
    extern __shared__ double smem[];
    double* prefix = smem;                  // (sigma, 128) within-lane prefixes
    double* carry = smem + sigma * kLanes;  // (128,) exclusive lane carries
    __shared__ double warp_total[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const size_t tile0 = (size_t)t * sigma * kLanes;

    // 1. products and the inclusive within-lane prefix
    double run = 0.0;
    for (int s = 0; s < sigma; ++s) {
        const size_t e = tile0 + (size_t)s * kLanes + l;
        run = __dadd_rn(run, __dmul_rn(val[e], __ldg(x + col[e])));
        prefix[s * kLanes + l] = run;
    }

    // 2. exclusive scan of the lane totals
    const int warp = l >> 5;
    const int wl = l & 31;
    double inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, inc, o);
        if (wl >= o) inc = __dadd_rn(inc, v);
    }
    if (wl == 31) warp_total[warp] = inc;
    __syncthreads();
    double before = 0.0;
    for (int w = 0; w < warp; ++w) before = __dadd_rn(before, warp_total[w]);
    carry[l] = __dadd_rn(before, __dsub_rn(inc, run));
    __syncthreads();

    // 3-4. window slots: row-end prefixes, their differences, y
    const int rs = tile_ptr[t];
    const int a = rs & (kLanes - 1);  // slot of the tile's first row
    const int base = rs - a;          // 128-aligned row of slot 0
    const int32_t* wm = win_map + (size_t)t * capw;
    auto w_end = [&](int32_t word) {
        const int sub = word & kSubMask;
        const int lane = (word >> 16) & kLaneMask;  // bits 23/24 are flags
        return __dadd_rn(carry[lane], prefix[sub * kLanes + lane]);
    };
    for (int d = l; d < capw; d += kLanes) {
        double w2;
        int row;
        if (win_rel) {
            // wrapped maps: slot d is row base+d for d >= a and row
            // base+capw+d for d < a; only the first row starts at zero
            const double prev = d == a ? 0.0 : w_end(wm[d == 0 ? capw - 1 : d - 1]);
            w2 = __dsub_rn(w_end(wm[d]), prev);
            row = base + d + (d < a ? capw : 0);
        } else {
            // aligned maps: slots before the tile's first row are masked
            if (d < a) continue;
            const double prev = d - 1 >= a ? w_end(wm[d - 1]) : 0.0;
            w2 = __dsub_rn(w_end(wm[d]), prev);
            row = base + d;
        }
        if (w2 != 0.0) atomicAdd(y + row, w2);
    }
}

}  // namespace

extern "C" {

// y (m_pad float64, zeroed by the caller) += A @ x for a CSR5 matrix with a
// float64 value plane. Returns the CUDA error code of the launch (0 on
// success).
int csr5_spmv_f64(const void* col, const void* val, const void* win_map,
                  const void* tile_ptr, const void* x, void* y, int p,
                  int sigma, int capw, int win_rel, void* stream) {
    const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(double);
    cudaError_t err = cudaFuncSetAttribute(
        csr5_spmv_f64_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (p == 0) return 0;
    csr5_spmv_f64_tile_kernel<<<p, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)col, (const double*)val, (const int32_t*)win_map,
        (const int32_t*)tile_ptr, (const double*)x, (double*)y, sigma, capw,
        win_rel);
    return (int)cudaGetLastError();
}

const char* csr5_f64_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
