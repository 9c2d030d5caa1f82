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
// What bounds it: HBM bytes. Every nonzero is streamed once, as a 4 B int32
// column and an 8 B float64 value (12 B/nnz, twice K1's 6 B with bfloat16
// values), plus 8 B x gathers through the read-only cache. Two flops per
// 12 B: the H100's fp64 rate is nowhere near the limit. To stream at the
// HBM rate a block must keep many loads in flight and the gathers must hit
// L1, so the design is:
//
//   - Row ends only (csr5_rowends.cuh). The first port kept the whole
//     inclusive within-lane prefix in shared memory, (sigma + 1) * 128 * 8 B
//     (25.6 KB at sigma = 24), which held an SM to 8 blocks. The window
//     pass reads the prefix only where win_map names a row end, so the
//     block marks those positions in a per-lane bitmask, numbers them, and a
//     thread stores its running sum only there: nends * 8 B with nends <=
//     min(capw, sigma * 128), plus the lane carries and the 768 B of row-end
//     planes (2.8 KB at df64_banded500k, where capw = 128). Registers, not
//     shared memory, now set the blocks per SM: __launch_bounds__(128, 6)
//     gives a thread 80, which the loads in flight below take without a
//     spill.
//   - Groups of kUnroll = 8 rows, one group ahead: a thread holds the
//     column and value loads of its next 8 rows in flight while it gathers
//     x for the current 8 and adds them, and the first group's loads go
//     out before the row-end marking, whose win_map reads and barriers they
//     overlap (sigma % 8 rows take a remainder loop). The first port waited
//     on each row's load before the next. Two groups ahead (more registers,
//     fewer blocks) and several tiles per block (the next tile's first loads
//     in flight during this tile's window pass) were tried and were slower
//     on the H100; one tile per block and one group ahead were kept.
//   - The planes are read with ld.global.nc.L1::no_allocate (ld_stream):
//     read once, they no longer evict from L1 the x lines that the gathers
//     of neighbouring lanes and tiles reuse. This moved K4 more than any
//     other change here.
//   - A row that lies wholly inside the tile (tile_ptr[t] < row <
//     tile_ptr[t+1]) receives its one partial sum by a plain store; only the
//     first and the last row of a tile, which may straddle a seam, take
//     atomicAdd (y is zeroed, so 0 + w2 == w2 bit for bit).
//   - The dynamic shared-memory attribute is set once per process
//     (grant_smem), and only for launches above 48 KB.
//
// Per tile:
//   0. mark and number the row ends the window slots name;
//   1. each lane forms its sigma products and their inclusive running sum,
//      stored at its row ends;
//   2. the 128 lane totals get an exclusive scan: carry[l];
//   3. for every window slot d < capw, win_map[t, d] names the in-tile
//      position of the last element of the slot's row, so W_end[d] =
//      carry[lane] + prefix[sub][lane], and the row's partial sum is
//      W_end[d] - W_end[d-1] under the wrapped or aligned rules of
//      ops/csr5_spmv.py::csr5_spmv_torch;
//   4. the partial sum is stored into y[row], or added with atomicAdd where
//      the row may straddle.
//
// Rounding: __dmul_rn/__dadd_rn keep every product rounded on its own (no
// fused multiply-add), as the plain version computes it, and the prefix and
// the scan run in the first port's order, so y is bit-equal to it up to the
// order of the seam atomics. The tile prefix is summed in another
// association than the plain version's cumsum, and the atomics at tile
// seams add in an order that changes from run to run, so on non-integer
// data y differs from the plain version in the last bits, within the
// classical bound of a prefix-difference method: a few units of 2^-53 times
// the mass of the row's tiles. On integer-valued data every partial sum is
// an integer below 2^53 and y is exact.

#include "csr5_rowends.cuh"

namespace {

using namespace csr5;

constexpr int kUnroll = 8;

// bytes of dynamic shared memory for one block (the wrapper mirrors it:
// ops/csr5_f64.py::f64_smem_bytes)
size_t smem_bytes(int sigma, int nends) {
    return (size_t)nends * sizeof(double) + (size_t)kLanes * sizeof(double) +
           row_end_bytes(sigma);
}

__global__ void __launch_bounds__(kLanes, 6)
csr5_spmv_f64_tile_kernel(const int32_t* __restrict__ col,
                          const double* __restrict__ val,
                          const int32_t* __restrict__ win_map,
                          const int32_t* __restrict__ tile_ptr,
                          const double* __restrict__ x,
                          double* __restrict__ y,
                          int sigma, int capw, int win_rel, int nends) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* wloc = reinterpret_cast<double*>(smem_raw);  // (nends,) prefixes at row ends
    double* carry = wloc + nends;                        // (128,) exclusive lane carries
    uint32_t* mask = reinterpret_cast<uint32_t*>(carry + kLanes);
    uint16_t* wbase = reinterpret_cast<uint16_t*>(mask + end_words(sigma) * kLanes);
    __shared__ double warp_total[kWarps];
    __shared__ int warp_count[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const size_t tile0 = (size_t)t * sigma * kLanes;
    const int rs = __ldg(tile_ptr + t);
    const int re = __ldg(tile_ptr + t + 1);
    const int a = rs & (kLanes - 1);  // slot of the tile's first row
    const int base = rs - a;          // 128-aligned row of slot 0
    const int32_t* wm = win_map + (size_t)t * capw;

    const int32_t* cl = col + tile0 + l;
    const double* vl = val + tile0 + l;
    const int full = sigma - sigma % kUnroll;  // rows in whole groups
    // the plane loads of rows s .. s + kUnroll - 1 of this lane
    auto load = [&](int s, int (&c)[kUnroll], double (&v)[kUnroll]) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            c[u] = ld_stream(cl + (s + u) * kLanes);
            v[u] = ld_stream(vl + (s + u) * kLanes);
        }
    };
    // the first group's loads go out before the row ends are marked, so
    // their latency overlaps the win_map reads and the barriers
    int c0[kUnroll];
    double v0[kUnroll];
    if (full > 0) load(0, c0, v0);

    // 0. the row ends; id numbers this lane's, in s order
    int id = mark_row_ends(wm, capw, a, win_rel, sigma, mask, wbase, warp_count, l);

    // 1. products and the inclusive within-lane running sum, kept at row
    // ends; in groups of kUnroll rows, whose x gathers go out together and
    // whose next group's plane loads are in flight during the adds
    double run = 0.0;
    for (int s = 0; s < full; s += kUnroll) {
        double xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) xv[u] = __ldg(x + c0[u]);
        int c1[kUnroll];
        double v1[kUnroll];
        const bool more = s + kUnroll < full;
        if (more) load(s + kUnroll, c1, v1);
        // s is a multiple of 8, so the group's rows share one mask word
        const uint32_t ends = mask[(s >> 5) * kLanes + l] >> (s & 31);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            run = __dadd_rn(run, __dmul_rn(v0[u], xv[u]));
            if ((ends >> u) & 1u) wloc[id++] = run;
        }
        if (more) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                c0[u] = c1[u];
                v0[u] = v1[u];
            }
        }
    }
    for (int s = full; s < sigma; ++s) {
        run = __dadd_rn(run, __dmul_rn(ld_stream(vl + s * kLanes), __ldg(x + ld_stream(cl + s * kLanes))));
        if (is_end(mask, s, l)) wloc[id++] = run;
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
    auto w_end = [&](int32_t word) {
        return __dadd_rn(carry[lane_of(word)], wloc[end_index(word, mask, wbase)]);
    };
    for (int d = l; d < capw; d += kLanes) {
        double w2;
        int row;
        if (win_rel) {
            // wrapped maps: slot d is row base+d for d >= a and row
            // base+capw+d for d < a; only the first row starts at zero
            const double prev = d == a ? 0.0 : w_end(__ldg(wm + (d == 0 ? capw - 1 : d - 1)));
            w2 = __dsub_rn(w_end(__ldg(wm + d)), prev);
            row = base + d + (d < a ? capw : 0);
        } else {
            // aligned maps: slots before the tile's first row are masked
            if (d < a) continue;
            const double prev = d - 1 >= a ? w_end(__ldg(wm + d - 1)) : 0.0;
            w2 = __dsub_rn(w_end(__ldg(wm + d)), prev);
            row = base + d;
        }
        if (w2 != 0.0) {
            if (row > rs && row < re)
                y[row] = w2;  // the row's only partial sum
            else
                atomicAdd(y + row, w2);
        }
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
    if (p == 0) return 0;
    const int nends = capw < sigma * kLanes ? capw : sigma * kLanes;
    const size_t smem = smem_bytes(sigma, nends);
    cudaError_t err = grant_smem<&csr5_spmv_f64_tile_kernel>(smem);
    if (err != cudaSuccess) return (int)err;
    csr5_spmv_f64_tile_kernel<<<p, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)col, (const double*)val, (const int32_t*)win_map,
        (const int32_t*)tile_ptr, (const double*)x, (double*)y, sigma, capw,
        win_rel, nends);
    return (int)cudaGetLastError();
}

const char* csr5_f64_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
