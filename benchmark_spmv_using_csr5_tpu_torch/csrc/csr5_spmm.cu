// K2 for Hopper (sm_90a): CSR5 SpMM, Y += A @ X for R right-hand sides,
// one (sigma, 128) tile per block, one thread per lane.
//
// Replaces the TPU kernel benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py
// ::_spmv_kernel at R = 2-16, built by _make_pallas_call and called by
// _csr5_spmm_pallas_jit (csr5_spmm_pallas, layouts "nr" and "rn").
//
// What bounds it: at R = 1 the HBM bytes of the column and value planes
// (6-8 B per nonzero, as K1); as R grows, the gathers of X (4R B per
// nonzero, mostly from L1/L2 on banded matrices) and the per-rhs prefix
// arithmetic. The point of SpMM is that the planes are streamed once for
// all R right-hand sides, so:
//
//   * the tile's column and value planes are read ONCE PER CHUNK of up to
//     16 right-hand sides (RC accumulators per thread, chosen by the
//     wrapper; R > 16 goes in further chunks), never once per rhs: each
//     loaded (col, val) pair is applied to all RC columns of X at once;
//   * a chunk never keeps the whole (sigma, 128, RC) prefix, which would
//     need sigma * 128 * RC * 4 B of shared memory (205 KB at sigma = 24,
//     R = 16). The window pass reads the prefix only at the row ends that
//     win_map names, so once per tile (shared by every chunk) the block
//     marks those positions in a uint16 plane end_id (sigma * 128 * 2 B)
//     and numbers them in element order; a thread walking its lane stores
//     its running sums into wloc[id] (nends * RC floats) only at a row end.
//     nends <= min(capw, sigma * 128).
//
// Per tile and chunk, exactly K1's arithmetic for each rhs column:
//   1. each lane forms its sigma products and keeps the inclusive
//      within-lane prefix in registers (run[c]), stored at row ends;
//   2. the 128 lane totals get an exclusive scan (warp shuffles plus one
//      combine through shared memory): carry[l][c];
//   3. for every window slot d < capw, W_end[d] = carry[lane] +
//      wloc[end_id[sub, lane]] is the tile prefix at the end of the slot's
//      row, and the row's partial sum is W_end[d] - W_end[d-1] under the
//      wrapped or aligned rules of ops/csr5_spmv.py::csr5_spmv_torch;
//   4. the partial sum is added to Y[row, c] with atomicAdd (rows that
//      straddle tiles get partial sums from several blocks, as in K1).
// __fmul_rn/__fadd_rn and K1's scan order make column c of Y equal, bit
// for bit up to the order of the atomics, to K1 on X[:, c]. On integer
// data every partial sum is exact, so Y equals scipy and the plain version.
//
// X and Y are addressed through strides: X[col, r] at col * xs_c + r * xs_r
// (layout "nr": X (n, R) row-major, xs_c = R, xs_r = 1, and a thread reads
// X[col, r0:r0+RC] as one contiguous run, with 16 B loads when R % 4 == 0;
// layout "rn": X^T (R, n), xs_c = 1, xs_r = n), Y[row, r] at
// row * ys_row + r * ys_r. Rows >= m get nothing (they hold no nonzeros).
//
// K2p (csr5_spmm_packed_kernel) is the same kernel streaming the packed
// column plane col_packed (p, sigma/2, 128) int32, two uint16 codes
// `lane | local_page << 7` per word (rows s and s + sigma/2), which
// _csr5_spmm_pallas_jit streams whenever it exists (csr5_kernel.py:870-874):
// 2 B/nnz of columns instead of 4. Column = pages[local] * 128 + lane,
// with the tile's page list (pmax <= 512 int32) read through the read-only
// cache. The prefix must still run in s order, so while a thread walks
// rows s < sigma/2 it keeps each word's high code in shared memory
// (sigma/2 * 128 uint16) and decodes it again at row s + sigma/2: each word
// is read from HBM once per chunk, and Y is bit-equal to K2's.
//
// Deferred: staging X rows through shared memory, several tiles per block.

#include "csr5_tile.cuh"

namespace {

using namespace csr5;

// in-tile position sub * 128 + lane of a win_map word (flag bits 23/24 off)
__device__ __forceinline__ int pos_of(int32_t word) {
    return (word & kSubMask) * kLanes + ((word >> 16) & kLaneMask);
}

__device__ __forceinline__ float madd(float acc, float v, float x) {
    return __fadd_rn(acc, __fmul_rn(v, x));
}

// bytes of dynamic shared memory for one block (the wrapper mirrors it:
// ops/csr5_kernel.py::spmm_smem_bytes); K2p adds its high codes
size_t smem_bytes(int sigma, int nends, int rc, int packed) {
    size_t b = ((size_t)nends * rc + (size_t)kLanes * rc + (size_t)kWarps * rc) * sizeof(float) +
               (size_t)sigma * kLanes * sizeof(uint16_t);
    if (packed) b += (size_t)(sigma / 2) * kLanes * sizeof(uint16_t);
    return b;
}

// One tile of K2 (PACKED false: col is col_idx_tiles) or K2p (PACKED true:
// col is col_packed, pages the page lists).
template <typename V, int RC, bool PACKED>
__device__ __forceinline__ void spmm_tile(const int32_t* __restrict__ col,
                                          const V* __restrict__ val,
                                          const int32_t* __restrict__ win_map,
                                          const int32_t* __restrict__ tile_ptr,
                                          const int32_t* __restrict__ pages, int pmax,
                                          const float* __restrict__ x,
                                          float* __restrict__ y,
                                          int sigma, int capw, int win_rel, int nends, int m,
                                          int R, long long xs_c, long long xs_r,
                                          long long ys_row, long long ys_r, int vec) {
    extern __shared__ float smem[];
    float* wloc = smem;                                 // (nends, RC)
    float* carry = wloc + (size_t)nends * RC;           // (128, RC)
    float* warp_total = carry + kLanes * RC;            // (kWarps, RC)
    uint16_t* end_id = reinterpret_cast<uint16_t*>(warp_total + kWarps * RC);  // (sigma, 128)
    uint16_t* hi_code = end_id + (size_t)sigma * kLanes;  // (sigma/2, 128), K2p
    __shared__ int warp_count[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const int warp = l >> 5;
    const int wl = l & 31;
    const size_t tile0 = (size_t)t * sigma * kLanes;
    const int h = sigma >> 1;
    const int32_t* wm = win_map + (size_t)t * capw;
    const int rs = tile_ptr[t];
    const int a = rs & (kLanes - 1);  // slot of the tile's first row
    const int base = rs - a;          // 128-aligned row of slot 0
    const int32_t* pages_t = pages + (size_t)t * pmax;  // K2p: the tile's page list

    // --- once per tile: mark and number the row ends the slots name -------
    for (int s = 0; s < sigma; ++s) end_id[s * kLanes + l] = 0;
    __syncthreads();
    for (int d = l; d < capw; d += kLanes)
        if (win_rel || d >= a) end_id[pos_of(wm[d])] = 1;  // aligned: slots < a unused
    __syncthreads();
    int cnt = 0;
    for (int s = 0; s < sigma; ++s) cnt += end_id[s * kLanes + l];
    int inc_c = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc_c, o);
        if (wl >= o) inc_c += v;
    }
    if (wl == 31) warp_count[warp] = inc_c;
    __syncthreads();
    int id = inc_c - cnt;
    for (int w = 0; w < warp; ++w) id += warp_count[w];
    // lane-major element order; a thread rewrites only its own lane
    for (int s = 0; s < sigma; ++s)
        if (end_id[s * kLanes + l]) end_id[s * kLanes + l] = (uint16_t)(++id);  // 1 + id
    __syncthreads();

    for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = R - r0 < RC ? R - r0 : RC;

        // 1. products and within-lane prefixes; the (col, val) pair is
        // loaded once for the RC right-hand sides of the chunk
        float run[RC];
#pragma unroll
        for (int c = 0; c < RC; ++c) run[c] = 0.f;
        // row s of the tile with column cidx: RC products, the running sums,
        // stored where a row ends
        auto step = [&](int s, int cidx) {
            const size_t e = tile0 + (size_t)s * kLanes + l;
            const float v = to_f32(val[e]);
            const float* xr = x + (size_t)cidx * xs_c + (size_t)r0 * xs_r;
            bool done = false;
            if constexpr (RC >= 4) {
                if (vec) {
#pragma unroll
                    for (int c = 0; c < RC; c += 4) {
                        if (c < rc) {
                            const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + c));
                            run[c] = madd(run[c], v, xv.x);
                            run[c + 1] = madd(run[c + 1], v, xv.y);
                            run[c + 2] = madd(run[c + 2], v, xv.z);
                            run[c + 3] = madd(run[c + 3], v, xv.w);
                        }
                    }
                    done = true;
                }
            }
            if (!done) {
#pragma unroll
                for (int c = 0; c < RC; ++c)
                    if (c < rc) run[c] = madd(run[c], v, __ldg(xr + (size_t)c * xs_r));
            }
            const int eid = end_id[s * kLanes + l];
            if (eid) {
                float* w = wloc + (size_t)(eid - 1) * RC;
#pragma unroll
                for (int c = 0; c < RC; ++c) w[c] = run[c];
            }
        };
        if constexpr (PACKED) {
            // rows s < sigma/2 take the low code of word s now and keep its
            // high code for row s + sigma/2 (the same thread reads it back)
            for (int s = 0; s < h; ++s) {
                const uint32_t w = (uint32_t)__ldg(col + tile0 / 2 + (size_t)s * kLanes + l);
                hi_code[s * kLanes + l] = (uint16_t)(w >> 16);
                step(s, decode(w & 0xFFFFu, pages_t));
            }
            for (int s = h; s < sigma; ++s) step(s, decode(hi_code[(s - h) * kLanes + l], pages_t));
        } else {
            for (int s = 0; s < sigma; ++s) step(s, col[tile0 + (size_t)s * kLanes + l]);
        }

        // 2. exclusive scan of the lane totals, per rhs (K1's order)
        float inc[RC];
#pragma unroll
        for (int c = 0; c < RC; ++c) {
            inc[c] = run[c];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, inc[c], o);
                if (wl >= o) inc[c] += v;
            }
            if (wl == 31) warp_total[warp * RC + c] = inc[c];
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < RC; ++c) {
            float before = 0.f;
            for (int w = 0; w < warp; ++w) before += warp_total[w * RC + c];
            carry[l * RC + c] = before + (inc[c] - run[c]);
        }
        __syncthreads();

        // 3-4. window slots: row-end prefixes, their differences, Y
        for (int d = l; d < capw; d += kLanes) {
            int row, wcur, wprev = -1;  // wprev < 0: the row starts at zero
            if (win_rel) {
                // wrapped maps: slot d is row base+d for d >= a and row
                // base+capw+d for d < a; the wrap seam (slot capw-1 -> slot
                // 0) is consecutive rows, and only the first row starts at 0
                if (d != a) wprev = wm[d == 0 ? capw - 1 : d - 1];
                wcur = wm[d];
                row = base + d + (d < a ? capw : 0);
            } else {
                // aligned maps: slots before the tile's first row are masked
                if (d < a) continue;
                if (d - 1 >= a) wprev = wm[d - 1];
                wcur = wm[d];
                row = base + d;
            }
            if (row >= m) continue;
            const int pc = pos_of(wcur);
            const float* wc = wloc + (size_t)(end_id[pc] - 1) * RC;
            const float* cc = carry + (pc & kLaneMask) * RC;
            const float* wp = nullptr;
            const float* cp = nullptr;
            if (wprev >= 0) {
                const int pp = pos_of(wprev);
                wp = wloc + (size_t)(end_id[pp] - 1) * RC;
                cp = carry + (pp & kLaneMask) * RC;
            }
            float* yr = y + (size_t)row * ys_row + (size_t)r0 * ys_r;
#pragma unroll
            for (int c = 0; c < RC; ++c) {
                if (c < rc) {
                    const float prev = wp ? cp[c] + wp[c] : 0.f;
                    const float w2 = (cc[c] + wc[c]) - prev;
                    if (w2 != 0.f) atomicAdd(yr + (size_t)c * ys_r, w2);
                }
            }
        }
        __syncthreads();  // the next chunk rewrites wloc, carry, warp_total
    }
}

#define K2_PARAMS                                                                          \
    const int32_t *__restrict__ col, const V *__restrict__ val,                            \
        const int32_t *__restrict__ win_map, const int32_t *__restrict__ tile_ptr,         \
        const int32_t *__restrict__ pages, int pmax, const float *__restrict__ x,          \
        float *__restrict__ y, int sigma, int capw, int win_rel, int nends, int m, int R, \
        long long xs_c, long long xs_r, long long ys_row, long long ys_r, int vec
#define K2_ARGS \
    col, val, win_map, tile_ptr, pages, pmax, x, y, sigma, capw, win_rel, nends, m, R, xs_c, \
        xs_r, ys_row, ys_r, vec

template <typename V, int RC>
__global__ void __launch_bounds__(kLanes) csr5_spmm_tile_kernel(K2_PARAMS) {
    spmm_tile<V, RC, false>(K2_ARGS);
}

template <typename V, int RC>
__global__ void __launch_bounds__(kLanes) csr5_spmm_packed_kernel(K2_PARAMS) {
    spmm_tile<V, RC, true>(K2_ARGS);
}

template <typename V, int RC>
int launch_rc(const void* col, const void* val, const void* win_map,
              const void* tile_ptr, const void* pages, int pmax, int packed, const void* x,
              void* y, int p, int sigma, int capw, int win_rel, int nends, int m, int R,
              long long xs_c, long long xs_r, long long ys_row, long long ys_r, int vec,
              cudaStream_t stream) {
    const size_t smem = smem_bytes(sigma, nends, RC, packed);
    auto kernel = packed ? &csr5_spmm_packed_kernel<V, RC> : &csr5_spmm_tile_kernel<V, RC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<p, kLanes, smem, stream>>>(
        (const int32_t*)col, (const V*)val, (const int32_t*)win_map, (const int32_t*)tile_ptr,
        (const int32_t*)pages, pmax, (const float*)x, (float*)y, sigma, capw, win_rel, nends,
        m, R, xs_c, xs_r, ys_row, ys_r, vec);
    return (int)cudaGetLastError();
}

template <typename V>
int launch(const void* col, const void* val, const void* win_map, const void* tile_ptr,
           const void* pages, int pmax, int packed, const void* x, void* y, int p, int sigma,
           int capw, int win_rel, int nends, int m, int R, long long xs_c, long long xs_r,
           long long ys_row, long long ys_r, int rc, int vec, void* stream) {
    if (p <= 0 || R <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
#define K2_AT(RCV)                                                                          \
    return launch_rc<V, RCV>(col, val, win_map, tile_ptr, pages, pmax, packed, x, y, p,    \
                             sigma, capw, win_rel, nends, m, R, xs_c, xs_r, ys_row, ys_r, \
                             vec, s)
    switch (rc) {
        case 1: K2_AT(1);
        case 2: K2_AT(2);
        case 4: K2_AT(4);
        case 8: K2_AT(8);
        case 16: K2_AT(16);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K2_AT
}

}  // namespace

extern "C" {

// Y (float32, zeroed by the caller) += A @ X for a CSR5 matrix with float32
// values, in chunks of rc in {1, 2, 4, 8, 16} right-hand sides. vec: X rows
// are read with 16 B loads (xs_r == 1, R % 4 == 0, X 16 B aligned). packed:
// col is col_packed and pages the (p, pmax) page lists (K2p); else col is
// col_idx_tiles and pages is unused (K2). Returns the CUDA error code of the
// launch (0 on success).
int csr5_spmm_f32(const void* col, const void* val, const void* win_map,
                  const void* tile_ptr, const void* pages, int pmax, int packed,
                  const void* x, void* y, int p, int sigma, int capw, int win_rel, int nends,
                  int m, int R, long long xs_c, long long xs_r, long long ys_row,
                  long long ys_r, int rc, int vec, void* stream) {
    return launch<float>(col, val, win_map, tile_ptr, pages, pmax, packed, x, y, p, sigma, capw,
                         win_rel, nends, m, R, xs_c, xs_r, ys_row, ys_r, rc, vec, stream);
}

// The same with bfloat16 values (products and sums stay float32).
int csr5_spmm_bf16(const void* col, const void* val, const void* win_map,
                   const void* tile_ptr, const void* pages, int pmax, int packed,
                   const void* x, void* y, int p, int sigma, int capw, int win_rel, int nends,
                   int m, int R, long long xs_c, long long xs_r, long long ys_row,
                   long long ys_r, int rc, int vec, void* stream) {
    return launch<__nv_bfloat16>(col, val, win_map, tile_ptr, pages, pmax, packed, x, y, p,
                                 sigma, capw, win_rel, nends, m, R, xs_c, xs_r, ys_row, ys_r,
                                 rc, vec, stream);
}

const char* csr5_spmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
