// K2 for Hopper (sm_90a): CSR5 SpMM, Y += A @ X for R right-hand sides,
// one (sigma, 128) tile per block, one thread per lane.
//
// Replaces the TPU kernel benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py
// ::_spmv_kernel at R = 2-16, built by _make_pallas_call and called by
// _csr5_spmm_pallas_jit (csr5_spmm_pallas, layouts "nr" and "rn").
//
// What bounds it: the HBM bytes of the column and value planes (6-8 B per
// nonzero, as K1) and of X and Y (4R B per row each). The point of SpMM is
// that the planes are streamed once for all R right-hand sides: the tile's
// column and value planes are read once per chunk of up to 16 right-hand
// sides (RC accumulators per thread, chosen by the wrapper; R > 16 goes in
// further chunks), and each loaded (col, val) pair is applied to all RC
// columns of X at once. The first port then sat at a quarter of its bound:
// every lane gathered its own row X[col, r0:r0+RC] from L1/L2 on every
// nonzero, and lanes of a warp walk nonzeros sigma apart, so a warp touched
// about 32 rows of X per load (32R B of X per nonzero, 448 MB per call at
// banded500k R = 8), and each row's loads waited on the previous row's.
// The redesign:
//
//   - X staged in shared memory ("staged" launches). The matrix carries the
//     JAX kernel's gather plan: tile t reads X only from the 128-column
//     pages pages[t, 0:pmax]. Once per tile and chunk the block copies
//     X[page * 128 : page * 128 + 128, r0 : r0 + RC] for each listed page
//     into a window of pmax * 128 slots (coalesced: layout "nr" reads each
//     slot's RC floats as one run, float4 where X allows; "rn" reads RC runs
//     along n), zero-filling columns >= n (the sentinel page n_pad / 128 and
//     the contiguous windows clamped at the sentinel reach past n) and the
//     rhs columns >= rc of a last partial chunk. A nonzero then reads its RC
//     floats from the window: K2p's code `lane | local_page << 7` is already
//     its slot (local_page * 128 + lane), and raw K2 on contiguous pages
//     (pages_contig, banded matrices) takes slot col - pages[t, 0] * 128.
//     These reads, nnz * RC * 4 B through the shared-memory pipe, bound K2
//     more than HBM does, so the window's layout is chosen for them: one
//     plane per rhs column (skew, plane_floats), read one float per lane
//     and instruction. A warp then needs one wavefront per plane unless two
//     of its 32 slots fall on one bank; with a float of pad after every 32
//     slots, a model of the planes of a band 27 wide gives one wavefront at
//     sigma = 16 and 24, where reading each lane's RC floats as float4s
//     from one padded slot took 1.7-1.9 per 8 lanes (other bands and
//     sigmas: 1-2.1). The wrapper chooses staged
//     or gathered once per launch (ops/csr5_kernel.py::spmm_mode): staged
//     when the launch is packed or pages_contig and the window fits the
//     block budget. Raw K2 on a page list ("gathered") has no slot without a
//     lookup and keeps the __ldg gathers of X, as does any launch whose
//     window does not fit.
//   - Groups of kUnroll = 8 rows, one group ahead: a thread holds the
//     column (or packed word) and value loads of its next 8 rows in flight
//     while it forms the current 8 rows' products; the first group's loads
//     go out before the window is staged and the row ends marked, and the
//     next chunk's first group during this chunk's scan and window pass
//     (sigma % 16 == 0 for the packed plane, so 8 divides sigma / 2; the raw
//     plane has a remainder loop). The planes are read with
//     ld.global.nc.L1::no_allocate (ld_stream), so that streaming them does
//     not evict the X lines of a gathered launch from L1.
//   - Registers: __launch_bounds__(128, 6), at most 80 a thread, up to a
//     chunk of 8; (128, 4) at 16, which spills at 80.
//   - Row ends only (csr5_rowends.cuh): a chunk never keeps the whole
//     (sigma, 128, RC) prefix (205 KB at sigma = 24, R = 16). The window
//     pass reads the prefix only at the row ends win_map names, so once per
//     tile (shared by every chunk) the block marks them in a per-lane
//     bitmask and numbers them, and a thread stores its running sums into
//     wloc[id] only at a row end. wloc (nends slots) and the lane carries
//     (128 slots) take a padded slot stride (win_stride): neighbouring lanes
//     store and read neighbouring ids and lanes, which at a stride of RC
//     floats fell on the same banks; padded, K2 at R = 8 and 16 ran
//     measurably faster on the H100.
//   - A row that lies wholly inside the tile (tile_ptr[t] < row <
//     tile_ptr[t+1]) receives its partial sums by plain stores (float4 in
//     layout "nr" when R % 4 == 0); only the first and the last row of a
//     tile, which may straddle a seam, take atomicAdd (Y is zeroed).
//   - The dynamic shared-memory attribute is set once per process for each
//     kernel instance (grant_smem), and only above 48 KB.
//
// Per tile and chunk, exactly K1's arithmetic for each rhs column:
//   1. each lane forms its sigma products and keeps the inclusive
//      within-lane prefix in registers (run[c]), stored at row ends;
//   2. the 128 lane totals get an exclusive scan (warp shuffles plus one
//      combine through shared memory): carry[l][c];
//   3. for every window slot d < capw, W_end[d] = carry[lane] +
//      wloc[end_index(sub, lane)] is the tile prefix at the end of the
//      slot's row, and the row's partial sum is W_end[d] - W_end[d-1] under
//      the wrapped or aligned rules of ops/csr5_spmv.py::csr5_spmv_torch;
//   4. the partial sum goes into Y[row, c].
// __fmul_rn/__fadd_rn and K1's scan order make column c of Y equal, bit
// for bit up to the order of the seam atomics, to K1 on X[:, c], whether X
// is staged or gathered. On integer data every partial sum is exact, so Y
// equals scipy and the plain version.
//
// X and Y are addressed through strides: X[col, r] at col * xs_c + r * xs_r
// (layout "nr": X (n, R) row-major, xs_c = R, xs_r = 1; layout "rn": X^T
// (R, n), xs_c = 1, xs_r = n), Y[row, r] at row * ys_row + r * ys_r. Rows
// >= m get nothing (they hold no nonzeros).
//
// K2p (csr5_spmm_packed_kernel) is the same kernel streaming the packed
// column plane col_packed (p, sigma/2, 128) int32, two uint16 codes
// `lane | local_page << 7` per word (rows s and s + sigma/2), which
// _csr5_spmm_pallas_jit streams whenever it exists (csr5_kernel.py:870-874):
// 2 B/nnz of columns instead of 4. Gathered, the column is pages[local] *
// 128 + lane, with the tile's page list (pmax <= 512 int32) read through the
// read-only cache. The prefix must still run in s order, so while a thread
// walks rows s < sigma/2 it keeps each word's high code in shared memory
// (sigma/2 * 128 uint16) and uses it again at row s + sigma/2: each word is
// read from HBM once per chunk, and Y is bit-equal to K2's.

#include "csr5_rowends.cuh"

namespace {

using namespace csr5;

constexpr int kUnroll = 8;
// blocks per SM the register budget is set for (the note above)
__host__ __device__ constexpr int min_blocks(int rc) { return rc >= 16 ? 4 : 6; }

// floats per slot of wloc and carry: RC, padded at RC >= 8 to an odd
// number of 16 B units (the wrapper mirrors it:
// ops/csr5_kernel.py::spmm_window_stride)
__host__ __device__ constexpr int win_stride(int rc) { return rc >= 8 ? rc + 4 : rc; }

// The window holds one plane of pmax * 128 floats per rhs column, each
// padded by a float after every 32 slots: slot k of plane c is at
// c * plane_floats(pmax) + skew(k). A warp reads one plane per instruction,
// its 32 lanes on 32 banks unless two slots differ by a multiple of 32
// (after the skew).
__host__ __device__ constexpr int skew(int k) { return k + (k >> 5); }
__host__ __device__ constexpr int plane_floats(int pages) { return pages * (kLanes + 4); }

__device__ __forceinline__ float madd(float acc, float v, float x) {
    return __fadd_rn(acc, __fmul_rn(v, x));
}

// bytes of dynamic shared memory for one block (the wrapper mirrors it:
// ops/csr5_kernel.py::spmm_smem_bytes): the staged window (win_pages pages,
// 0 when gathered), the row-end sums, the lane carries and warp totals, the
// row-end planes, and K2p's high codes
size_t smem_bytes(int sigma, int nends, int rc, int packed, int win_pages) {
    return (size_t)plane_floats(win_pages) * rc * sizeof(float) +
           ((size_t)nends * win_stride(rc) + (size_t)kLanes * win_stride(rc) + (size_t)kWarps * rc) *
               sizeof(float) +
           row_end_bytes(sigma) + (packed ? (size_t)(sigma / 2) * kLanes * sizeof(uint16_t) : 0);
}

// Copies X[page * 128 + l, r0 : r0 + RC] for the pmax pages of the tile into
// slot j * 128 + l of the window; columns >= n and rhs columns >= rc are 0.
template <int RC>
__device__ __forceinline__ void stage_window(float* win, const int32_t* __restrict__ pages_t,
                                             int pmax, const float* __restrict__ x, int n,
                                             int r0, int rc, long long xs_c, long long xs_r,
                                             int vec, int l) {
    const int wp = plane_floats(pmax);
    for (int j = 0; j < pmax; ++j) {
        const int cx = __ldg(pages_t + j) * kLanes + l;
        float v[RC];
#pragma unroll
        for (int c = 0; c < RC; ++c) v[c] = 0.f;
        if (cx < n) {
            const float* xr = x + (size_t)cx * xs_c + (size_t)r0 * xs_r;
            bool done = false;
            if constexpr (RC >= 4) {
                if (vec) {
#pragma unroll
                    for (int c = 0; c < RC; c += 4) {
                        if (c < rc) {
                            const float4 q = __ldg(reinterpret_cast<const float4*>(xr + c));
                            v[c] = q.x;
                            v[c + 1] = q.y;
                            v[c + 2] = q.z;
                            v[c + 3] = q.w;
                        }
                    }
                    done = true;
                }
            }
            if (!done) {
#pragma unroll
                for (int c = 0; c < RC; ++c)
                    if (c < rc) v[c] = __ldg(xr + (size_t)c * xs_r);
            }
        }
        float* w = win + skew(j * kLanes + l);
#pragma unroll
        for (int c = 0; c < RC; ++c) w[c * wp] = v[c];
    }
}

// One tile of K2 (PACKED false: col is col_idx_tiles) or K2p (PACKED true:
// col is col_packed), with X staged in shared memory (STAGED) or gathered.
template <typename V, int RC, bool PACKED, bool STAGED>
__device__ __forceinline__ void spmm_tile(const int32_t* __restrict__ col,
                                          const V* __restrict__ val,
                                          const int32_t* __restrict__ win_map,
                                          const int32_t* __restrict__ tile_ptr,
                                          const int32_t* __restrict__ pages, int pmax,
                                          const float* __restrict__ x,
                                          float* __restrict__ y,
                                          int sigma, int capw, int win_rel, int nends, int m,
                                          int n, int R, long long xs_c, long long xs_r,
                                          long long ys_row, long long ys_r, int vec) {
    constexpr int S = win_stride(RC);
    extern __shared__ __align__(16) float smem[];
    float* win = smem;                                                // (pmax * 128, S), staged
    const int wp = plane_floats(pmax);
    float* wloc = win + (STAGED ? (size_t)RC * wp : 0);              // (nends, S)
    float* carry = wloc + (size_t)nends * S;                          // (128, S)
    float* warp_total = carry + kLanes * S;                           // (kWarps, RC)
    uint32_t* mask = reinterpret_cast<uint32_t*>(warp_total + kWarps * RC);
    uint16_t* wbase = reinterpret_cast<uint16_t*>(mask + end_words(sigma) * kLanes);
    uint16_t* hi_code = wbase + end_words(sigma) * kLanes;           // (sigma/2, 128), K2p
    __shared__ int warp_count[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const int warp = l >> 5;
    const int wl = l & 31;
    const size_t tile0 = (size_t)t * sigma * kLanes;
    const int h = sigma >> 1;
    const int32_t* wm = win_map + (size_t)t * capw;
    const int rs = __ldg(tile_ptr + t);
    const int re = __ldg(tile_ptr + t + 1);
    const int a = rs & (kLanes - 1);  // slot of the tile's first row
    const int base = rs - a;          // 128-aligned row of slot 0
    const int32_t* pages_t = pages + (size_t)t * pmax;  // the tile's page list
    // raw staged launches are pages_contig: slot = col - first page * 128
    const int cbase = STAGED && !PACKED ? __ldg(pages_t) * kLanes : 0;
    // the lane's column plane: raw columns, or the packed words of rows
    // s < sigma/2 (row s + sigma/2 takes the high code of word s)
    const int32_t* cl = col + (PACKED ? tile0 / 2 : tile0) + l;
    const V* vl = val + tile0 + l;
    // rows in whole groups of kUnroll (sigma % 16 == 0 when packed)
    const int full = PACKED ? sigma : sigma - sigma % kUnroll;

    // the plane loads of rows s .. s + kUnroll - 1 of this lane: the column
    // or packed word (none for the packed rows >= sigma/2) and the value
    auto load = [&](int s, int32_t (&k)[kUnroll], float (&v)[kUnroll]) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (!PACKED || s < h) k[u] = ld_stream(cl + (s + u) * kLanes);
            v[u] = to_f32(ld_stream(vl + (s + u) * kLanes));
        }
    };
    // the first group's loads go out before the window is staged and the
    // row ends are marked, so that their latency overlaps both
    int32_t k0[kUnroll];
    float v0[kUnroll];
    if (full > 0) load(0, k0, v0);

    // --- once per tile: the first chunk's window and the row ends ---------
    if constexpr (STAGED)
        stage_window<RC>(win, pages_t, pmax, x, n, 0, R < RC ? R : RC, xs_c, xs_r, vec, l);
    const int first = mark_row_ends(wm, capw, a, win_rel, sigma, mask, wbase, warp_count, l);

    for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = R - r0 < RC ? R - r0 : RC;
        if constexpr (STAGED) {
            if (r0 > 0) {
                stage_window<RC>(win, pages_t, pmax, x, n, r0, rc, xs_c, xs_r, vec, l);
                __syncthreads();
            }
        }

        // 1. products and within-lane prefixes; the (col, val) pair is
        // loaded once for the RC right-hand sides of the chunk
        float run[RC];
#pragma unroll
        for (int c = 0; c < RC; ++c) run[c] = 0.f;
        int id = first;
        // one row with value v and key k (the window slot when staged, else
        // the column): RC products and running sums, stored at a row end
        auto step = [&](float v, int k, bool end) {
            float xv[RC];
            if constexpr (STAGED) {
                const float* xs = win + skew(k);
#pragma unroll
                for (int c = 0; c < RC; ++c) xv[c] = xs[c * wp];
            } else {
                const float* xr = x + (size_t)k * xs_c + (size_t)r0 * xs_r;
#pragma unroll
                for (int c = 0; c < RC; ++c) xv[c] = 0.f;
                bool done = false;
                if constexpr (RC >= 4) {
                    if (vec) {
#pragma unroll
                        for (int c = 0; c < RC; c += 4) {
                            if (c < rc) {
                                const float4 q = __ldg(reinterpret_cast<const float4*>(xr + c));
                                xv[c] = q.x;
                                xv[c + 1] = q.y;
                                xv[c + 2] = q.z;
                                xv[c + 3] = q.w;
                            }
                        }
                        done = true;
                    }
                }
                if (!done) {
#pragma unroll
                    for (int c = 0; c < RC; ++c)
                        if (c < rc) xv[c] = __ldg(xr + (size_t)c * xs_r);
                }
            }
#pragma unroll
            for (int c = 0; c < RC; ++c) run[c] = madd(run[c], v, xv[c]);
            if (end) {
                float* w = wloc + (size_t)id * S;
                if constexpr (RC >= 4) {
#pragma unroll
                    for (int c = 0; c < RC; c += 4)
                        *reinterpret_cast<float4*>(w + c) =
                            make_float4(run[c], run[c + 1], run[c + 2], run[c + 3]);
                } else {
#pragma unroll
                    for (int c = 0; c < RC; ++c) w[c] = run[c];
                }
                ++id;
            }
        };
        // groups of kUnroll rows: the next group's plane loads are in flight
        // while this group's products are formed
        for (int s = 0; s < full; s += kUnroll) {
            int32_t k1[kUnroll];
            float v1[kUnroll];
            const bool more = s + kUnroll < full;
            if (more) load(s + kUnroll, k1, v1);
            // s is a multiple of 8: the group's rows share one mask word
            const uint32_t ends = mask[(s >> 5) * kLanes + l] >> (s & 31);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                int key;
                if constexpr (PACKED) {
                    // rows s < sigma/2 take the low code of word s now and
                    // keep its high code for row s + sigma/2 (the same
                    // thread reads it back)
                    uint32_t code;
                    if (s < h) {
                        code = (uint32_t)k0[u] & 0xFFFFu;
                        hi_code[(s + u) * kLanes + l] = (uint16_t)((uint32_t)k0[u] >> 16);
                    } else {
                        code = hi_code[(s - h + u) * kLanes + l];
                    }
                    key = STAGED ? (int)code : decode(code, pages_t);
                } else {
                    key = k0[u] - cbase;
                }
                step(v0[u], key, (ends >> u) & 1u);
            }
            if (more) {
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    k0[u] = k1[u];
                    v0[u] = v1[u];
                }
            }
        }
        for (int s = full; s < sigma; ++s)  // raw plane: sigma % kUnroll rows
            step(to_f32(ld_stream(vl + s * kLanes)), ld_stream(cl + s * kLanes) - cbase,
                 is_end(mask, s, l));
        // the next chunk's first group, in flight during the scan and the
        // window pass
        if (r0 + RC < R && full > 0) load(0, k0, v0);

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
            carry[l * S + c] = before + (inc[c] - run[c]);
        }
        __syncthreads();

        // 3-4. window slots: row-end prefixes, their differences, Y
        for (int d = l; d < capw; d += kLanes) {
            int row, wcur, wprev = -1;  // wprev < 0: the row starts at zero
            if (win_rel) {
                // wrapped maps: slot d is row base+d for d >= a and row
                // base+capw+d for d < a; the wrap seam (slot capw-1 -> slot
                // 0) is consecutive rows, and only the first row starts at 0
                if (d != a) wprev = __ldg(wm + (d == 0 ? capw - 1 : d - 1));
                wcur = __ldg(wm + d);
                row = base + d + (d < a ? capw : 0);
            } else {
                // aligned maps: slots before the tile's first row are masked
                if (d < a) continue;
                if (d - 1 >= a) wprev = __ldg(wm + d - 1);
                wcur = __ldg(wm + d);
                row = base + d;
            }
            if (row >= m) continue;
            const float* wc = wloc + (size_t)end_index(wcur, mask, wbase) * S;
            const float* cc = carry + lane_of(wcur) * S;
            const float* wp = nullptr;
            const float* cp = nullptr;
            if (wprev >= 0) {
                wp = wloc + (size_t)end_index(wprev, mask, wbase) * S;
                cp = carry + lane_of(wprev) * S;
            }
            float w2[RC];
#pragma unroll
            for (int c = 0; c < RC; ++c) {
                const float prev = wp ? cp[c] + wp[c] : 0.f;
                w2[c] = (cc[c] + wc[c]) - prev;
            }
            float* yr = y + (size_t)row * ys_row + (size_t)r0 * ys_r;
            if (row > rs && row < re) {
                // the row's only partial sums: plain stores (a difference
                // of equal prefixes is +0, so storing a zero changes nothing)
                bool done = false;
                if constexpr (RC >= 4) {
                    if (vec) {
#pragma unroll
                        for (int c = 0; c < RC; c += 4)
                            if (c < rc)
                                *reinterpret_cast<float4*>(yr + c) =
                                    make_float4(w2[c], w2[c + 1], w2[c + 2], w2[c + 3]);
                        done = true;
                    }
                }
                if (!done) {
#pragma unroll
                    for (int c = 0; c < RC; ++c)
                        if (c < rc && w2[c] != 0.f) yr[(size_t)c * ys_r] = w2[c];
                }
            } else {
#pragma unroll
                for (int c = 0; c < RC; ++c)
                    if (c < rc && w2[c] != 0.f) atomicAdd(yr + (size_t)c * ys_r, w2[c]);
            }
        }
        __syncthreads();  // the next chunk rewrites the window, wloc, carry, warp_total
    }
}

#define K2_PARAMS                                                                          \
    const int32_t *__restrict__ col, const V *__restrict__ val,                            \
        const int32_t *__restrict__ win_map, const int32_t *__restrict__ tile_ptr,         \
        const int32_t *__restrict__ pages, int pmax, const float *__restrict__ x,          \
        float *__restrict__ y, int sigma, int capw, int win_rel, int nends, int m, int n,  \
        int R, long long xs_c, long long xs_r, long long ys_row, long long ys_r, int vec
#define K2_ARGS \
    col, val, win_map, tile_ptr, pages, pmax, x, y, sigma, capw, win_rel, nends, m, n, R, xs_c, \
        xs_r, ys_row, ys_r, vec

template <typename V, int RC, bool STAGED>
__global__ void __launch_bounds__(kLanes, min_blocks(RC)) csr5_spmm_tile_kernel(K2_PARAMS) {
    spmm_tile<V, RC, false, STAGED>(K2_ARGS);
}

template <typename V, int RC, bool STAGED>
__global__ void __launch_bounds__(kLanes, min_blocks(RC)) csr5_spmm_packed_kernel(K2_PARAMS) {
    spmm_tile<V, RC, true, STAGED>(K2_ARGS);
}

template <auto Kernel, typename V>
int launch_kernel(const void* col, const void* val, const void* win_map, const void* tile_ptr,
                  const void* pages, int pmax, const void* x, void* y, int p, int sigma,
                  int capw, int win_rel, int nends, int m, int n, int R, long long xs_c,
                  long long xs_r, long long ys_row, long long ys_r, int vec, size_t smem,
                  cudaStream_t stream) {
    cudaError_t err = grant_smem<Kernel>(smem);
    if (err != cudaSuccess) return (int)err;
    Kernel<<<p, kLanes, smem, stream>>>(
        (const int32_t*)col, (const V*)val, (const int32_t*)win_map, (const int32_t*)tile_ptr,
        (const int32_t*)pages, pmax, (const float*)x, (float*)y, sigma, capw, win_rel, nends,
        m, n, R, xs_c, xs_r, ys_row, ys_r, vec);
    return (int)cudaGetLastError();
}

template <typename V, int RC>
int launch_rc(const void* col, const void* val, const void* win_map, const void* tile_ptr,
              const void* pages, int pmax, int packed, int staged, const void* x, void* y,
              int p, int sigma, int capw, int win_rel, int nends, int m, int n, int R,
              long long xs_c, long long xs_r, long long ys_row, long long ys_r, int vec,
              cudaStream_t stream) {
    const size_t smem = smem_bytes(sigma, nends, RC, packed, staged ? pmax : 0);
#define K2_LAUNCH_ARGS                                                                        \
    col, val, win_map, tile_ptr, pages, pmax, x, y, p, sigma, capw, win_rel, nends, m, n, R, \
        xs_c, xs_r, ys_row, ys_r, vec, smem, stream
    if (packed) {
        if (staged) return launch_kernel<&csr5_spmm_packed_kernel<V, RC, true>, V>(K2_LAUNCH_ARGS);
        return launch_kernel<&csr5_spmm_packed_kernel<V, RC, false>, V>(K2_LAUNCH_ARGS);
    }
    if (staged) return launch_kernel<&csr5_spmm_tile_kernel<V, RC, true>, V>(K2_LAUNCH_ARGS);
    return launch_kernel<&csr5_spmm_tile_kernel<V, RC, false>, V>(K2_LAUNCH_ARGS);
#undef K2_LAUNCH_ARGS
}

template <typename V>
int launch(const void* col, const void* val, const void* win_map, const void* tile_ptr,
           const void* pages, int pmax, int packed, int staged, const void* x, void* y, int p,
           int sigma, int capw, int win_rel, int nends, int m, int n, int R, long long xs_c,
           long long xs_r, long long ys_row, long long ys_r, int rc, int vec, void* stream) {
    if (p <= 0 || R <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
#define K2_AT(RCV)                                                                           \
    return launch_rc<V, RCV>(col, val, win_map, tile_ptr, pages, pmax, packed, staged, x, y, \
                             p, sigma, capw, win_rel, nends, m, n, R, xs_c, xs_r, ys_row,    \
                             ys_r, vec, s)
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
// values, in chunks of rc in {1, 2, 4, 8, 16} right-hand sides. vec: rows
// of X and Y are 16 B aligned runs (layout "nr", R % 4 == 0, X 16 B
// aligned). packed: col is col_packed (K2p); else col is col_idx_tiles
// (K2). staged: X is staged in shared memory through the (p, pmax) page
// lists `pages` (packed, or pages_contig); else X is gathered, and pages is
// read only when packed. Returns the CUDA error code of the launch (0 on
// success).
int csr5_spmm_f32(const void* col, const void* val, const void* win_map,
                  const void* tile_ptr, const void* pages, int pmax, int packed, int staged,
                  const void* x, void* y, int p, int sigma, int capw, int win_rel, int nends,
                  int m, int n, int R, long long xs_c, long long xs_r, long long ys_row,
                  long long ys_r, int rc, int vec, void* stream) {
    return launch<float>(col, val, win_map, tile_ptr, pages, pmax, packed, staged, x, y, p,
                         sigma, capw, win_rel, nends, m, n, R, xs_c, xs_r, ys_row, ys_r, rc,
                         vec, stream);
}

// The same with bfloat16 values (products and sums stay float32).
int csr5_spmm_bf16(const void* col, const void* val, const void* win_map,
                   const void* tile_ptr, const void* pages, int pmax, int packed, int staged,
                   const void* x, void* y, int p, int sigma, int capw, int win_rel, int nends,
                   int m, int n, int R, long long xs_c, long long xs_r, long long ys_row,
                   long long ys_r, int rc, int vec, void* stream) {
    return launch<__nv_bfloat16>(col, val, win_map, tile_ptr, pages, pmax, packed, staged, x,
                                 y, p, sigma, capw, win_rel, nends, m, n, R, xs_c, xs_r,
                                 ys_row, ys_r, rc, vec, stream);
}

const char* csr5_spmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
