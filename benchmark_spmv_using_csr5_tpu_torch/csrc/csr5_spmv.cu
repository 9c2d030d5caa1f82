// K1 and K1p for Hopper (sm_90a): CSR5 SpMV, y += A @ x, one (sigma, 128)
// tile per block, one thread per lane (the tile algorithm: csr5_tile.cuh).
//
// K1 replaces the TPU kernel benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py
// ::_spmv_kernel at R=1 (with its _pass2_scalar window pass), built by
// _make_pallas_call and called by _csr5_spmv_pallas_jit. K1p replaces the
// same kernel with packed=True (its column decode, csr5_kernel.py:311-323),
// which _csr5_spmv_pallas_jit selects whenever col_packed exists (:816-820).
//
// What bounds them: HBM bytes. Every nonzero is streamed once and used for
// two flops. K1 reads a 4 B int32 column and a 4 B float32 or 2 B bfloat16
// value (6 B/nnz with bf16 values); K1p reads the packed column plane, two
// uint16 codes `lane | local_page << 7` per int32 word (rows s and
// s + sigma/2 of the tile), so 4 B/nnz with bf16 values. Thread l of a block
// reads element (t, s, l) for each s, so each warp reads 128 B (i32) or
// 64 B (bf16) contiguous segments: the planes are already laid out for
// coalesced loads. K1p decodes column = pages[local] * 128 + lane, with the
// tile's page list (pmax <= 512 int32) read through the read-only cache. x is
// gathered through the read-only cache; on banded matrices neighbouring
// lanes hit the same lines.
//
// How K1 issues its loads (tile_products_grouped): at kron23, a power-law
// graph whose x (33.5 MB) L2 mostly holds, one gather of x waiting on its
// own column load took 3.82 ms a SpMV. K1 now forms a lane's products in
// groups of kUnroll = 8 rows: the group's 8 gathers go out together, then
// the next group's column and value loads, then the group's adds in s
// order; 2.69 ms (NVIDIA H100 80GB HBM3, 700 W). Every variant that keeps
// eight or more gathers in flight (kUnroll 4-16, 5-10 blocks an SM) lands
// at 2.69-2.71 ms: L2's rate of single-sector reads, about 96 G gathers a
// second, bounds it now, not the wait on each load. Fewer blocks an SM
// alone (shared memory padded to 11 or 7 blocks) moves nothing.
// __launch_bounds__(128, kMinBlocks = 8) lets a thread take the 56-62
// registers the group ahead needs (9 blocks an SM at kron23) and keeps a
// larger kUnroll or a tighter bound, which spill, from being chosen. Not
// taken, each measured beside the groups: K4's row-end prefix (1.4 %
// slower at kron23 and 2.9 % at banded500k: marking the row ends costs a
// tile a win_map pass and three barriers more), and plain stores for the
// rows inside a tile (0.3 % slower at kron23).
//
// Where the loads sit in the caches (ResidentLoads, csr5_tile.cuh): on a
// power-law graph the gathers of x hit no pattern, and when the planes
// stream through L1 and L2 at normal priority beside them, every gather
// pays a trip to device memory even where x would fit L2. So the planes,
// read once, skip L1 and leave L2 first, and x's gathers take an evict-last
// policy on the share of x's lines that the persisting set-aside holds
// (`share`, from the wrapper: ops/csr5_kernel.py::resident_share).
//
// Why atomics: the TPU kernel adds a row that straddles tiles correctly
// only because its grid runs tiles in order on one core and y stays in VMEM
// across grid steps. CUDA blocks run in parallel in no order, so the first
// and last row of a tile (and a long row spanning many tiles) receive
// partial sums from several blocks. At most capw atomics per tile of
// sigma * 128 nonzeros, on distinct addresses except at tile seams. The
// order of those additions changes from run to run; on integer-valued
// data every partial sum is an integer below 2^24 and the result is exact.
//
// The dynamic shared-memory limit is granted once per kernel instance and
// device (grant_smem), and only above 48 KB: a launch is then nothing but
// the launch, as a captured CUDA graph of a solver needs.
//
// Fewer L2 sectors per gather come from the order of x, not from this file:
// where a matrix's column counts are skewed, the wrapper launches K1 on a
// column plane relabelled by count and on x' = x[relabel_perm]
// (ops/csr5_kernel.py::csr5_spmv_cuda), so hot values share sectors; 2.24 ms
// at kron23 against 2.73 on the original plane (NVIDIA H100 80GB HBM3, 700
// W). Gathers past the hot prefix of x' taking L1::no_allocate read 2.37 ms:
// not taken. Deferred: vectorised or TMA loads, several tiles per block.

#include "csr5_error.cuh"
#include "csr5_tile.cuh"

namespace {

using namespace csr5;

// K1's rows per group: a lane's x gathers of a group go out together, and
// the next group's plane loads are in flight during its adds
constexpr int kUnroll = 8;
// K1's resident blocks per SM that the compiler must allow, which caps a
// thread's registers at 65,536 / (128 * kMinBlocks)
constexpr int kMinBlocks = 8;

// Step 1 of K1 (csr5_tile.cuh::tile_products, with the same products and
// the same running sum in s order) in groups of kUnroll rows, one group
// ahead: the group's kUnroll x gathers go out together, then the next
// group's column and value loads, then the group's adds; sigma % kUnroll
// rows take a remainder loop.
template <typename V>
__device__ __forceinline__ float tile_products_grouped(const int32_t* __restrict__ col,
                                                       const V* __restrict__ val,
                                                       const float* __restrict__ x, int sigma,
                                                       int l, float* prefix,
                                                       const ResidentLoads& ld) {
    const int32_t* cl = col + l;
    const V* vl = val + l;
    const int full = sigma - sigma % kUnroll;  // rows in whole groups
    // the plane loads of rows s .. s + kUnroll - 1 of this lane
    auto load = [&](int s, int (&c)[kUnroll], V (&v)[kUnroll]) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            c[u] = ld.plane(cl + (s + u) * kLanes);
            v[u] = ld.plane(vl + (s + u) * kLanes);
        }
    };
    int c0[kUnroll];
    V v0[kUnroll];
    if (full > 0) load(0, c0, v0);
    float run = 0.f;
    for (int s = 0; s < full; s += kUnroll) {
        float xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) xv[u] = ld.gather(x + c0[u]);
        int c1[kUnroll];
        V v1[kUnroll];
        const bool more = s + kUnroll < full;
        if (more) load(s + kUnroll, c1, v1);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            run = __fadd_rn(run, __fmul_rn(to_f32(v0[u]), xv[u]));
            prefix[(s + u) * kLanes + l] = run;
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
        const int e = s * kLanes + l;
        run = __fadd_rn(run, __fmul_rn(to_f32(ld.plane(val + e)), ld.gather(x + ld.plane(col + e))));
        prefix[e] = run;
    }
    return run;
}

template <typename V>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
csr5_spmv_tile_kernel(const int32_t* __restrict__ col,
                      const V* __restrict__ val,
                      const int32_t* __restrict__ win_map,
                      const int32_t* __restrict__ tile_ptr,
                      const float* __restrict__ x,
                      float* __restrict__ y,
                      int sigma, int capw, int win_rel, float share) {
    extern __shared__ float smem[];
    float* prefix = smem;                  // (sigma, 128) within-lane prefixes
    float* carry = smem + sigma * kLanes;  // (128,) exclusive lane carries
    __shared__ float warp_total[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const size_t tile0 = (size_t)t * sigma * kLanes;
    const ResidentLoads ld(share);
    const float run = tile_products_grouped(col + tile0, val + tile0, x, sigma, l, prefix, ld);
    lane_carry(run, l, warp_total, carry);
    window_pass(win_map + (size_t)t * capw, ld.plane(tile_ptr + t), capw, win_rel, prefix, carry,
                y, l, ld);
}

template <typename V>
__global__ void __launch_bounds__(kLanes)
csr5_spmv_packed_kernel(const int32_t* __restrict__ colp,
                        const V* __restrict__ val,
                        const int32_t* __restrict__ win_map,
                        const int32_t* __restrict__ tile_ptr,
                        const int32_t* __restrict__ pages,
                        const float* __restrict__ x,
                        float* __restrict__ y,
                        int sigma, int capw, int win_rel, int pmax, float share) {
    extern __shared__ float smem[];
    float* prefix = smem;                  // (sigma, 128) within-lane prefixes
    float* carry = smem + sigma * kLanes;  // (128,) exclusive lane carries
    __shared__ float warp_total[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const size_t tile0 = (size_t)t * sigma * kLanes;
    const ResidentLoads ld(share);
    const float run = tile_products_packed(colp + tile0 / 2, val + tile0, pages + (size_t)t * pmax,
                                           x, sigma, l, prefix, ld);
    lane_carry(run, l, warp_total, carry);
    window_pass(win_map + (size_t)t * capw, ld.plane(tile_ptr + t), capw, win_rel, prefix, carry,
                y, l, ld);
}

template <typename V>
int launch(const void* col, const void* val, const void* win_map,
           const void* tile_ptr, const void* x, void* y, int p, int sigma,
           int capw, int win_rel, float share, void* stream) {
    if (p <= 0) return 0;
    const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(float);
    const cudaError_t err = grant_smem<&csr5_spmv_tile_kernel<V>>(smem);
    if (err != cudaSuccess) return (int)err;
    csr5_spmv_tile_kernel<V><<<p, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)col, (const V*)val, (const int32_t*)win_map,
        (const int32_t*)tile_ptr, (const float*)x, (float*)y, sigma, capw,
        win_rel, share);
    return (int)cudaGetLastError();
}

template <typename V>
int launch_packed(const void* colp, const void* val, const void* win_map,
                  const void* tile_ptr, const void* pages, const void* x, void* y,
                  int p, int sigma, int capw, int win_rel, int pmax, float share,
                  void* stream) {
    if (p <= 0) return 0;
    const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(float);
    const cudaError_t err = grant_smem<&csr5_spmv_packed_kernel<V>>(smem);
    if (err != cudaSuccess) return (int)err;
    csr5_spmv_packed_kernel<V><<<p, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)colp, (const V*)val, (const int32_t*)win_map,
        (const int32_t*)tile_ptr, (const int32_t*)pages, (const float*)x, (float*)y,
        sigma, capw, win_rel, pmax, share);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (m_pad float32, zeroed by the caller) += A @ x for a CSR5 matrix with
// float32 values; share in [0, 1] is the part of x's lines gathered with an
// L2 evict-last policy. Returns the CUDA error code of the launch (0 on
// success).
int csr5_spmv_f32(const void* col, const void* val, const void* win_map,
                  const void* tile_ptr, const void* x, void* y, int p,
                  int sigma, int capw, int win_rel, float share, void* stream) {
    return launch<float>(col, val, win_map, tile_ptr, x, y, p, sigma, capw,
                         win_rel, share, stream);
}

// The same with bfloat16 values (products and sums stay float32).
int csr5_spmv_bf16(const void* col, const void* val, const void* win_map,
                   const void* tile_ptr, const void* x, void* y, int p,
                   int sigma, int capw, int win_rel, float share, void* stream) {
    return launch<__nv_bfloat16>(col, val, win_map, tile_ptr, x, y, p, sigma,
                                 capw, win_rel, share, stream);
}

// K1p: the same product streaming col_packed (p, sigma/2, 128) int32 and the
// page lists pages (p, pmax) int32, sigma % 16 == 0, pmax <= 512.
int csr5_spmv_packed_f32(const void* colp, const void* val, const void* win_map,
                         const void* tile_ptr, const void* pages, const void* x, void* y,
                         int p, int sigma, int capw, int win_rel, int pmax, float share,
                         void* stream) {
    return launch_packed<float>(colp, val, win_map, tile_ptr, pages, x, y, p, sigma, capw,
                                win_rel, pmax, share, stream);
}

int csr5_spmv_packed_bf16(const void* colp, const void* val, const void* win_map,
                          const void* tile_ptr, const void* pages, const void* x, void* y,
                          int p, int sigma, int capw, int win_rel, int pmax, float share,
                          void* stream) {
    return launch_packed<__nv_bfloat16>(colp, val, win_map, tile_ptr, pages, x, y, p, sigma,
                                        capw, win_rel, pmax, share, stream);
}

// out[0] = device dev's L2 bytes (cudaDevAttrL2CacheSize), out[1] the most
// of it a persisting set-aside may take (cudaDevAttrMaxPersistingL2CacheSize).
// Returns a CUDA error code.
int csr5_l2_attributes(int dev, long long* out) {
    int l2 = 0, persisting = 0;
    cudaError_t err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&persisting, cudaDevAttrMaxPersistingL2CacheSize, dev);
    out[0] = l2;
    out[1] = persisting;
    return (int)err;
}

// Raises device dev's persisting L2 set-aside (cudaLimitPersistingL2CacheSize,
// a limit of this process's context) to at least `bytes`; never lowers it.
// *granted is the limit afterwards (the card rounds it to its own unit). The
// calling thread's current device is restored. Returns a CUDA error code.
int csr5_grant_persisting_l2(int dev, long long bytes, long long* granted) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
    size_t now = 0;
    if (err == cudaSuccess) err = cudaDeviceGetLimit(&now, cudaLimitPersistingL2CacheSize);
    if (err == cudaSuccess && (long long)now < bytes) {
        err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)bytes);
        if (err == cudaSuccess) err = cudaDeviceGetLimit(&now, cudaLimitPersistingL2CacheSize);
    }
    if (prev != dev) {
        const cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    *granted = (long long)now;
    return (int)err;
}

}  // extern "C"
