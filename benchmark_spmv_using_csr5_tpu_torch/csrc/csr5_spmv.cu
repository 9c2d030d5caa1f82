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
// Deferred: vectorised or TMA loads, and several tiles per block.

#include "csr5_tile.cuh"

namespace {

using namespace csr5;

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
    const float run = tile_products(col + tile0, val + tile0, x, sigma, l, prefix);
    lane_carry(run, l, warp_total, carry);
    window_pass(win_map + (size_t)t * capw, tile_ptr[t], capw, win_rel, prefix, carry, y, l);
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
                        int sigma, int capw, int win_rel, int pmax) {
    extern __shared__ float smem[];
    float* prefix = smem;                  // (sigma, 128) within-lane prefixes
    float* carry = smem + sigma * kLanes;  // (128,) exclusive lane carries
    __shared__ float warp_total[kWarps];

    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const size_t tile0 = (size_t)t * sigma * kLanes;
    const float run = tile_products_packed(colp + tile0 / 2, val + tile0, pages + (size_t)t * pmax,
                                           x, sigma, l, prefix);
    lane_carry(run, l, warp_total, carry);
    window_pass(win_map + (size_t)t * capw, tile_ptr[t], capw, win_rel, prefix, carry, y, l);
}

template <typename V>
int launch(const void* col, const void* val, const void* win_map,
           const void* tile_ptr, const void* x, void* y, int p, int sigma,
           int capw, int win_rel, void* stream) {
    if (p <= 0) return 0;
    const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(float);
    const cudaError_t err = grant_smem<&csr5_spmv_tile_kernel<V>>(smem);
    if (err != cudaSuccess) return (int)err;
    csr5_spmv_tile_kernel<V><<<p, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)col, (const V*)val, (const int32_t*)win_map,
        (const int32_t*)tile_ptr, (const float*)x, (float*)y, sigma, capw,
        win_rel);
    return (int)cudaGetLastError();
}

template <typename V>
int launch_packed(const void* colp, const void* val, const void* win_map,
                  const void* tile_ptr, const void* pages, const void* x, void* y,
                  int p, int sigma, int capw, int win_rel, int pmax, void* stream) {
    if (p <= 0) return 0;
    const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(float);
    const cudaError_t err = grant_smem<&csr5_spmv_packed_kernel<V>>(smem);
    if (err != cudaSuccess) return (int)err;
    csr5_spmv_packed_kernel<V><<<p, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)colp, (const V*)val, (const int32_t*)win_map,
        (const int32_t*)tile_ptr, (const int32_t*)pages, (const float*)x, (float*)y,
        sigma, capw, win_rel, pmax);
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

// K1p: the same product streaming col_packed (p, sigma/2, 128) int32 and the
// page lists pages (p, pmax) int32, sigma % 16 == 0, pmax <= 512.
int csr5_spmv_packed_f32(const void* colp, const void* val, const void* win_map,
                         const void* tile_ptr, const void* pages, const void* x, void* y,
                         int p, int sigma, int capw, int win_rel, int pmax, void* stream) {
    return launch_packed<float>(colp, val, win_map, tile_ptr, pages, x, y, p, sigma, capw,
                                win_rel, pmax, stream);
}

int csr5_spmv_packed_bf16(const void* colp, const void* val, const void* win_map,
                          const void* tile_ptr, const void* pages, const void* x, void* y,
                          int p, int sigma, int capw, int win_rel, int pmax, void* stream) {
    return launch_packed<__nv_bfloat16>(colp, val, win_map, tile_ptr, pages, x, y, p, sigma,
                                        capw, win_rel, pmax, stream);
}

const char* csr5_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
