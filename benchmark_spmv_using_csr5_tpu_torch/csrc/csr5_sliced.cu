// K3 for Hopper (sm_90a): row-sliced CSR5 SpMV, y += A @ x over every row
// slice of a SlicedCSR5 in ONE launch (the tile algorithm: csr5_tile.cuh).
//
// Replaces the TPU kernel benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py
// ::_spmv_kernel in xwin mode (:247-288, flush :627-637), which
// ops/bigslice.py::_sliced_spmv_jit launches once per slice. There each
// slice DMAs its page-aligned column window of x into VMEM, runs its tiles
// in order and copies its y rows over a shared buffer; the copy is right
// only because the slices run one after another.
//
// Here the grid covers the tiles of every slice. A device table holds one
// descriptor per slice (its planes, first global tile, tile count, capw,
// map mode, column mode, value dtype, first row r0 and first column c0).
// Block b finds its slice k by binary search over the first tiles, and runs
// K1's tile algorithm on tile b - tile0_k with x read at c0_k + col and y
// added at r0_k + row, with atomics, into one zeroed y of max_k(r0_k +
// m_pad_k) rows. Rows past a slice's end receive only zero differences and
// are skipped, and adding instead of copying makes the order of the slices
// irrelevant. Slices that carry col_packed take K1p's decode.
//
// What bounds it: HBM bytes, as K1 and K1p: each slice's planes are read
// once (6 B/nnz raw with bf16 values, 4 B/nnz packed), plus the window maps
// and x and y. The same bytes as one K1 pass over the whole matrix.
//
// Every per-element offset is a size_t inside a slice's own planes; row and
// column indices stay below 2^31 (the wrapper checks).

#include "csr5_tile.cuh"

namespace {

using namespace csr5;

// One slice, as the wrapper writes it: 16 int64 words (pointers as
// integers), ops/bigslice_kernel.py::DESC_FIELDS.
struct SliceDesc {
    long long col;       // col_idx_tiles (p, sigma, 128) or col_packed (p, sigma/2, 128)
    long long val;       // val_tiles (p, sigma, 128) float32 or bfloat16
    long long win_map;   // (p, capw) int32
    long long tile_ptr;  // (p + 1,) int32
    long long pages;     // (p, pmax) int32 (read when packed)
    long long tile0;     // first global tile of the slice
    long long p;
    long long capw;
    long long win_rel;
    long long packed;
    long long bf16;
    long long pmax;
    long long r0;
    long long c0;
    long long pad0, pad1;
};

template <typename V>
__device__ __forceinline__ float slice_products(const SliceDesc& sd, int t, int sigma,
                                                const float* x, int l, float* prefix) {
    const size_t tile0 = (size_t)t * sigma * kLanes;
    const V* val = reinterpret_cast<const V*>(sd.val) + tile0;
    if (sd.packed)
        return tile_products_packed(reinterpret_cast<const int32_t*>(sd.col) + tile0 / 2, val,
                                    reinterpret_cast<const int32_t*>(sd.pages) + (size_t)t * sd.pmax,
                                    x, sigma, l, prefix);
    return tile_products(reinterpret_cast<const int32_t*>(sd.col) + tile0, val, x, sigma, l,
                         prefix);
}

__global__ void __launch_bounds__(kLanes)
csr5_sliced_kernel(const SliceDesc* __restrict__ table, int nslices,
                   const float* __restrict__ x, float* __restrict__ y, int sigma) {
    extern __shared__ float smem[];
    float* prefix = smem;                  // (sigma, 128) within-lane prefixes
    float* carry = smem + sigma * kLanes;  // (128,) exclusive lane carries
    __shared__ float warp_total[kWarps];
    __shared__ SliceDesc sd;

    // the slice of this block, the last k with tile0_k <= b: one thread
    // searches the descriptors and copies its slice's into shared memory
    const long long b = blockIdx.x;
    const int l = threadIdx.x;
    if (l == 0) {
        int lo = 0, hi = nslices - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (table[mid].tile0 <= b) lo = mid; else hi = mid - 1;
        }
        sd = table[lo];
    }
    __syncthreads();
    const int t = (int)(b - sd.tile0);
    const float* xk = x + sd.c0;  // the slice's column window
    const float run = sd.bf16 ? slice_products<__nv_bfloat16>(sd, t, sigma, xk, l, prefix)
                              : slice_products<float>(sd, t, sigma, xk, l, prefix);
    lane_carry(run, l, warp_total, carry);
    const int capw = (int)sd.capw;
    const int32_t* wm = reinterpret_cast<const int32_t*>(sd.win_map) + (size_t)t * capw;
    const int rs = reinterpret_cast<const int32_t*>(sd.tile_ptr)[t];
    window_pass(wm, rs, capw, (int)sd.win_rel, prefix, carry, y + sd.r0, l);
}

}  // namespace

extern "C" {

// y (out_rows * 128 float32, zeroed by the caller) += A @ x over the
// nslices descriptors of table (device memory), total_tiles blocks in all.
// Returns the CUDA error code of the launch (0 on success).
int csr5_sliced_spmv(const void* table, int nslices, int total_tiles, const void* x, void* y,
                     int sigma, void* stream) {
    if (total_tiles <= 0 || nslices <= 0) return 0;
    const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(float);
    const cudaError_t err = grant_smem<&csr5_sliced_kernel>(smem);
    if (err != cudaSuccess) return (int)err;
    csr5_sliced_kernel<<<total_tiles, kLanes, smem, (cudaStream_t)stream>>>(
        (const SliceDesc*)table, nslices, (const float*)x, (float*)y, sigma);
    return (int)cudaGetLastError();
}

const char* csr5_sliced_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
