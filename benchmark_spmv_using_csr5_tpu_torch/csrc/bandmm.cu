// K7 for Hopper (sm_90a): dense band-block SpMM. For each 128-row block b
// of the (m_pad, K) dense plane, whose rows cover the column window
// [c0[b] * 128, c0[b] * 128 + K):
//
//   Y[b*128 + i, r] = sum_k A[b*128 + i, k] * X[c0[b]*128 + k, r]
//
// with columns >= n read as 0 (in place of the JAX wrapper's padded copy
// of X^T), alpha folded into X by the caller.
//
// Replaces the TPU kernel benchmark_spmv_using_csr5_tpu/ops/bandmm.py
// ::_bandmm_kernel, launched by _bandmm_jit (one (R, K) @ (K, 128)
// contraction per block on the TPU's matrix unit).
//
// Precision, as bandmm_spmm defines it (BF16_OPS below):
//   - bf16 plane, "default": X rounded to bf16 (round to nearest even);
//   - f32 plane, "default": A and X both rounded to bf16, as the TPU's
//     DEFAULT matmul precision does;
//   - f32 plane, "highest": exact float32 products, __fmul_rn + __fadd_rn.
// In the two bf16 modes a product of two bf16 values is exact in float32,
// so fmaf(a, x, acc) rounds once, exactly as __fadd_rn(acc, __fmul_rn(a, x))
// does, and is used there. No TF32 anywhere, no tensor cores yet.
//
// What bounds it: HBM bytes of the dense plane (m_pad * K * 2 or 4 B, read
// once for up to 16 right-hand sides; 384 MB in bf16 at banded500k) and,
// close behind, the float32 FMA issue (2 * m_pad * K * R flops on CUDA
// cores). What the design does:
//   - one block of 128 threads per 128-row block, one thread per row,
//     RC (<= 16) float32 accumulators per thread; R > 16 runs in further
//     chunks (gridDim.y), each reading the plane again;
//   - the plane is (m_pad, K) row-major, so a thread reading its own row
//     would stride K * 2 or K * 4 B across the warp. It is staged instead,
//     128 B of each row at a time (KC = 64 bf16 or 32 f32 columns): each
//     thread issues 16 B loads, a warp reads 4 rows x 128 B, and the chunk
//     lands in shared memory as float32 with a row pitch of KC + 1 floats,
//     so the compute loop (thread i reads row i) is free of bank conflicts;
//   - the matching (KC, RC) window of X is staged beside it (contiguous
//     along r for layout "nr", along k for "rn"), masked to 0 past n and
//     past R, and read as a broadcast.
//
// Deferred: tensor cores (mma.sync / wgmma on bf16 operands; the f32
// "highest" mode needs 3xbf16 splitting to stay exact), TMA and a
// multi-stage ring so loads overlap the FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows per block of the plane, threads per block

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 B of the plane as float32
__device__ __forceinline__ void unpack(const float* p, float* f) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* f) {
    // a bfloat16 is the high half of a float32; element 0 is the low half
    // of the first word (little endian)
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(ws[i] << 16);
        f[2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
    }
}

template <typename V, int RC, bool BF16_OPS>
__global__ void __launch_bounds__(kRows)
bandmm_kernel(const V* __restrict__ dense, const int32_t* __restrict__ c0,
              const float* __restrict__ x, float* __restrict__ y, int m, int n, int K,
              int R, long long xs_c, long long xs_r, long long ys_row, long long ys_r) {
    constexpr int KC = 128 / sizeof(V);  // plane columns per stage: 128 B of a row
    constexpr int VEC = 16 / sizeof(V);  // elements per 16 B load
    constexpr int PARTS = KC / VEC;      // 16 B loads per row and stage (8)
    __shared__ float As[kRows][KC + 1];
    __shared__ __align__(16) float Xs[KC][RC];

    const int b = blockIdx.x;
    const int r0 = blockIdx.y * RC;
    const int rc = R - r0 < RC ? R - r0 : RC;
    const int tid = threadIdx.x;
    const long long cbase = (long long)c0[b] * kRows;
    const V* ablk = dense + (size_t)b * kRows * K;

    float acc[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[c] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
        // stage A: 128 rows x KC columns
        for (int v = tid; v < kRows * PARTS; v += kRows) {
            const int row = v / PARTS;
            const int part = v % PARTS;
            float f[VEC];
            unpack(ablk + (size_t)row * K + k0 + part * VEC, f);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                if constexpr (BF16_OPS && sizeof(V) == 4) f[j] = round_bf16(f[j]);
                As[row][part * VEC + j] = f[j];
            }
        }
        // stage the X window: rows cbase+k0 .. +KC, rhs r0 .. r0+RC
        for (int e = tid; e < KC * RC; e += kRows) {
            int k, c;
            if (xs_r == 1) {
                k = e / RC;
                c = e % RC;
            } else {
                c = e / KC;
                k = e % KC;
            }
            const long long colx = cbase + k0 + k;
            float v = 0.f;
            if (colx < n && c < rc) v = __ldg(x + colx * xs_c + (long long)(r0 + c) * xs_r);
            if constexpr (BF16_OPS) v = round_bf16(v);
            Xs[k][c] = v;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
            const float av = As[tid][k];
#pragma unroll
            for (int c = 0; c < RC; ++c) {
                if constexpr (BF16_OPS)
                    acc[c] = fmaf(av, Xs[k][c], acc[c]);
                else
                    acc[c] = __fadd_rn(acc[c], __fmul_rn(av, Xs[k][c]));
            }
        }
        __syncthreads();
    }

    const long long row = (long long)b * kRows + tid;
    if (row < m) {
        float* yr = y + row * ys_row + (long long)r0 * ys_r;
#pragma unroll
        for (int c = 0; c < RC; ++c)
            if (c < rc) yr[(long long)c * ys_r] = acc[c];
    }
}

template <typename V, int RC>
void launch_rc(const void* dense, const void* c0, const void* x, void* y, int m, int n,
               int K, int nblk, int R, long long xs_c, long long xs_r, long long ys_row,
               long long ys_r, int bf16_ops, cudaStream_t s) {
    const dim3 grid((unsigned)nblk, (unsigned)((R + RC - 1) / RC));
    if (bf16_ops)
        bandmm_kernel<V, RC, true><<<grid, kRows, 0, s>>>(
            (const V*)dense, (const int32_t*)c0, (const float*)x, (float*)y, m, n, K, R,
            xs_c, xs_r, ys_row, ys_r);
    else
        bandmm_kernel<V, RC, false><<<grid, kRows, 0, s>>>(
            (const V*)dense, (const int32_t*)c0, (const float*)x, (float*)y, m, n, K, R,
            xs_c, xs_r, ys_row, ys_r);
}

template <typename V>
int launch(const void* dense, const void* c0, const void* x, void* y, int m, int n, int K,
           int nblk, int R, long long xs_c, long long xs_r, long long ys_row, long long ys_r,
           int rc, int bf16_ops, void* stream) {
    if (nblk <= 0 || R <= 0 || m <= 0) return 0;
    if (K <= 0 || K % 128) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
#define K7_AT(RCV)                                                                  \
    launch_rc<V, RCV>(dense, c0, x, y, m, n, K, nblk, R, xs_c, xs_r, ys_row, ys_r, \
                      bf16_ops, s);                                                 \
    break
    switch (rc) {
        case 1: K7_AT(1);
        case 2: K7_AT(2);
        case 4: K7_AT(4);
        case 8: K7_AT(8);
        case 16: K7_AT(16);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K7_AT
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (float32, every row < m and rhs < R written) = A @ X for a float32
// dense band-block plane (m_pad, K) with window pages c0 (nblk,), in chunks
// of rc in {1, 2, 4, 8, 16} right-hand sides. bf16_ops: round A and X to
// bf16 ("default"); 0: exact float32 products ("highest"). Returns the CUDA
// error code of the launch (0 on success).
int bandmm_f32(const void* dense, const void* c0, const void* x, void* y, int m, int n,
               int K, int nblk, int R, long long xs_c, long long xs_r, long long ys_row,
               long long ys_r, int rc, int bf16_ops, void* stream) {
    return launch<float>(dense, c0, x, y, m, n, K, nblk, R, xs_c, xs_r, ys_row, ys_r, rc,
                         bf16_ops, stream);
}

// The same for a bfloat16 plane; X is rounded to bf16 (bf16_ops must be 1:
// "highest" needs a float32 plane).
int bandmm_bf16(const void* dense, const void* c0, const void* x, void* y, int m, int n,
                int K, int nblk, int R, long long xs_c, long long xs_r, long long ys_row,
                long long ys_r, int rc, int bf16_ops, void* stream) {
    if (!bf16_ops) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(dense, c0, x, y, m, n, K, nblk, R, xs_c, xs_r, ys_row,
                                 ys_r, rc, 1, stream);
}

const char* bandmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
