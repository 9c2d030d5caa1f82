// K5 and K6 for Hopper (sm_90a): DIA SpMV and SpMM,
//   y[i]    = sum_k data[k, i] * x[i + off_k]        (K5)
//   Y[i, r] = sum_k data[k, i] * X[i + off_k, r]     (K6, X (n, R), Y (m, R))
// with the value plane in float32 or bfloat16 and every product and sum in
// float32. alpha is folded into x by the caller.
//
// Replaces the TPU kernels of benchmark_spmv_using_csr5_tpu/ops/dia.py:
//   K5: _dia_kernel and _dia_kernel_streamx, launched by _dia_spmv_jit;
//   K6: _dia_spmm_kernel and _dia_spmm_kernel_streamx, launched by
//       _dia_spmm_jit.
// The streamed-x and whole-x variants exist on the TPU only because x has to
// fit VMEM; here x is read from global memory through L1/L2, so one kernel
// covers both. The TPU kernels bake each offset into the code (a static
// shift network per sparsity pattern); here the offsets are runtime values,
// loaded once per block into shared memory, so no matrix needs a rebuild.
// Both value layouts are taken: interleaved (m_pad/128, nd, 128), where
// element (k, i) is at ((i >> 7) * nd + k) * 128 + (i & 127), and diag-major
// (nd, m_pad), where it is at k * m_pad + i. Both are "base(i) + k * step".
//
// What bounds them: HBM bytes. The value plane is the whole stream (4 B or
// 2 B per stored element, zeros of partial diagonals included) and each
// element is used for 2 flops (2R in K6). x is read nd times per row, but
// neighbouring diagonals hit the same lines, so x and y cost about one pass
// each from HBM.
//
// What the design does about it:
//   - K5: each thread owns 4 consecutive rows and reads their values of one
//     diagonal with one 16 B (float32) or 8 B (bfloat16) load; a warp reads
//     128 rows, i.e. 512 B or 256 B contiguous per diagonal in either
//     layout. y is written once per row, with one 16 B store where the 4
//     rows are all inside the matrix: no atomics and no zeroing.
//   - K6: one thread per row; each value is loaded once per chunk of up to
//     16 right-hand sides and applied to that many float32 accumulators in
//     registers (R <= 16: the plane is read once for all R). X rows are read
//     with 16 B loads when R is a multiple of 4.
//   - x reads are masked to 0 <= i + off_k < n instead of a padded copy of x.
//   - __fmul_rn/__fadd_rn keep each product rounded on its own and the sum in
//     diagonal order, as the plain PyTorch version computes it, so the two
//     agree bit for bit.
// Deferred: TMA loads of the plane, several row groups per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;        // rows of one interleaved group
constexpr int kSpmvThreads = 128;  // K5 block
constexpr int kRowsPerThread = 4;  // K5 rows per thread
constexpr int kSpmmThreads = 128;  // K6 block, one row per thread
constexpr int kMaxChunk = 16;      // K6 accumulators per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four consecutive values of one diagonal (16 B aligned for float32, 8 B
// for bfloat16), widened to float32
__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    // a bfloat16 is the high half of a float32; element 0 is the low half
    // of the first word (little endian)
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ float madd(float acc, float v, float x) {
    return __fadd_rn(acc, __fmul_rn(v, x));
}

// element (0, i) of the plane and the distance from diagonal k to k+1
__device__ __forceinline__ void plane_index(int i, int nd, int m_pad, int interleaved,
                                            size_t* base, size_t* step) {
    if (interleaved) {
        *base = (size_t)(i >> 7) * nd * kLanes + (i & (kLanes - 1));
        *step = kLanes;
    } else {
        *base = (size_t)i;
        *step = (size_t)m_pad;
    }
}

template <typename V>
__global__ void __launch_bounds__(kSpmvThreads)
dia_spmv_kernel(const V* __restrict__ data, const int32_t* __restrict__ offsets,
                const float* __restrict__ x, float* __restrict__ y, int m, int n,
                int nd, int m_pad, int interleaved) {
    extern __shared__ int32_t s_off[];
    for (int k = threadIdx.x; k < nd; k += kSpmvThreads) s_off[k] = offsets[k];
    __syncthreads();

    const long long first = ((long long)blockIdx.x * kSpmvThreads + threadIdx.x) * kRowsPerThread;
    if (first >= m) return;
    const int i0 = (int)first;
    size_t base, step;
    plane_index(i0, nd, m_pad, interleaved, &base, &step);

    // rows m..m_pad-1 of the plane are zero, so the 4-row loads never leave
    // it; only the stores are cut at m
    float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < nd; ++k) {
        const float4 v = load4(data + base + (size_t)k * step);
        const int j = i0 + s_off[k];
        float xv[kRowsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            const int jr = j + r;
            xv[r] = (jr >= 0 && jr < n) ? __ldg(x + jr) : 0.f;
        }
        acc[0] = madd(acc[0], v.x, xv[0]);
        acc[1] = madd(acc[1], v.y, xv[1]);
        acc[2] = madd(acc[2], v.z, xv[2]);
        acc[3] = madd(acc[3], v.w, xv[3]);
    }
    if (i0 + kRowsPerThread <= m) {
        *reinterpret_cast<float4*>(y + i0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
            if (i0 + r < m) y[i0 + r] = acc[r];
    }
}

// RC: accumulators per thread (a power of two <= 16); the chunk of
// right-hand sides [r0, r0 + rc) uses the first rc of them. vec: R is a
// multiple of 4 and X, Y are 16 B aligned, so rows move as float4.
template <typename V, int RC>
__global__ void __launch_bounds__(kSpmmThreads)
dia_spmm_kernel(const V* __restrict__ data, const int32_t* __restrict__ offsets,
                const float* __restrict__ x, float* __restrict__ y, int m, int n,
                int nd, int m_pad, int interleaved, int R, int vec) {
    extern __shared__ int32_t s_off[];
    for (int k = threadIdx.x; k < nd; k += kSpmmThreads) s_off[k] = offsets[k];
    __syncthreads();

    const long long row = (long long)blockIdx.x * kSpmmThreads + threadIdx.x;
    if (row >= m) return;
    const int i = (int)row;
    size_t base, step;
    plane_index(i, nd, m_pad, interleaved, &base, &step);

    for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = R - r0 < RC ? R - r0 : RC;
        float acc[RC];
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[c] = 0.f;
        for (int k = 0; k < nd; ++k) {
            const int j = i + s_off[k];
            if (j < 0 || j >= n) continue;  // the plane holds 0 there
            const float v = to_f32(data[base + (size_t)k * step]);
            const float* xr = x + (size_t)j * R + r0;
            if constexpr (RC >= 4) {
                if (vec) {
#pragma unroll
                    for (int c = 0; c < RC; c += 4) {
                        if (c < rc) {
                            const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + c));
                            acc[c] = madd(acc[c], v, xv.x);
                            acc[c + 1] = madd(acc[c + 1], v, xv.y);
                            acc[c + 2] = madd(acc[c + 2], v, xv.z);
                            acc[c + 3] = madd(acc[c + 3], v, xv.w);
                        }
                    }
                    continue;
                }
            }
#pragma unroll
            for (int c = 0; c < RC; ++c)
                if (c < rc) acc[c] = madd(acc[c], v, __ldg(xr + c));
        }
        float* yr = y + (size_t)i * R + r0;
        if constexpr (RC >= 4) {
            if (vec) {
#pragma unroll
                for (int c = 0; c < RC; c += 4)
                    if (c < rc)
                        *reinterpret_cast<float4*>(yr + c) =
                            make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
                continue;
            }
        }
#pragma unroll
        for (int c = 0; c < RC; ++c)
            if (c < rc) yr[c] = acc[c];
    }
}

template <typename V>
int launch_spmv(const void* data, const void* offsets, const void* x, void* y, int m,
                int n, int nd, int m_pad, int interleaved, void* stream) {
    if (m <= 0) return 0;
    const long long rows_per_block = (long long)kSpmvThreads * kRowsPerThread;
    const unsigned blocks = (unsigned)((m + rows_per_block - 1) / rows_per_block);
    dia_spmv_kernel<V><<<blocks, kSpmvThreads, nd * sizeof(int32_t), (cudaStream_t)stream>>>(
        (const V*)data, (const int32_t*)offsets, (const float*)x, (float*)y, m, n, nd,
        m_pad, interleaved);
    return (int)cudaGetLastError();
}

template <typename V, int RC>
void spmm_at(const void* data, const void* offsets, const void* x, void* y, int m, int n,
             int nd, int m_pad, int interleaved, int R, int vec, cudaStream_t stream) {
    const unsigned blocks = (unsigned)(((long long)m + kSpmmThreads - 1) / kSpmmThreads);
    dia_spmm_kernel<V, RC><<<blocks, kSpmmThreads, nd * sizeof(int32_t), stream>>>(
        (const V*)data, (const int32_t*)offsets, (const float*)x, (float*)y, m, n, nd,
        m_pad, interleaved, R, vec);
}

template <typename V>
int launch_spmm(const void* data, const void* offsets, const void* x, void* y, int m,
                int n, int nd, int m_pad, int interleaved, int R, int vec, void* stream) {
    if (m <= 0 || R <= 0) return 0;
    const int want = R < kMaxChunk ? R : kMaxChunk;
    const cudaStream_t s = (cudaStream_t)stream;
    if (want <= 1)
        spmm_at<V, 1>(data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec, s);
    else if (want <= 2)
        spmm_at<V, 2>(data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec, s);
    else if (want <= 4)
        spmm_at<V, 4>(data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec, s);
    else if (want <= 8)
        spmm_at<V, 8>(data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec, s);
    else
        spmm_at<V, kMaxChunk>(data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec, s);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (m float32, written whole) = A @ x for a DIA plane of float32 values.
// Returns the CUDA error code of the launch (0 on success).
int dia_spmv_f32(const void* data, const void* offsets, const void* x, void* y, int m,
                 int n, int nd, int m_pad, int interleaved, void* stream) {
    return launch_spmv<float>(data, offsets, x, y, m, n, nd, m_pad, interleaved, stream);
}

// The same with bfloat16 values (products and sums stay float32).
int dia_spmv_bf16(const void* data, const void* offsets, const void* x, void* y, int m,
                  int n, int nd, int m_pad, int interleaved, void* stream) {
    return launch_spmv<__nv_bfloat16>(data, offsets, x, y, m, n, nd, m_pad, interleaved,
                                      stream);
}

// Y (m, R) float32 row-major, written whole, = A @ X for X (n, R) row-major.
int dia_spmm_f32(const void* data, const void* offsets, const void* x, void* y, int m,
                 int n, int nd, int m_pad, int interleaved, int R, int vec, void* stream) {
    return launch_spmm<float>(data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec,
                              stream);
}

int dia_spmm_bf16(const void* data, const void* offsets, const void* x, void* y, int m,
                  int n, int nd, int m_pad, int interleaved, int R, int vec, void* stream) {
    return launch_spmm<__nv_bfloat16>(data, offsets, x, y, m, n, nd, m_pad, interleaved, R,
                                      vec, stream);
}

const char* dia_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
