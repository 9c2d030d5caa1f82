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
// contraction per block on the TPU's matrix unit, bf16 operands and
// float32 sums in DEFAULT precision).
//
// Precision, as bandmm_spmm defines it:
//   - bf16 plane, "default": X rounded to bf16 (round to nearest even);
//   - f32 plane, "default": A and X both rounded to bf16, as the TPU's
//     DEFAULT matmul precision does;
//   - f32 plane, "highest": exact float32 products, __fmul_rn + __fadd_rn,
//     summed in k order.
// The two "default" modes are exactly a tensor-core product with bf16
// operands and float32 accumulators: mma.sync m16n8k16 bf16 -> f32. No TF32
// anywhere.
//
// What bounds it: the HBM bytes of the dense plane, m_pad * K * 2 or 4 B
// read once for up to 32 right-hand sides, 16 on a float32 plane (384 MB
// in bf16 at banded500k).
// At R = 16 that is 16 flop per byte, far below the ~295 flop/B where the
// bf16 tensor cores would bound it; on the CUDA cores the same products
// (3.07 G FMAs at banded500k) would take ~92 us of FP32 throughput against a
// 134 us bound, so the plane streams at HBM rate with the arithmetic on the
// tensor cores. What the design does:
//   - one CTA of four warps per 128-row block (gridDim.y: chunks of rc <= 32
//     right-hand sides, the plane read once for R <= 32; rc <= 16 on a
//     float32 plane, whose ring at 32 would leave one CTA per SM);
//   - a ring of three shared-memory slots, filled with cp.async so
//     the loads of the next stages overlap the products of this one (one
//     __syncthreads per stage). A slot holds KC = 64 columns of each of the
//     block's 128 plane rows (16 KB in bf16, 32 KB in f32), kept in the
//     plane's own type, its 16 B chunks XOR-swizzled (swz) so ldmatrix, the
//     f32 fragment loads and the per-row float4 loads of "highest" are all
//     free of bank conflicts; and the slot's (64, rc) window of X as
//     float32, Xs[r][k] with a row pitch of 72 floats (conflict-free
//     B-fragment loads), zero past n and past R by the copy's zero fill,
//     read along k (layout "rn") or along r and transposed (layout "nr");
//   - "default": each warp owns 32 rows (two m16 tiles) by all NT * 8
//     columns (R padded to a multiple of 8). A fragments come from ldmatrix.x4
//     (bf16 plane) or as float2 pairs rounded with cvt.rn.bf16x2.f32 (f32
//     plane); B fragments as float2 pairs of Xs, rounded the same way.
//     mma.sync, not wgmma: the work is memory-bound, ~46 TFLOP/s of bf16
//     keeps pace with HBM at R = 16 and mma.sync gives it with fragments
//     built from float32 X in registers, which wgmma's shared-memory B
//     operand would need a second, converted copy of;
//   - "highest": one thread per row, rc float32 accumulators, the row's 16 B
//     chunks read as float4 and X as float4 broadcasts;
//   - the epilogue writes the tile through shared memory (Ys[r][row]), so
//     each warp stores runs of contiguous floats of Y (layout "nr") or
//     contiguous 128-float rows of Y^T (layout "rn").
//
// Deferred: a persistent grid whose ring runs on across block boundaries
// (the prologue and epilogue of each block are covered only by the other
// CTAs on the SM), TMA in place of cp.async.

#include "csr5_error.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRows = 128;  // rows per block of the plane = threads per CTA
constexpr int KC = 64;      // plane columns per ring slot
constexpr int XP = KC + 8;  // floats per rhs row of a slot's X window: 8 mod 32 banks
constexpr int kStages = 3;  // ring slots per CTA (4 measured no faster)
constexpr int kYPitch = kRows + 4;  // floats per rhs row of the epilogue tile
static_assert(kStages >= 2, "the ring needs two slots");

// The 16 B chunk c of plane row `row` lies at chunk swz(row, c) of the
// row's bytes in a slot (the low three bits of c are permuted, so a chunk
// stays in its 128 B). The eight rows an ldmatrix phase reads, the eight a
// float4 phase of "highest" reads, and the four rows x two chunks a float2
// phase of the f32 "default" path reads all land on distinct banks.
__device__ __forceinline__ int swz(int row, int c) {
    return c ^ (((row & 3) << 1) | ((row >> 2) & 1));
}

// One ring slot: the plane tile (128 rows x KC columns in the plane's
// type, ROW bytes each), then the X window Xs[NX][XP] in float32.
template <typename V, int NX>
struct Slot {
    static constexpr int ROW = KC * (int)sizeof(V);
    static constexpr int CHUNKS = ROW / 16;
    static constexpr int A_BYTES = kRows * ROW;
    static constexpr int BYTES = A_BYTES + NX * XP * 4;
    static constexpr int SMEM = kStages * BYTES;
    static_assert(NX * kYPitch * 4 <= SMEM, "the epilogue tile must fit in the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

// 4 B copy, zero-filled when !valid (no byte of src is read then)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// two floats as a bf16 pair, each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What a CTA works on: block b's plane rows and X window, chunk r0..r0+rcw
struct Job {
    const int32_t* c0;
    const float* x;
    float* y;
    int m, n, K, R, rc;
    long long xs_c, xs_r, ys_row, ys_r;
};

// Fill one ring slot with the plane columns k0..k0+KC of the block and the
// matching window of X (rows rcw..NX of Xs are zeroed once, up front).
template <typename V, int NX>
__device__ __forceinline__ void load_slot(char* slot, const V* ablk, const Job& j, int k0,
                                          long long cbase, int r0, int rcw) {
    using S = Slot<V, NX>;
    constexpr int VEC = 16 / (int)sizeof(V);
    const int tid = threadIdx.x;
    // the plane: a warp copies 512 B, 4 rows of bf16 or 2 of f32
#pragma unroll
    for (int i = 0; i < S::CHUNKS; ++i) {
        const int v = tid + i * kRows;
        const int row = v / S::CHUNKS, c = v % S::CHUNKS;
        cp_async16(slot + row * S::ROW + swz(row, c) * 16, ablk + (size_t)row * j.K + k0 + c * VEC);
    }
    // the X window: Xs[r][k] = X[cbase + k0 + k, r0 + r], 0 past n
    float* xs = reinterpret_cast<float*>(slot + S::A_BYTES);
    const long long col0 = cbase + k0;
    if (j.xs_c == 1) {
        // k contiguous in X (layout "rn", or R = 1): a warp reads along k
        constexpr int RSTEP = kRows / KC;
        const int k = tid % KC;
        const long long col = col0 + k;
        const bool ok = col < j.n;
        for (int r = tid / KC; r < rcw; r += RSTEP)
            cp_async4(xs + r * XP + k, ok ? j.x + col + (long long)(r0 + r) * j.xs_r : j.x, ok);
    } else {
        // r contiguous in X (layout "nr"): NX lanes read along r, 32 / NX
        // rows of X per warp, transposed into Xs
        const int r = tid % NX;
        if (r < rcw) {
            for (int k = tid / NX; k < KC; k += kRows / NX) {
                const long long col = col0 + k;
                const bool ok = col < j.n;
                cp_async4(xs + r * XP + k, ok ? j.x + col * j.xs_c + (long long)(r0 + r) * j.xs_r : j.x,
                          ok);
            }
        }
    }
}

// Zero rows rcw..NX of every slot's Xs: R padded to NX, never written by a copy
template <typename V, int NX>
__device__ __forceinline__ void zero_pad_rows(char* smem, int rcw) {
    using S = Slot<V, NX>;
    if (rcw >= NX) return;
    const int per_slot = (NX - rcw) * XP;
    for (int e = threadIdx.x; e < kStages * per_slot; e += kRows) {
        const int s = e / per_slot, o = e % per_slot;
        reinterpret_cast<float*>(smem + s * S::BYTES + S::A_BYTES)[rcw * XP + o] = 0.f;
    }
}

// Prologue: slots 0..kStages-2 in flight (one commit group per slot, empty
// past the last stage, so wait_group counts stay uniform)
template <typename V, int NX>
__device__ __forceinline__ void ring_start(char* smem, const V* ablk, const Job& j, int nk,
                                           long long cbase, int r0, int rcw) {
    using S = Slot<V, NX>;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load_slot<V, NX>(smem + s * S::BYTES, ablk, j, s * KC, cbase, r0, rcw);
        cp_async_commit();
    }
}

// Stage kt has landed in slot kt % kStages for every thread; slot
// (kt - 1) % kStages is free, so stage kt + kStages - 1 goes there.
template <typename V, int NX>
__device__ __forceinline__ const char* ring_next(char* smem, const V* ablk, const Job& j, int kt,
                                                 int nk, long long cbase, int r0, int rcw) {
    using S = Slot<V, NX>;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
        load_slot<V, NX>(smem + (nxt % kStages) * S::BYTES, ablk, j, nxt * KC, cbase, r0, rcw);
    cp_async_commit();
    return smem + (kt % kStages) * S::BYTES;
}

// Ys[c][i] (c < rcw) -> Y rows b*128 + i < m, rhs r0 + c
template <int NX>
__device__ __forceinline__ void store_y(const float* Ys, const Job& j, int b, int r0, int rcw) {
    const long long row0 = (long long)b * kRows;
    if (j.ys_row == 1) {
        // Y^T (layout "rn", or R = 1): a warp writes 32 consecutive rows
        for (int e = threadIdx.x; e < rcw * kRows; e += kRows) {
            const int c = e / kRows, i = e % kRows;
            if (row0 + i < j.m) j.y[(row0 + i) + (long long)(r0 + c) * j.ys_r] = Ys[c * kYPitch + i];
        }
    } else {
        // Y (layout "nr"): NX lanes write one row's rcw consecutive floats
        const int c = threadIdx.x % NX;
        if (c < rcw) {
            for (int i = threadIdx.x / NX; i < kRows; i += kRows / NX)
                if (row0 + i < j.m)
                    j.y[(row0 + i) * j.ys_row + (long long)(r0 + c) * j.ys_r] = Ys[c * kYPitch + i];
        }
    }
}

// A fragments of the warp's two m16 tiles at k step ks of a slot
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const char* As, int warp, int lane,
                                       int ks, const __nv_bfloat16*) {
    // ldmatrix.x4: lane l gives row l % 16 of the tile at chunk 2 ks + l / 16
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        const int row = warp * 32 + mt * 16 + lane % 16;
        ldmatrix_x4(a[mt], As + row * KC * 2 + swz(row, ks * 2 + lane / 16) * 16);
    }
}

__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const char* As, int warp, int lane,
                                       int ks, const float*) {
    // the mma layout directly: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8),
    // a3 (g + 8, 2t + 8), each a float2 rounded to a bf16 pair
    const int g = lane / 4, k = ks * 16 + (lane % 4) * 2;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int row = warp * 32 + mt * 16 + g + (q & 1) * 8;
            const int kk = k + (q >> 1) * 8;
            const float2 v = *reinterpret_cast<const float2*>(
                As + row * KC * 4 + swz(row, kk / 4) * 16 + (kk % 4) * 4);
            a[mt][q] = pack_bf16(v.x, v.y);
        }
    }
}

// "default": tensor cores, NT n8 tiles, both bf16-operand modes
template <typename V, int NT>
__global__ void __launch_bounds__(kRows)
bandmm_mma_kernel(const V* __restrict__ dense, Job j) {
    constexpr int NX = NT * 8;
    using S = Slot<V, NX>;
    extern __shared__ __align__(128) char smem[];
    const int b = blockIdx.x;
    const int r0 = blockIdx.y * j.rc;
    const int rcw = min(j.rc, j.R - r0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const long long cbase = (long long)j.c0[b] * kRows;
    const V* ablk = dense + (size_t)b * kRows * j.K;
    const int nk = j.K / KC;

    zero_pad_rows<V, NX>(smem, rcw);
    ring_start<V, NX>(smem, ablk, j, nk, cbase, r0, rcw);
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
        const char* As = ring_next<V, NX>(smem, ablk, j, kt, nk, cbase, r0, rcw);
        const float* Xs = reinterpret_cast<const float*>(As + S::A_BYTES);
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
            uint32_t a[2][4];
            load_a(a, As, warp, lane, ks, (const V*)nullptr);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                // b0 (k 2t, 2t + 1; n g), b1 (k 2t + 8, 2t + 9; n g)
                const float* xp = Xs + (nt * 8 + g) * XP + ks * 16 + t * 2;
                const float2 lo = *reinterpret_cast<const float2*>(xp);
                const float2 hi = *reinterpret_cast<const float2*>(xp + 8);
                const uint32_t b0 = pack_bf16(lo.x, lo.y), b1 = pack_bf16(hi.x, hi.y);
                mma_bf16(acc[0][nt], a[0], b0, b1);
                mma_bf16(acc[1][nt], a[1], b0, b1);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    // c0, c1 (row g, n 2t, 2t + 1), c2, c3 (row g + 8)
    float* Ys = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int row = warp * 32 + mt * 16 + g + (q / 2) * 8;
                Ys[(nt * 8 + t * 2 + q % 2) * kYPitch + row] = acc[mt][nt][q];
            }
    __syncthreads();
    store_y<NX>(Ys, j, b, r0, rcw);
}

// "highest": exact float32 products on the CUDA cores, one thread per row
template <int RC>
__global__ void __launch_bounds__(kRows)
bandmm_fma_kernel(const float* __restrict__ dense, Job j) {
    constexpr int NX = RC < 8 ? 8 : RC;
    using S = Slot<float, NX>;
    extern __shared__ __align__(128) char smem[];
    const int b = blockIdx.x;
    const int r0 = blockIdx.y * j.rc;
    const int rcw = min(j.rc, j.R - r0);
    const int tid = threadIdx.x;
    const long long cbase = (long long)j.c0[b] * kRows;
    const float* ablk = dense + (size_t)b * kRows * j.K;
    const int nk = j.K / KC;

    zero_pad_rows<float, NX>(smem, rcw);
    ring_start<float, NX>(smem, ablk, j, nk, cbase, r0, rcw);
    float acc[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[c] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
        const char* As = ring_next<float, NX>(smem, ablk, j, kt, nk, cbase, r0, rcw);
        const float* Xs = reinterpret_cast<const float*>(As + S::A_BYTES);
        const char* arow = As + tid * S::ROW;
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c) {
            const float4 a = *reinterpret_cast<const float4*>(arow + swz(tid, c) * 16);
#pragma unroll
            for (int r = 0; r < RC; ++r) {
                const float4 xv = *reinterpret_cast<const float4*>(Xs + r * XP + c * 4);
                acc[r] = __fadd_rn(acc[r], __fmul_rn(a.x, xv.x));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(a.y, xv.y));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(a.z, xv.z));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(a.w, xv.w));
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    float* Ys = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int c = 0; c < RC; ++c) Ys[c * kYPitch + tid] = acc[c];
    __syncthreads();
    store_y<NX>(Ys, j, b, r0, rcw);
}

// Kern's launch with SMEM bytes of dynamic shared memory. The limit past
// 48 KB is an attribute of the kernel in each device's context, so it is
// set on the first launch on each device (a bit per device), not on every one.
template <typename V, void (*Kern)(const V*, Job), int SMEM>
int launch_kernel(const void* dense, const Job& j, int nblk, cudaStream_t s) {
    static std::atomic<unsigned long long> smem_set{0};
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (!(smem_set.load(std::memory_order_acquire) & bit)) {
        e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e != cudaSuccess) return (int)e;
        smem_set.fetch_or(bit, std::memory_order_release);
    }
    const dim3 grid((unsigned)nblk, (unsigned)((j.R + j.rc - 1) / j.rc));
    Kern<<<grid, kRows, SMEM, s>>>((const V*)dense, j);
    return (int)cudaGetLastError();
}

template <typename V, int NT>
int launch_mma(const void* dense, const Job& j, int nblk, cudaStream_t s) {
    return launch_kernel<V, bandmm_mma_kernel<V, NT>, Slot<V, NT * 8>::SMEM>(dense, j, nblk, s);
}

template <int RC>
int launch_fma(const void* dense, const Job& j, int nblk, cudaStream_t s) {
    return launch_kernel<float, bandmm_fma_kernel<RC>, Slot<float, (RC < 8 ? 8 : RC)>::SMEM>(
        dense, j, nblk, s);
}

template <typename V>
int launch(const void* dense, const void* c0, const void* x, void* y, int m, int n, int K,
           int nblk, int R, long long xs_c, long long xs_r, long long ys_row, long long ys_r,
           int rc, int bf16_ops, void* stream) {
    if (nblk <= 0 || R <= 0 || m <= 0) return 0;
    if (K <= 0 || K % 128) return (int)cudaErrorInvalidValue;
    const Job j{(const int32_t*)c0, (const float*)x, (float*)y, m, n, K, R, rc,
                xs_c, xs_r, ys_row, ys_r};
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16_ops) {
        switch (rc) {
            case 1:
            case 2:
            case 4:
            case 8: return launch_mma<V, 1>(dense, j, nblk, s);
            case 16: return launch_mma<V, 2>(dense, j, nblk, s);
            case 32:
                // one pass up to R = 32 on a bf16 plane only (MAX_CHUNK_F32)
                if constexpr (sizeof(V) == 2) return launch_mma<V, 4>(dense, j, nblk, s);
                return (int)cudaErrorInvalidValue;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if constexpr (sizeof(V) == 4) {
        switch (rc) {
            case 1: return launch_fma<1>(dense, j, nblk, s);
            case 2: return launch_fma<2>(dense, j, nblk, s);
            case 4: return launch_fma<4>(dense, j, nblk, s);
            case 8: return launch_fma<8>(dense, j, nblk, s);
            case 16: return launch_fma<16>(dense, j, nblk, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Y (float32, every row < m and rhs < R written) = A @ X for a float32
// dense band-block plane (m_pad, K) with window pages c0 (nblk,), in chunks
// of rc in {1, 2, 4, 8, 16} right-hand sides. bf16_ops: round A and X
// to bf16 ("default", tensor cores); 0: exact float32 products
// ("highest"). Returns the CUDA error code of the launch (0 on success).
int bandmm_f32(const void* dense, const void* c0, const void* x, void* y, int m, int n,
               int K, int nblk, int R, long long xs_c, long long xs_r, long long ys_row,
               long long ys_r, int rc, int bf16_ops, void* stream) {
    return launch<float>(dense, c0, x, y, m, n, K, nblk, R, xs_c, xs_r, ys_row, ys_r, rc,
                         bf16_ops, stream);
}

// The same for a bfloat16 plane, rc in {1, 2, 4, 8, 16, 32}; X is rounded
// to bf16 (bf16_ops must be 1: "highest" needs a float32 plane).
int bandmm_bf16(const void* dense, const void* c0, const void* x, void* y, int m, int n,
                int K, int nblk, int R, long long xs_c, long long xs_r, long long ys_row,
                long long ys_r, int rc, int bf16_ops, void* stream) {
    if (!bf16_ops) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(dense, c0, x, y, m, n, K, nblk, R, xs_c, xs_r, ys_row,
                                 ys_r, rc, 1, stream);
}

}  // extern "C"
