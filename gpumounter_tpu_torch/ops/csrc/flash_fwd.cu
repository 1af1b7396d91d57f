// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel gpumounter_tpu/ops/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas). Same function: online-softmax
// attention over (B, H, L_q, D) queries and (B, H_kv, L_k, D) keys/values,
// with causal masking, a sliding window [p - window, p] joined with the
// sink keys [0, sinks), Gemma-2 softcap on the raw scaled scores before
// the mask, the zero-copy GQA fold (q head h reads kv head h / group), the
// decode offset L_k - L_q for causal cross-length, a base-2 softmax with
// f32 accumulation, and an optional per-row lse in natural units (NEG_INF
// for rows that see no key).
//
// Bound on the H100 at the probe's full-width shape (B=4, H=8, L=2048,
// D=128, causal, bf16): the band needs 2·B·H·D·L(L+1) ≈ 34.4 GFLOP, which
// is ≈ 35 µs at 989 TFLOP/s dense bf16, against ≈ 67 MB of q/k/v/o traffic
// (≈ 20 µs at 3.35 TB/s). So it is bound by operations, and the design
// keeps the two products on the tensor cores (nvcuda::wmma bf16 fragments,
// f32 accumulators), reads q/k/v from device memory once per block, and
// never writes the (L, L) scores out: a 64x64 f32 score tile lives in
// shared memory only. Causal and windowed blocks loop only over the k
// tiles their band needs (the sink tiles first, then the band), which is
// what the TPU kernel's clamped index map did. This is the simple first
// version: no wgmma, no TMA, no double buffering, and the output
// accumulator round-trips through shared memory on every k tile, so it
// runs well below that bound (PERF.md has its time).
//
// Layout: one block of 4 warps per (q tile of 64 rows, b·h). Each warp owns
// 16 query rows end to end (scores, softmax, P·V, write-back), so inside
// the k loop warps only synchronise among themselves around the shared K/V
// tiles. f32 inputs take the same path with scalar FMAs in place of wmma
// (the tensor cores have no f32 x f32 product); f32 is not on the probe's
// main path.
//
// Launch contract: the C entry launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;            // query rows per block
constexpr int BN = 64;            // keys per k tile
constexpr int WARPS = 4;
constexpr int ROWS = BM / WARPS;  // query rows owned by one warp
constexpr float NEG_INF = -1e30f; // large-but-finite, as in the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout. Row strides are padded against bank conflicts; the
// bf16 paddings keep every wmma fragment pointer 32-byte aligned.
template <typename T, int D>
struct Smem {
    static constexpr bool kBf16 = sizeof(T) == 2;
    static constexpr int LD = kBf16 ? D + 8 : D + 1;  // q/k/v tiles
    static constexpr int LDS = BN + 4;                 // f32 scores
    static constexpr int LDP = BN + 8;                 // bf16 probabilities
    static constexpr int LDO = D + 4;                  // f32 output accumulator
    static constexpr size_t q = 0;
    static constexpr size_t k = align128(q + sizeof(T) * BM * LD);
    static constexpr size_t v = align128(k + sizeof(T) * BN * LD);
    static constexpr size_t s = align128(v + sizeof(T) * BN * LD);
    static constexpr size_t p = align128(s + sizeof(float) * BM * LDS);
    static constexpr size_t o = align128(p + (kBf16 ? sizeof(bf16) * BM * LDP : 0));
    static constexpr size_t bytes = align128(o + sizeof(float) * BM * LDO);
};

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;      // (B, H, L_q, D), contiguous
    float* lse;   // (B, H, L_q) f32, contiguous; null when not wanted
    long long q_sb, q_sh, q_sl;  // element strides of batch, head, row
    long long k_sb, k_sh, k_sl;
    long long v_sb, v_sh, v_sl;
    int H, group, L_q, L_k, offset;
    int causal, window, sinks;   // window < 0: no window
    float scale, softcap;        // softcap <= 0: no softcap
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
    return x;
}

__device__ __forceinline__ void store_out(bf16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

// Copy n_rows rows of D elements into a padded shared tile; rows at or past
// rows_valid are zero-filled, so keys past L_k contribute exact zeros to
// P·V and padded query rows stay finite.
template <typename T, int D>
__device__ void load_tile(T* dst, const T* src, long long row_stride, int rows_valid) {
    constexpr int LD = Smem<T, D>::LD;
    if constexpr (sizeof(T) == 2) {
        constexpr int PER_ROW = D / 8;  // 16-byte vectors
        for (int i = threadIdx.x; i < BN * PER_ROW; i += WARPS * 32) {
            const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
            *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
        }
    } else {
        for (int i = threadIdx.x; i < BN * D; i += WARPS * 32) {
            const int r = i / D, c = i % D;
            dst[r * LD + c] = r < rows_valid ? src[r * row_stride + c] : T(0);
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32) flash_fwd_kernel(const Params prm) {
    static_assert(BM == BN, "load_tile copies BN rows for the q tile too");
    using S = Smem<T, D>;
    constexpr int LD = S::LD, LDS = S::LDS, LDP = S::LDP, LDO = S::LDO;
    extern __shared__ __align__(128) unsigned char smem[];
    T* sQ = reinterpret_cast<T*>(smem + S::q);
    T* sK = reinterpret_cast<T*>(smem + S::k);
    T* sV = reinterpret_cast<T*>(smem + S::v);
    float* sS = reinterpret_cast<float*>(smem + S::s);
    bf16* sP = reinterpret_cast<bf16*>(smem + S::p);
    float* sO = reinterpret_cast<float*>(smem + S::o);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * ROWS;
    // Latest q tiles first: under a causal mask they carry the most k tiles.
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
    const int bh = blockIdx.y;
    const int b = bh / prm.H, h = bh % prm.H, hk = h / prm.group;
    const T* gq = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh + q0 * prm.q_sl;
    const T* gk = static_cast<const T*>(prm.k) + b * prm.k_sb + hk * prm.k_sh;
    const T* gv = static_cast<const T*>(prm.v) + b * prm.v_sb + hk * prm.v_sh;

    load_tile<T, D>(sQ, gq, prm.q_sl, min(BM, prm.L_q - q0));
    for (int i = threadIdx.x; i < BM * LDO; i += WARPS * 32) sO[i] = 0.f;

    // The k tiles this q tile's band needs: [0, sink_end) then
    // [band_begin, band_end), never a tile twice.
    const int n_k_tiles = (prm.L_k + BN - 1) / BN;
    int sink_end = 0, band_begin = 0, band_end = n_k_tiles;
    if (prm.causal) {
        const int q_last = min(q0 + BM, prm.L_q) - 1;
        band_end = min(prm.offset + q_last, prm.L_k - 1) / BN + 1;
        if (prm.window >= 0) {
            band_begin = max(0, prm.offset + q0 - prm.window) / BN;
            sink_end = min((prm.sinks + BN - 1) / BN, band_end);
            band_begin = max(band_begin, sink_end);
        }
    }
    const int n_iter = sink_end + max(0, band_end - band_begin);

    const float scale_log2 = prm.scale * LOG2E;
    float m_run[ROWS], l_run[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) { m_run[r] = NEG_INF; l_run[r] = 0.f; }

    __syncthreads();
    // The warp's q rows stay in registers for the whole k loop.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> q_frag[D / 16];
    if constexpr (S::kBf16) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wmma::load_matrix_sync(q_frag[kk], reinterpret_cast<const bf16*>(sQ) + r0 * LD + kk * 16, LD);
    }

    for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < sink_end ? it : band_begin + it - sink_end) * BN;
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile<T, D>(sK, gk + k0 * prm.k_sl, prm.k_sl, min(BN, prm.L_k - k0));
        load_tile<T, D>(sV, gv + k0 * prm.v_sl, prm.v_sl, min(BN, prm.L_k - k0));
        __syncthreads();

        // Raw scores S = Q·Kᵀ for the warp's 16 rows, f32.
        if constexpr (S::kBf16) {
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) {
                wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
                wmma::fill_fragment(acc, 0.f);
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> k_frag;
                    wmma::load_matrix_sync(k_frag, reinterpret_cast<const bf16*>(sK) + j * 16 * LD + kk * 16, LD);
                    wmma::mma_sync(acc, q_frag[kk], k_frag, acc);
                }
                wmma::store_matrix_sync(sS + r0 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
            }
        } else {
            float acc[ROWS][2] = {};
            for (int d = 0; d < D; ++d) {
                const float ka = sK[lane * LD + d], kb = sK[(lane + 32) * LD + d];
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float qv = sQ[(r0 + r) * LD + d];
                    acc[r][0] += qv * ka;
                    acc[r][1] += qv * kb;
                }
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                sS[(r0 + r) * LDS + lane] = acc[r][0];
                sS[(r0 + r) * LDS + lane + 32] = acc[r][1];
            }
        }
        __syncwarp();

        // Online softmax in base 2, one row at a time; each lane holds
        // columns lane and lane + 32.
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int row = r0 + r;
            const int pos = prm.offset + q0 + row;  // the query on the key timeline
            float s[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int key = k0 + lane + 32 * e;
                float x = sS[row * LDS + lane + 32 * e];
                x = prm.softcap > 0.f ? prm.softcap * tanhf(x * prm.scale / prm.softcap) * LOG2E
                                      : x * scale_log2;
                bool keep = key < prm.L_k;
                if (prm.causal) {
                    keep = keep && key <= pos;
                    if (prm.window >= 0) keep = keep && (key >= pos - prm.window || key < prm.sinks);
                }
                s[e] = keep ? x : NEG_INF;
            }
            const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s[0], s[1])));
            // A row with no key so far keeps m == NEG_INF: its p and alpha
            // are 0, not exp2(0).
            const bool empty = m_new <= NEG_INF / 2;
            const float p0 = empty ? 0.f : exp2f(s[0] - m_new);
            const float p1 = empty ? 0.f : exp2f(s[1] - m_new);
            const float alpha = m_run[r] <= NEG_INF / 2 ? 0.f : exp2f(m_run[r] - m_new);
            l_run[r] = alpha * l_run[r] + warp_sum(p0 + p1);
            m_run[r] = m_new;
            if constexpr (S::kBf16) {
                sP[row * LDP + lane] = __float2bfloat16(p0);
                sP[row * LDP + lane + 32] = __float2bfloat16(p1);
            } else {
                sS[row * LDS + lane] = p0;
                sS[row * LDS + lane + 32] = p1;
            }
            for (int d = lane; d < D; d += 32) sO[row * LDO + d] *= alpha;
        }
        __syncwarp();

        // O += P·V for the warp's rows.
        if constexpr (S::kBf16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p_frag[BN / 16];
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
                wmma::load_matrix_sync(p_frag[kk], sP + r0 * LDP + kk * 16, LDP);
#pragma unroll
            for (int j = 0; j < D / 16; ++j) {
                wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
                wmma::load_matrix_sync(acc, sO + r0 * LDO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v_frag;
                    wmma::load_matrix_sync(v_frag, reinterpret_cast<const bf16*>(sV) + kk * 16 * LD + j * 16, LD);
                    wmma::mma_sync(acc, p_frag[kk], v_frag, acc);
                }
                wmma::store_matrix_sync(sO + r0 * LDO + j * 16, acc, LDO, wmma::mem_row_major);
            }
        } else {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const int row = r0 + r;
                for (int d = lane; d < D; d += 32) {
                    float acc = sO[row * LDO + d];
                    for (int c = 0; c < BN; ++c) acc += sS[row * LDS + c] * sV[c * LD + d];
                    sO[row * LDO + d] = acc;
                }
            }
        }
        __syncwarp();
    }
    __syncthreads();  // the zeroed accumulator is visible even when n_iter == 0

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int q_row = q0 + r0 + r;
        if (q_row >= prm.L_q) continue;
        const float denom = fmaxf(l_run[r], 1e-30f);
        T* out = static_cast<T*>(prm.o) + (static_cast<long long>(bh) * prm.L_q + q_row) * D;
        for (int d = lane; d < D; d += 32) store_out(out + d, sO[(r0 + r) * LDO + d] / denom);
        if (prm.lse != nullptr && lane == 0)
            prm.lse[static_cast<long long>(bh) * prm.L_q + q_row] =
                m_run[r] <= NEG_INF / 2 ? NEG_INF : m_run[r] / LOG2E + logf(denom);
    }
}

template <typename T, int D>
cudaError_t launch(const Params& prm, int n_q_tiles, int n_bh, cudaStream_t stream) {
    constexpr size_t bytes = Smem<T, D>::bytes;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<T, D><<<dim3(n_q_tiles, n_bh), WARPS * 32, bytes, stream>>>(prm);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& prm, int d, int n_q_tiles, int n_bh, cudaStream_t stream) {
    switch (d) {
        case 32: return launch<T, 32>(prm, n_q_tiles, n_bh, stream);
        case 64: return launch<T, 64>(prm, n_q_tiles, n_bh, stream);
        case 128: return launch<T, 128>(prm, n_q_tiles, n_bh, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = bf16, 1 = f32. window < 0 means no window; softcap <= 0 means
// no softcap; lse may be null. Strides are in elements; the head dim must
// be contiguous.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int B, int H, int H_kv, int L_q, int L_k, int D,
                         long long q_sb, long long q_sh, long long q_sl,
                         long long k_sb, long long k_sh, long long k_sl,
                         long long v_sb, long long v_sh, long long v_sl,
                         int causal, int window, int sinks, float scale, float softcap,
                         void* stream) {
    Params prm;
    prm.q = q; prm.k = k; prm.v = v; prm.o = o; prm.lse = static_cast<float*>(lse);
    prm.q_sb = q_sb; prm.q_sh = q_sh; prm.q_sl = q_sl;
    prm.k_sb = k_sb; prm.k_sh = k_sh; prm.k_sl = k_sl;
    prm.v_sb = v_sb; prm.v_sh = v_sh; prm.v_sl = v_sl;
    prm.H = H; prm.group = H / H_kv; prm.L_q = L_q; prm.L_k = L_k;
    prm.offset = causal ? L_k - L_q : 0;
    prm.causal = causal; prm.window = window; prm.sinks = sinks;
    prm.scale = scale; prm.softcap = softcap;
    const int n_q_tiles = (L_q + BM - 1) / BM;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_dim<bf16>(prm, D, n_q_tiles, B * H, s);
    if (dtype == 1) return launch_dim<float>(prm, D, n_q_tiles, B * H, s);
    return cudaErrorInvalidValue;
}
