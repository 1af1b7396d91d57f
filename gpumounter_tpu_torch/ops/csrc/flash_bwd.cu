// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two TPU kernels of gpumounter_tpu/ops/flash_attention.py
// (launched by _flash_backward):
//
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel:  dq = Σ_k ds·k·scale
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel: dk = Σ_q dsᵀ·q·scale,
//                                                  dv = Σ_q pᵀ·do
//
// with p = exp(s − lse) recomputed from the forward's saved natural-unit
// lse (0 for rows whose lse is NEG_INF), ds = p∘(do·vᵀ − Δ), Δ = rowsum(do∘o)
// − dlse computed by the caller, and, with softcap, ds multiplied by the
// chain factor 1 − (s_cap/cap)² of cap·tanh(s/cap) (s_cap taken before the
// mask). The band rules are the forward's: causal, a sliding window
// [p − window, p] joined with the sink keys [0, sinks), the decode offset
// L_k − L_q for causal cross-length, and the zero-copy GQA fold (q head h
// reads kv head h / group).
//
// Bound on the H100 at the probe's full-width shape (B=4, H=8, L=2048,
// D=128, causal, bf16): dq does 3 products of 2·D operations per attended
// (query, key) pair (S, dP, dQ), ≈ 51.6 GFLOP ≈ 52 µs at 989 TFLOP/s;
// dk/dv does 4 (S, dP, dV, dK), ≈ 68.7 GFLOP ≈ 69 µs; each moves ≈ 42 MB
// (≈ 13 µs at 3.35 TB/s). So both are bound by operations, and the design
// keeps every product on the tensor cores (nvcuda::wmma bf16 fragments, f32
// accumulators), rounding p and ds to bf16 before their products as the TPU
// kernel does. The accumulators (dq, or dk and dv) stay in wmma fragments
// in registers across the whole loop: unlike the forward there is no
// per-row rescale, so their opaque layout does not matter until the single
// write-back. Scores, dP, p and ds of a tile live in shared memory only.
// This is the simple first version: no wgmma, no TMA, no double buffering,
// one block of 4 warps per SM at D=128, so it runs well below that bound
// (PERF.md has its time).
//
// dq: one block per (q tile of 64 rows, b·h), looping over the k tiles the
// band needs (the sink tiles, then the band), as flash_fwd.cu does.
// dk/dv: one block per (k tile of 64 keys, b·h_kv), looping over the
// group's q heads and, for each, over the q tiles of the transposed band
// (the TPU kernel's _q_clamp as loop bounds; a k tile holding sink keys is
// attended by every later query). The group sum happens in the block's
// registers in f32 and dk, dv are written once in the input dtype: no
// per-q-head partials in device memory, no atomics, the same bits on every
// run. In both kernels each warp owns 16 rows (queries for dq, keys for
// dk/dv) end to end. f32 inputs take the same loops with scalar FMAs (the
// tensor cores have no f32 x f32 product); f32 is not on the probe's path.
//
// Launch contract: the C entries launch on the caller's stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().
// flash_bwd_init raises the dynamic shared-memory limit of every instance
// once, at load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;              // query rows of a q tile, keys of a k tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = TILE / WARPS;    // rows owned by one warp
constexpr float NEG_INF = -1e30f;     // large-but-finite, as in the TPU kernel

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout, the same for both kernels: four input tiles, two
// f32 score-shaped tiles, and (bf16 only) two bf16 score-shaped tiles for
// the rounded p and ds. Row strides are padded against bank conflicts; the
// bf16 paddings keep every wmma fragment pointer 32-byte aligned.
template <typename T, int D>
struct Smem {
    static constexpr bool kBf16 = sizeof(T) == 2;
    static constexpr int LD = kBf16 ? D + 8 : D + 1;  // input tiles
    static constexpr int LDS = TILE + 4;               // f32 score tiles
    static constexpr int LDP = TILE + 8;               // bf16 p / ds tiles
    static constexpr size_t in_tile = sizeof(T) * TILE * LD;
    static constexpr size_t f32_tile = sizeof(float) * TILE * LDS;
    static constexpr size_t b16_tile = kBf16 ? sizeof(bf16) * TILE * LDP : 0;
    static constexpr size_t in0 = 0;
    static constexpr size_t in1 = align128(in0 + in_tile);
    static constexpr size_t in2 = align128(in1 + in_tile);
    static constexpr size_t in3 = align128(in2 + in_tile);
    static constexpr size_t s = align128(in3 + in_tile);
    static constexpr size_t dp = align128(s + f32_tile);
    static constexpr size_t p16 = align128(dp + f32_tile);
    static constexpr size_t ds16 = align128(p16 + b16_tile);
    static constexpr size_t rows = align128(ds16 + b16_tile);  // lse, Δ of a q tile
    static constexpr size_t bytes = align128(rows + sizeof(float) * 2 * TILE);
};

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;    // (B, H, L_q) f32, contiguous
    const float* delta;  // (B, H, L_q) f32, contiguous
    void* dq;            // (B, H, L_q, D), contiguous
    void* dk;            // (B, H_kv, L_k, D), contiguous
    void* dv;
    long long q_sb, q_sh, q_sl;  // element strides of batch, head, row
    long long k_sb, k_sh, k_sl;
    long long v_sb, v_sh, v_sl;
    long long o_sb, o_sh, o_sl;  // of dout
    int H, H_kv, group, L_q, L_k, offset;
    int causal, window, sinks;   // window < 0: no window
    float scale, softcap;        // softcap <= 0: no softcap
};

__device__ __forceinline__ void store_out(bf16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

// Copy TILE rows of D elements into a padded shared tile; rows at or past
// rows_valid are zero-filled, so padded keys and queries stay finite.
template <typename T, int D>
__device__ void load_tile(T* dst, const T* src, long long row_stride, int rows_valid) {
    constexpr int LD = Smem<T, D>::LD;
    if constexpr (sizeof(T) == 2) {
        constexpr int PER_ROW = D / 8;  // 16-byte vectors
        for (int i = threadIdx.x; i < TILE * PER_ROW; i += THREADS) {
            const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
            *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
        }
    } else {
        for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
            const int r = i / D, c = i % D;
            dst[r * LD + c] = r < rows_valid ? src[r * row_stride + c] : T(0);
        }
    }
}

// lse and Δ of a q tile; rows past L_q get lse = NEG_INF, hence p = 0.
__device__ void load_rows(float* s_lse, float* s_delta, const Params& prm, long long bh, int q0) {
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
        const bool ok = q0 + i < prm.L_q;
        const long long at = bh * prm.L_q + q0 + i;
        s_lse[i] = ok ? prm.lse[at] : NEG_INF;
        s_delta[i] = ok ? prm.delta[at] : 0.f;
    }
}

struct PDs {
    float p, ds;
};

// p and ds of one (query, key) pair from the raw product q·k and dp = do·v.
__device__ __forceinline__ PDs p_ds(float dot, float dp, float lse, float delta, int q_row, int key,
                                    const Params& prm) {
    float s = dot * prm.scale;
    float chain = 1.f;
    if (prm.softcap > 0.f) {
        const float t = tanhf(s / prm.softcap);
        s = prm.softcap * t;  // s_cap, before the mask
        chain = 1.f - t * t;  // d(cap·tanh(s/cap))/ds = 1 − (s_cap/cap)²
    }
    bool keep = key < prm.L_k && q_row < prm.L_q;
    if (prm.causal) {
        const int pos = prm.offset + q_row;  // the query on the key timeline
        keep = keep && key <= pos;
        if (prm.window >= 0) keep = keep && (key >= pos - prm.window || key < prm.sinks);
    }
    const float p = (!keep || lse <= NEG_INF / 2) ? 0.f : expf(s - lse);
    return {p, p * (dp - delta) * chain};
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The warp's 16 x TILE tiles of a·bᵀ and c·dᵀ (bf16 on the tensor cores,
// f32 out): rows r0.. of a and c against all TILE rows of b and d.
template <typename T, int D>
__device__ void two_products_t(float* out_ab, float* out_cd, const T* a, const T* b, const T* c,
                               const T* d, int r0, int lane) {
    using S = Smem<T, D>;
    constexpr int LD = S::LD, LDS = S::LDS;
    if constexpr (S::kBf16) {
        const bf16* a16 = reinterpret_cast<const bf16*>(a);
        const bf16* b16 = reinterpret_cast<const bf16*>(b);
        const bf16* c16 = reinterpret_cast<const bf16*>(c);
        const bf16* d16 = reinterpret_cast<const bf16*>(d);
#pragma unroll
        for (int j = 0; j < TILE / 16; ++j) {
            FragAcc acc_ab, acc_cd;
            wmma::fill_fragment(acc_ab, 0.f);
            wmma::fill_fragment(acc_cd, 0.f);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                FragA fa;
                FragBCol fb;
                wmma::load_matrix_sync(fa, a16 + r0 * LD + kk * 16, LD);
                wmma::load_matrix_sync(fb, b16 + j * 16 * LD + kk * 16, LD);
                wmma::mma_sync(acc_ab, fa, fb, acc_ab);
                wmma::load_matrix_sync(fa, c16 + r0 * LD + kk * 16, LD);
                wmma::load_matrix_sync(fb, d16 + j * 16 * LD + kk * 16, LD);
                wmma::mma_sync(acc_cd, fa, fb, acc_cd);
            }
            wmma::store_matrix_sync(out_ab + r0 * LDS + j * 16, acc_ab, LDS, wmma::mem_row_major);
            wmma::store_matrix_sync(out_cd + r0 * LDS + j * 16, acc_cd, LDS, wmma::mem_row_major);
        }
    } else {
        // Each lane computes columns lane and lane + 32 of the warp's rows;
        // one product at a time keeps the register count down.
        for (int which = 0; which < 2; ++which) {
            const T* x = which ? c : a;
            const T* y = which ? d : b;
            float* out = which ? out_cd : out_ab;
            float acc[ROWS][2] = {};
            for (int e = 0; e < D; ++e) {
                const float ya = y[lane * LD + e], yb = y[(lane + 32) * LD + e];
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float xv = x[(r0 + r) * LD + e];
                    acc[r][0] += xv * ya;
                    acc[r][1] += xv * yb;
                }
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                out[(r0 + r) * LDS + lane] = acc[r][0];
                out[(r0 + r) * LDS + lane + 32] = acc[r][1];
            }
        }
    }
}

// acc[j] += x·y[:, j·16 : j·16 + 16] for the warp's rows of the bf16 score
// tile x (16 x TILE) and the input tile y (TILE x D).
template <int D, int LD>
__device__ __forceinline__ void accumulate(FragAcc (&acc)[D / 16], const bf16* x, const bf16* y, int r0) {
    constexpr int LDP = TILE + 8;
    FragA fx[TILE / 16];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) wmma::load_matrix_sync(fx[kk], x + r0 * LDP + kk * 16, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
            FragBRow fy;
            wmma::load_matrix_sync(fy, y + kk * 16 * LD + j * 16, LD);
            wmma::mma_sync(acc[j], fx[kk], fy, acc[j]);
        }
    }
}

// The f32 form: acc[r][e] += Σ_c x[r0 + r][c] · y[c][lane + 32·e].
template <int D, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[ROWS][D / 32], const float* x, const float* y, int r0,
                                           int lane) {
    constexpr int LDS = TILE + 4;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int e = 0; e < D / 32; ++e) {
            float sum = acc[r][e];
            for (int c = 0; c < TILE; ++c) sum += x[(r0 + r) * LDS + c] * y[c * LD + lane + 32 * e];
            acc[r][e] = sum;
        }
    }
}

// Write the warp's 16 x D rows of acc·factor to out (rows past n_valid are
// dropped), staging each 16 x 16 fragment through the warp's own rows of
// the f32 tile `stage`.
template <typename T, int D>
__device__ void write_rows(T* out, FragAcc (&acc)[D / 16], float factor, float* stage, int r0, int n_valid,
                           int lane) {
    constexpr int LDS = TILE + 4;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
        for (int t = 0; t < acc[j].num_elements; ++t) acc[j].x[t] *= factor;
        __syncwarp();
        wmma::store_matrix_sync(stage + r0 * LDS, acc[j], LDS, wmma::mem_row_major);
        __syncwarp();
        for (int i = lane; i < 16 * 16; i += 32) {
            const int r = i / 16, c = i % 16;
            if (r0 + r < n_valid) store_out(out + (r0 + r) * D + j * 16 + c, stage[(r0 + r) * LDS + c]);
        }
    }
}

template <typename T, int D>
__device__ void write_rows(T* out, float (&acc)[ROWS][D / 32], float factor, int r0, int n_valid, int lane) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        if (r0 + r >= n_valid) continue;
#pragma unroll
        for (int e = 0; e < D / 32; ++e) store_out(out + (r0 + r) * D + lane + 32 * e, acc[r][e] * factor);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params prm) {
    using S = Smem<T, D>;
    constexpr int LD = S::LD, LDS = S::LDS, LDP = S::LDP;
    extern __shared__ __align__(128) unsigned char smem[];
    T* sQ = reinterpret_cast<T*>(smem + S::in0);
    T* sDO = reinterpret_cast<T*>(smem + S::in1);
    T* sK = reinterpret_cast<T*>(smem + S::in2);
    T* sV = reinterpret_cast<T*>(smem + S::in3);
    float* sS = reinterpret_cast<float*>(smem + S::s);
    float* sDP = reinterpret_cast<float*>(smem + S::dp);
    bf16* sDS = reinterpret_cast<bf16*>(smem + S::ds16);
    float* sLse = reinterpret_cast<float*>(smem + S::rows);
    float* sDelta = sLse + TILE;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * ROWS;
    // Latest q tiles first: under a causal mask they carry the most k tiles.
    const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
    const int bh = blockIdx.y;
    const int b = bh / prm.H, h = bh % prm.H, hk = h / prm.group;
    const T* gk = static_cast<const T*>(prm.k) + b * prm.k_sb + hk * prm.k_sh;
    const T* gv = static_cast<const T*>(prm.v) + b * prm.v_sb + hk * prm.v_sh;
    const int q_valid = min(TILE, prm.L_q - q0);

    load_tile<T, D>(sQ, static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh + q0 * prm.q_sl, prm.q_sl,
                    q_valid);
    load_tile<T, D>(sDO, static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh + q0 * prm.o_sl,
                    prm.o_sl, q_valid);
    load_rows(sLse, sDelta, prm, bh, q0);

    // The k tiles this q tile's band needs: [0, sink_end) then
    // [band_begin, band_end), never a tile twice (flash_fwd.cu's bounds).
    const int n_k_tiles = (prm.L_k + TILE - 1) / TILE;
    int sink_end = 0, band_begin = 0, band_end = n_k_tiles;
    if (prm.causal) {
        const int q_last = q0 + q_valid - 1;
        band_end = min(prm.offset + q_last, prm.L_k - 1) / TILE + 1;
        if (prm.window >= 0) {
            band_begin = max(0, prm.offset + q0 - prm.window) / TILE;
            sink_end = min((prm.sinks + TILE - 1) / TILE, band_end);
            band_begin = max(band_begin, sink_end);
        }
    }
    const int n_iter = sink_end + max(0, band_end - band_begin);

    FragAcc acc16[D / 16];
    float acc32[ROWS][D / 32];
    if constexpr (S::kBf16) {
#pragma unroll
        for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc16[j], 0.f);
    } else {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int e = 0; e < D / 32; ++e) acc32[r][e] = 0.f;
    }

    for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < sink_end ? it : band_begin + it - sink_end) * TILE;
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile<T, D>(sK, gk + k0 * prm.k_sl, prm.k_sl, min(TILE, prm.L_k - k0));
        load_tile<T, D>(sV, gv + k0 * prm.v_sl, prm.v_sl, min(TILE, prm.L_k - k0));
        __syncthreads();

        // S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 query rows.
        two_products_t<T, D>(sS, sDP, sQ, sK, sDO, sV, r0, lane);
        __syncwarp();

        // ds, one row at a time; each lane holds keys lane and lane + 32.
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int row = r0 + r;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = lane + 32 * e;
                const PDs g = p_ds(sS[row * LDS + col], sDP[row * LDS + col], sLse[row], sDelta[row], q0 + row,
                                   k0 + col, prm);
                if constexpr (S::kBf16) {
                    sDS[row * LDP + col] = __float2bfloat16(g.ds);
                } else {
                    sS[row * LDS + col] = g.ds;
                }
            }
        }
        __syncwarp();

        // dQ += dS·K (scaled once at the write-back).
        if constexpr (S::kBf16) {
            accumulate<D, LD>(acc16, sDS, reinterpret_cast<const bf16*>(sK), r0);
        } else {
            accumulate<D, LD>(acc32, sS, reinterpret_cast<const float*>(sK), r0, lane);
        }
        __syncwarp();
    }

    T* out = static_cast<T*>(prm.dq) + (static_cast<long long>(bh) * prm.L_q + q0) * D;
    if constexpr (S::kBf16) {
        write_rows<T, D>(out, acc16, prm.scale, sS, r0, q_valid, lane);
    } else {
        write_rows<T, D>(out, acc32, prm.scale, r0, q_valid, lane);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Params prm) {
    using S = Smem<T, D>;
    constexpr int LD = S::LD, LDS = S::LDS, LDP = S::LDP;
    extern __shared__ __align__(128) unsigned char smem[];
    T* sK = reinterpret_cast<T*>(smem + S::in0);
    T* sV = reinterpret_cast<T*>(smem + S::in1);
    T* sQ = reinterpret_cast<T*>(smem + S::in2);
    T* sDO = reinterpret_cast<T*>(smem + S::in3);
    float* sST = reinterpret_cast<float*>(smem + S::s);     // Sᵀ: keys x queries
    float* sDPT = reinterpret_cast<float*>(smem + S::dp);   // dPᵀ
    bf16* sPT = reinterpret_cast<bf16*>(smem + S::p16);
    bf16* sDST = reinterpret_cast<bf16*>(smem + S::ds16);
    float* sLse = reinterpret_cast<float*>(smem + S::rows);
    float* sDelta = sLse + TILE;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * ROWS;
    // Earliest k tiles first: under a causal mask they carry the most q tiles.
    const int k0 = blockIdx.x * TILE;
    const int bhk = blockIdx.y;
    const int b = bhk / prm.H_kv, hk = bhk % prm.H_kv;
    const int k_valid = min(TILE, prm.L_k - k0);

    load_tile<T, D>(sK, static_cast<const T*>(prm.k) + b * prm.k_sb + hk * prm.k_sh + k0 * prm.k_sl, prm.k_sl,
                    k_valid);
    load_tile<T, D>(sV, static_cast<const T*>(prm.v) + b * prm.v_sb + hk * prm.v_sh + k0 * prm.v_sl, prm.v_sl,
                    k_valid);

    // The q tiles of the transposed band (the TPU kernel's _q_clamp): the
    // first query that sees key k0 sits at k0 − offset; with a window, the
    // last one at k_last + window − offset, unless the tile holds sink keys,
    // which every later query attends.
    const int n_q_tiles = (prm.L_q + TILE - 1) / TILE;
    int qt_begin = 0, qt_end = n_q_tiles;
    if (prm.causal) {
        qt_begin = max(0, k0 - prm.offset) / TILE;
        if (prm.window >= 0 && k0 >= prm.sinks) {
            const int q_last = k0 + k_valid - 1 + prm.window - prm.offset;
            qt_end = q_last < 0 ? 0 : min(n_q_tiles, q_last / TILE + 1);
        }
    }

    FragAcc dk16[D / 16], dv16[D / 16];
    float dk32[ROWS][D / 32], dv32[ROWS][D / 32];
    if constexpr (S::kBf16) {
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
            wmma::fill_fragment(dk16[j], 0.f);
            wmma::fill_fragment(dv16[j], 0.f);
        }
    } else {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int e = 0; e < D / 32; ++e) dk32[r][e] = dv32[r][e] = 0.f;
    }

    // The group sum: every q head of this kv head adds into the same
    // accumulators, in a fixed order.
    for (int g = 0; g < prm.group; ++g) {
        const int h = hk * prm.group + g;
        const long long bh = static_cast<long long>(b) * prm.H + h;
        const T* gq = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
        const T* gdo = static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int q0 = qt * TILE;
            __syncthreads();  // every warp is done with the previous Q/dO tile
            load_tile<T, D>(sQ, gq + q0 * prm.q_sl, prm.q_sl, min(TILE, prm.L_q - q0));
            load_tile<T, D>(sDO, gdo + q0 * prm.o_sl, prm.o_sl, min(TILE, prm.L_q - q0));
            load_rows(sLse, sDelta, prm, bh, q0);
            __syncthreads();

            // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys.
            two_products_t<T, D>(sST, sDPT, sK, sQ, sV, sDO, r0, lane);
            __syncwarp();

            // pᵀ and dsᵀ, one key row at a time; each lane holds queries
            // lane and lane + 32.
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const int row = r0 + r;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = lane + 32 * e;
                    const PDs pd = p_ds(sST[row * LDS + col], sDPT[row * LDS + col], sLse[col], sDelta[col],
                                        q0 + col, k0 + row, prm);
                    if constexpr (S::kBf16) {
                        sPT[row * LDP + col] = __float2bfloat16(pd.p);
                        sDST[row * LDP + col] = __float2bfloat16(pd.ds);
                    } else {
                        sST[row * LDS + col] = pd.p;
                        sDPT[row * LDS + col] = pd.ds;
                    }
                }
            }
            __syncwarp();

            // dV += Pᵀ·dO and dK += dSᵀ·Q (scaled once at the write-back).
            if constexpr (S::kBf16) {
                accumulate<D, LD>(dv16, sPT, reinterpret_cast<const bf16*>(sDO), r0);
                accumulate<D, LD>(dk16, sDST, reinterpret_cast<const bf16*>(sQ), r0);
            } else {
                accumulate<D, LD>(dv32, sST, reinterpret_cast<const float*>(sDO), r0, lane);
                accumulate<D, LD>(dk32, sDPT, reinterpret_cast<const float*>(sQ), r0, lane);
            }
            __syncwarp();
        }
    }

    const long long out_row = static_cast<long long>(bhk) * prm.L_k + k0;
    T* dk = static_cast<T*>(prm.dk) + out_row * D;
    T* dv = static_cast<T*>(prm.dv) + out_row * D;
    if constexpr (S::kBf16) {
        write_rows<T, D>(dk, dk16, prm.scale, sST, r0, k_valid, lane);
        write_rows<T, D>(dv, dv16, 1.f, sST, r0, k_valid, lane);
    } else {
        write_rows<T, D>(dk, dk32, prm.scale, r0, k_valid, lane);
        write_rows<T, D>(dv, dv32, 1.f, r0, k_valid, lane);
    }
}

template <typename T, int D>
cudaError_t set_smem_limits() {
    constexpr int bytes = static_cast<int>(Smem<T, D>::bytes);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
}

template <typename T, int D>
cudaError_t launch(const Params& prm, bool dq, int B, cudaStream_t stream) {
    constexpr size_t bytes = Smem<T, D>::bytes;
    if (dq) {
        const dim3 grid((prm.L_q + TILE - 1) / TILE, B * prm.H);
        flash_bwd_dq_kernel<T, D><<<grid, THREADS, bytes, stream>>>(prm);
    } else {
        const dim3 grid((prm.L_k + TILE - 1) / TILE, B * prm.H_kv);
        flash_bwd_dkv_kernel<T, D><<<grid, THREADS, bytes, stream>>>(prm);
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& prm, bool dq, int B, int d, cudaStream_t stream) {
    switch (d) {
        case 32: return launch<T, 32>(prm, dq, B, stream);
        case 64: return launch<T, 64>(prm, dq, B, stream);
        case 128: return launch<T, 128>(prm, dq, B, stream);
        default: return cudaErrorInvalidValue;
    }
}

int run(bool dq, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* out0, void* out1, int dtype, int B, int H, int H_kv, int L_q, int L_k, int D,
        long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh, long long k_sl,
        long long v_sb, long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
        int causal, int window, int sinks, float scale, float softcap, void* stream) {
    if (H_kv < 1 || H % H_kv || L_q < 1 || L_k < 1 || (causal && L_q > L_k)) return cudaErrorInvalidValue;
    Params prm;
    prm.q = q; prm.k = k; prm.v = v; prm.dout = dout;
    prm.lse = static_cast<const float*>(lse); prm.delta = static_cast<const float*>(delta);
    prm.dq = dq ? out0 : nullptr;
    prm.dk = dq ? nullptr : out0;
    prm.dv = dq ? nullptr : out1;
    prm.q_sb = q_sb; prm.q_sh = q_sh; prm.q_sl = q_sl;
    prm.k_sb = k_sb; prm.k_sh = k_sh; prm.k_sl = k_sl;
    prm.v_sb = v_sb; prm.v_sh = v_sh; prm.v_sl = v_sl;
    prm.o_sb = o_sb; prm.o_sh = o_sh; prm.o_sl = o_sl;
    prm.H = H; prm.H_kv = H_kv; prm.group = H / H_kv; prm.L_q = L_q; prm.L_k = L_k;
    prm.offset = causal ? L_k - L_q : 0;
    prm.causal = causal; prm.window = window; prm.sinks = sinks;
    prm.scale = scale; prm.softcap = softcap;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_dim<bf16>(prm, dq, B, D, s);
    if (dtype == 1) return launch_dim<float>(prm, dq, B, D, s);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_bwd_init() {
    cudaError_t err = set_smem_limits<bf16, 32>();
    if (err == cudaSuccess) err = set_smem_limits<bf16, 64>();
    if (err == cudaSuccess) err = set_smem_limits<bf16, 128>();
    if (err == cudaSuccess) err = set_smem_limits<float, 32>();
    if (err == cudaSuccess) err = set_smem_limits<float, 64>();
    if (err == cudaSuccess) err = set_smem_limits<float, 128>();
    return err;
}

// dtype: 0 = bf16, 1 = f32. window < 0 means no window; softcap <= 0 means
// no softcap. Strides are in elements; the head dim of q, k, v and dout
// must be contiguous, and bf16 rows must start on 16-byte boundaries. lse
// and delta are (B, H, L_q) f32; dq is (B, H, L_q, D), contiguous.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, int dtype, int B, int H, int H_kv, int L_q, int L_k,
                            int D, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                            long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                            long long o_sb, long long o_sh, long long o_sl, int causal, int window, int sinks,
                            float scale, float softcap, void* stream) {
    return run(true, q, k, v, dout, lse, delta, dq, nullptr, dtype, B, H, H_kv, L_q, L_k, D, q_sb, q_sh, q_sl,
               k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, causal, window, sinks, scale, softcap,
               stream);
}

// As flash_bwd_dq; dk and dv are (B, H_kv, L_k, D), contiguous, each
// summed over its group of q heads inside the kernel.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int dtype, int B, int H, int H_kv, int L_q,
                             int L_k, int D, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                             long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                             long long o_sb, long long o_sh, long long o_sl, int causal, int window, int sinks,
                             float scale, float softcap, void* stream) {
    return run(false, q, k, v, dout, lse, delta, dk, dv, dtype, B, H, H_kv, L_q, L_k, D, q_sb, q_sh, q_sl,
               k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, causal, window, sinks, scale, softcap,
               stream);
}
