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
// for rows that see no key, whose output is 0).
//
// Bound on the H100 at the probe's full-width shape (B=4, H=8, L=2048,
// D=128, causal, bf16): the band needs 2·B·H·D·L(L+1) ≈ 34.4 GFLOP, which
// is ≈ 35 µs at 989 TFLOP/s dense bf16, against ≈ 67 MB of q/k/v/o traffic
// (≈ 20 µs at 3.35 TB/s). So it is bound by operations, and the bf16 design
// keeps the tensor cores fed:
//
// - One block per (q tile of 128 rows, b·h), the latest q tiles of every
//   b·h first (they carry the most k tiles), of three warpgroups. The
//   producer warpgroup gives up its registers (setmaxnreg) and one of its
//   threads issues TMA loads: the Q tile once, then K and V tiles of 128
//   keys into a ring of 3 stages (4 at D <= 64), each with a full mbarrier
//   for K, one for V, and an empty one. Tensor maps are 4-D (D, L, H, B)
//   over the caller's strides, so strided head-split views are read in
//   place; rows past L read as zeros; 128-byte swizzle (64-byte at D=32).
// - Two consumer warpgroups each own 64 query rows end to end. S = Q·Kᵀ is
//   one wgmma chain (m64n128k16, both operands K-major in shared memory)
//   into registers; the online softmax runs there, each thread holding two
//   rows, so a row's max takes a 2-step quad shuffle and its sum is reduced
//   once at the end. With the products on the tensor cores, this
//   instruction stream is what limits the kernel, so it is kept short: the
//   scale is folded into the exponent's FMA, 2^x is one ex2.approx, a
//   thread's max and sum run in four independent chains per row, and only
//   tiles not wholly inside the band are masked, against per-row bounds.
//   P is converted to bf16 in place (the accumulator layout is wgmma's
//   register-A layout) and O += P·V is a second chain with V read MN-major
//   through the transpose bit. The O accumulator stays in registers for the
//   whole k loop. A stage is released to the producer when both products
//   that read it have retired.
// - Epilogue: O / l in bf16 is written into the consumer's half of the Q
//   tile, swizzled as TMA expects, and stored by TMA (rows past L_q are not
//   written); then the lse.
//
// Not done yet: ping-pong of the two consumers on named barriers, overlap
// of the softmax with the next tile's wgmma, a persistent tile scheduler.
// The causal loop bounds are per block, so the first consumer also runs the
// block's last diagonal tile, fully masked for its rows.
//
// f32 inputs take a scalar path (the tensor cores have no f32 x f32
// product; f32 is not on the probe's main path): one block of 4 warps per
// 64-row q tile, tiles in padded shared memory, the output accumulator in
// shared memory.
//
// Launch contract: the C entry launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError();
// flash_fwd_init raises the shared-memory limit of every instance once per
// device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f; // large-but-finite, as in the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp, results
// below 2^-126 flushed to 0; 2^-inf is 0).
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The k tiles of BN keys that a q tile of BM rows needs, in loop order:
// the sink tiles [0, sink_end), then the band [band_begin, band_end), never
// a tile twice (the TPU kernel's clamped index map, as loop bounds).
template <int BM, int BN>
struct KTiles {
    int sink_end = 0, band_begin = 0, n_iter = 0;

    __device__ KTiles(int q0, int L_q, int L_k, int offset, int causal, int window, int sinks) {
        int band_end = (L_k + BN - 1) / BN;
        if (causal) {
            const int q_last = min(q0 + BM, L_q) - 1;
            band_end = min(offset + q_last, L_k - 1) / BN + 1;
            if (window >= 0) {
                band_begin = max(0, offset + q0 - window) / BN;
                sink_end = min((sinks + BN - 1) / BN, band_end);
                band_begin = max(band_begin, sink_end);
            }
        }
        n_iter = sink_end + max(0, band_end - band_begin);
    }

    __device__ int key0(int it) const { return (it < sink_end ? it : band_begin + it - sink_end) * BN; }
};

// ------------------------------------------------------------------ bf16

namespace tc {

constexpr int BM = 128;        // query rows per block
constexpr int BN = 128;        // keys per k tile
constexpr int CONSUMERS = 2;   // warpgroups of 64 query rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Shared-memory layout (byte offsets from a 1024-aligned base). A tile of
// R rows x D is stored as D / BOXW boxes of R rows x BOXW elements, one
// swizzle row (ROW_BYTES) per tile row, as TMA writes it.
template <int D>
struct Tiles {
    static constexpr int STAGES = D == 128 ? 3 : 4;  // K/V ring depth: what 227 KB holds
    static constexpr int BOXW = D < 64 ? D : 64;
    static constexpr int ROW_BYTES = 2 * BOXW;
    static constexpr int BOXES = D / BOXW;
    static constexpr uint32_t q_bytes = BM * D * 2, kv_bytes = BN * D * 2;
    static constexpr uint32_t q = 0;
    static constexpr uint32_t k = q + q_bytes;
    static constexpr uint32_t v = k + STAGES * kv_bytes;
    static constexpr uint32_t bars = v + STAGES * kv_bytes;  // q, full_k, full_v, empty (STAGES each)
    static constexpr size_t bytes = bars + 8 * (1 + 3 * STAGES) + 1024;  // + base realignment
};

struct Params {
    CUtensorMap q, k, v, o;  // (D, L, H, B) bf16; o is (B, H, L_q, D) contiguous
    float* lse;              // (B, H, L_q) f32, contiguous; null when not wanted
    int H, group, L_q, L_k, offset;
    int causal, window, sinks;  // window < 0: no window
    float scale_log2;           // scale · log2(e)
    float scale_over_cap, cap_log2;  // softcap instances: scale / cap, cap · log2(e)
};

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tc_kernel(const __grid_constant__ Params p) {
    using T = Tiles<D>;
    constexpr int RB = T::ROW_BYTES, STAGES = T::STAGES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = hopper::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* const base_ptr = smem_raw + (base - raw);
    const uint32_t sQ = base + T::q, sK = base + T::k, sV = base + T::v;
    const uint32_t bar_q = base + T::bars;
    auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
    auto full_v = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };
    auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * STAGES + s); };

    // Blocks start in order of x, then y: every (b, h) of the latest q
    // tile first, since under a causal mask those carry the most k tiles.
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
    const int bh = blockIdx.x;
    const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
    const KTiles<BM, BN> tiles(q0, p.L_q, p.L_k, p.offset, p.causal, p.window, p.sinks);

    if (threadIdx.x == 0) {
        hopper::mbar_init(bar_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(full_k(s), 1);              // the producer's arrive.expect_tx
            hopper::mbar_init(full_v(s), 1);
            hopper::mbar_init(empty(s), CONSUMERS * 4);   // one arrive per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // Producer. Nothing below reconverges with the consumers.
        hopper::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            hopper::prefetch_tensor_map(&p.q);
            hopper::prefetch_tensor_map(&p.k);
            hopper::prefetch_tensor_map(&p.v);
            hopper::mbar_arrive_expect_tx(bar_q, T::q_bytes);
            for (int x = 0; x < T::BOXES; ++x)
                hopper::tma_load_4d(sQ + x * BM * RB, &p.q, bar_q, x * T::BOXW, q0, h, b);
            for (int it = 0; it < tiles.n_iter; ++it) {
                const int s = it % STAGES;
                const int k0 = tiles.key0(it);
                hopper::mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // first round passes
                // K and V on barriers of their own: S = Q·Kᵀ starts while V lands.
                hopper::mbar_arrive_expect_tx(full_k(s), T::kv_bytes);
                for (int x = 0; x < T::BOXES; ++x)
                    hopper::tma_load_4d(sK + s * T::kv_bytes + x * BN * RB, &p.k, full_k(s), x * T::BOXW, k0, hk, b);
                hopper::mbar_arrive_expect_tx(full_v(s), T::kv_bytes);
                for (int x = 0; x < T::BOXES; ++x)
                    hopper::tma_load_4d(sV + s * T::kv_bytes + x * BN * RB, &p.v, full_v(s), x * T::BOXW, k0, hk, b);
            }
        }
    } else {
        hopper::setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = wg - 1;
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        const int row_lo = q0 + cw * 64;                 // the warpgroup's first query row
        const int row_hi = min(row_lo + 63, p.L_q - 1);  // and its last valid one
        const int my_row = row_lo + warp * 16 + lane / 4;  // and + 8: this thread's two rows

        float o[D / 2];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

        hopper::mbar_wait(bar_q, 0);
        for (int it = 0; it < tiles.n_iter; ++it) {
            const int s = it % STAGES;
            const int k0 = tiles.key0(it);
            hopper::mbar_wait(full_k(s), (it / STAGES) & 1);

            // S = Q·Kᵀ for the warpgroup's 64 rows.
            float sc[BN / 2];
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int x = kk * 16 / T::BOXW, inner = kk * 16 % T::BOXW;
                const uint64_t da = hopper::make_desc(sQ + x * BM * RB + cw * 64 * RB + inner * 2, 16, 8 * RB, RB);
                const uint64_t db = hopper::make_desc(sK + s * T::kv_bytes + x * BN * RB + inner * 2, 16, 8 * RB, RB);
                hopper::wgmma_ss<BN>(sc, da, db, kk > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_operands(sc);

            // Online softmax in base 2. sc[i] is row my_row + 8·((i >> 1) & 1),
            // key k0 + 2·(lane % 4) + 8·(i >> 2) + (i & 1). Scores stay raw
            // (times `mult` they are in log2 units: the scale is folded into
            // the exponent's FMA); a masked score is -inf, whose p is 0.
            // softcap, or a negative scale (which would turn the raw row max
            // into a min), puts the scores in log2 units first.
            const bool prescaled = SOFTCAP || p.scale_log2 < 0.f;
            const float mult = prescaled ? 1.f : p.scale_log2;
            if (SOFTCAP) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) sc[i] = p.cap_log2 * tanhf(sc[i] * p.scale_over_cap);
            } else if (prescaled) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) sc[i] *= p.scale_log2;
            }
            const bool whole = k0 + BN <= p.L_k &&
                               (!p.causal || (k0 + BN - 1 <= p.offset + row_lo &&
                                              (p.window < 0 || k0 >= p.offset + row_hi - p.window ||
                                               k0 + BN <= p.sinks)));
            if (!whole) {
                // Per row, the kept keys as column offsets j = 8·(i >> 2) + (i & 1)
                // from this thread's first key: j <= hi, and j >= lo or j < sink_hi.
                const int c0 = k0 + 2 * (lane % 4);
                const bool band = p.causal && p.window >= 0;
                const int sink_hi = band ? p.sinks - c0 : INT_MIN;
                int hi[2], lo[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int pos = p.offset + my_row + 8 * r;  // the query on the key timeline
                    hi[r] = (p.causal ? min(pos, p.L_k - 1) : p.L_k - 1) - c0;
                    lo[r] = band ? pos - p.window - c0 : INT_MIN;
                }
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) {
                    const int j = 8 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
                    if (!(j <= hi[r] && (j >= lo[r] || j < sink_hi))) sc[i] = -INFINITY;
                }
            }
            // Row max and sum over four partials each, to keep the chains short.
            float mp[2][4];
#pragma unroll
            for (int i = 0; i < 8; ++i) mp[i / 4][i % 4] = -INFINITY;
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
                float& acc = mp[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)];
                acc = fmaxf(acc, sc[i]);
            }
            // A row with no key so far keeps m == NEG_INF (finite), and all
            // its scores are -inf: its p come out 0 and its O and l stay 0
            // whatever alpha is, so no row needs a guard here.
            float alpha[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mt = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
                const float m_new = fmaxf(m[r], mt == -INFINITY ? NEG_INF : mt * mult);
                alpha[r] = exp2_approx(m[r] - m_new);
                m[r] = m_new;
            }
            float lp[2][4] = {};
            uint32_t pa[BN / 16][4];
#pragma unroll
            for (int i = 0; i < BN / 2; i += 2) {
                const int r = (i >> 1) & 1;
                const float p0 = exp2_approx(fmaf(sc[i], mult, -m[r]));
                const float p1 = exp2_approx(fmaf(sc[i + 1], mult, -m[r]));
                lp[r][(i >> 2) & 3] += p0 + p1;
                const __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
                pa[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pair);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
#pragma unroll
            for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

            // O += P·V, P from registers, V (keys x D) MN-major.
            hopper::mbar_wait(full_v(s), (it / STAGES) & 1);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                const uint64_t dv = hopper::make_desc(sV + s * T::kv_bytes + kk * 16 * RB, BN * RB, 8 * RB, RB);
                hopper::wgmma_rs_tb<D>(o, pa[kk], dv, 1);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_operands(o);
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(empty(s));  // K and V of stage s are free
        }

        float denom[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            denom[r] = fmaxf(l[r], 1e-30f);
        }

        // O / l in bf16 into this warpgroup's half of the Q tile (no longer
        // read), swizzled as the tensor map expects, then one TMA store.
#pragma unroll
        for (int j = 0; j < D / 2; j += 2) {
            const int r = (j >> 1) & 1;
            const int col = 8 * (j >> 2) + 2 * (lane % 4);
            const int row = cw * 64 + warp * 16 + lane / 4 + 8 * r;
            const uint32_t off = (col / T::BOXW) * BM * RB + hopper::swizzle<RB>(row * RB + (col % T::BOXW) * 2);
            *reinterpret_cast<__nv_bfloat162*>(base_ptr + T::q + off) =
                __floats2bfloat162_rn(o[j] / denom[r], o[j + 1] / denom[r]);
        }
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(1 + cw, 128);
        if (t == 0 && row_lo < p.L_q) {
            for (int x = 0; x < T::BOXES; ++x)
                hopper::tma_store_4d(&p.o, sQ + x * BM * RB + cw * 64 * RB, x * T::BOXW, row_lo, h, b);
            hopper::tma_store_commit_and_wait();
        }
        if (p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = my_row + 8 * r;
                if (row < p.L_q)
                    p.lse[static_cast<long long>(bh) * p.L_q + row] =
                        m[r] <= NEG_INF / 2 ? NEG_INF : m[r] / LOG2E + logf(denom[r]);
            }
        }
    }
}

template <int D, bool SOFTCAP>
cudaError_t set_smem_limit() {
    return cudaFuncSetAttribute(flash_fwd_tc_kernel<D, SOFTCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Tiles<D>::bytes));
}

template <int D>
cudaError_t launch(const Params& prm, int n_q_tiles, int n_bh, bool softcap, cudaStream_t stream) {
    const dim3 grid(n_bh, n_q_tiles);
    if (softcap)
        flash_fwd_tc_kernel<D, true><<<grid, THREADS, Tiles<D>::bytes, stream>>>(prm);
    else
        flash_fwd_tc_kernel<D, false><<<grid, THREADS, Tiles<D>::bytes, stream>>>(prm);
    return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------------------------- f32

namespace f32 {

constexpr int BM = 64;            // query rows per block
constexpr int BN = 64;            // keys per k tile
constexpr int WARPS = 4;
constexpr int ROWS = BM / WARPS;  // query rows owned by one warp

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout; row strides are padded against bank conflicts.
template <int D>
struct Smem {
    static constexpr int LD = D + 1;     // q/k/v tiles
    static constexpr int LDS = BN + 4;   // scores, then probabilities
    static constexpr int LDO = D + 4;    // output accumulator
    static constexpr size_t q = 0;
    static constexpr size_t k = align128(q + sizeof(float) * BM * LD);
    static constexpr size_t v = align128(k + sizeof(float) * BN * LD);
    static constexpr size_t s = align128(v + sizeof(float) * BN * LD);
    static constexpr size_t o = align128(s + sizeof(float) * BM * LDS);
    static constexpr size_t bytes = align128(o + sizeof(float) * BM * LDO);
};

struct Params {
    const float* q;
    const float* k;
    const float* v;
    float* o;     // (B, H, L_q, D), contiguous
    float* lse;   // (B, H, L_q), contiguous; null when not wanted
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

// Copy BN rows of D elements into a padded shared tile; rows at or past
// rows_valid are zero-filled, so keys past L_k contribute exact zeros to
// P·V and padded query rows stay finite.
template <int D>
__device__ void load_tile(float* dst, const float* src, long long row_stride, int rows_valid) {
    constexpr int LD = Smem<D>::LD;
    for (int i = threadIdx.x; i < BN * D; i += WARPS * 32) {
        const int r = i / D, c = i % D;
        dst[r * LD + c] = r < rows_valid ? src[r * row_stride + c] : 0.f;
    }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32) flash_fwd_f32_kernel(const Params prm) {
    static_assert(BM == BN, "load_tile copies BN rows for the q tile too");
    using S = Smem<D>;
    constexpr int LD = S::LD, LDS = S::LDS, LDO = S::LDO;
    extern __shared__ __align__(128) unsigned char smem[];
    float* sQ = reinterpret_cast<float*>(smem + S::q);
    float* sK = reinterpret_cast<float*>(smem + S::k);
    float* sV = reinterpret_cast<float*>(smem + S::v);
    float* sS = reinterpret_cast<float*>(smem + S::s);
    float* sO = reinterpret_cast<float*>(smem + S::o);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * ROWS;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // latest q tiles first
    const int bh = blockIdx.y;
    const int b = bh / prm.H, h = bh % prm.H, hk = h / prm.group;
    const float* gq = prm.q + b * prm.q_sb + h * prm.q_sh + q0 * prm.q_sl;
    const float* gk = prm.k + b * prm.k_sb + hk * prm.k_sh;
    const float* gv = prm.v + b * prm.v_sb + hk * prm.v_sh;

    load_tile<D>(sQ, gq, prm.q_sl, min(BM, prm.L_q - q0));
    for (int i = threadIdx.x; i < BM * LDO; i += WARPS * 32) sO[i] = 0.f;
    const KTiles<BM, BN> tiles(q0, prm.L_q, prm.L_k, prm.offset, prm.causal, prm.window, prm.sinks);

    const float scale_log2 = prm.scale * LOG2E;
    float m_run[ROWS], l_run[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) { m_run[r] = NEG_INF; l_run[r] = 0.f; }

    for (int it = 0; it < tiles.n_iter; ++it) {
        const int k0 = tiles.key0(it);
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile<D>(sK, gk + k0 * prm.k_sl, prm.k_sl, min(BN, prm.L_k - k0));
        load_tile<D>(sV, gv + k0 * prm.v_sl, prm.v_sl, min(BN, prm.L_k - k0));
        __syncthreads();

        // Raw scores S = Q·Kᵀ for the warp's rows; each lane holds keys
        // lane and lane + 32.
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

        // Online softmax in base 2, one row at a time.
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int row = r0 + r;
            const int pos = prm.offset + q0 + row;  // the query on the key timeline
            float s[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int key = k0 + lane + 32 * e;
                float x = acc[r][e];
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
            sS[row * LDS + lane] = p0;
            sS[row * LDS + lane + 32] = p1;
            for (int d = lane; d < D; d += 32) sO[row * LDO + d] *= alpha;
        }
        __syncwarp();

        // O += P·V for the warp's rows.
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int row = r0 + r;
            for (int d = lane; d < D; d += 32) {
                float a = sO[row * LDO + d];
                for (int c = 0; c < BN; ++c) a += sS[row * LDS + c] * sV[c * LD + d];
                sO[row * LDO + d] = a;
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
        float* out = prm.o + (static_cast<long long>(bh) * prm.L_q + q_row) * D;
        for (int d = lane; d < D; d += 32) out[d] = sO[(r0 + r) * LDO + d] / denom;
        if (prm.lse != nullptr && lane == 0)
            prm.lse[static_cast<long long>(bh) * prm.L_q + q_row] =
                m_run[r] <= NEG_INF / 2 ? NEG_INF : m_run[r] / LOG2E + logf(denom);
    }
}

template <int D>
cudaError_t set_smem_limit() {
    return cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Smem<D>::bytes));
}

template <int D>
cudaError_t launch(const Params& prm, int n_bh, cudaStream_t stream) {
    const int n_q_tiles = (prm.L_q + BM - 1) / BM;
    flash_fwd_f32_kernel<D><<<dim3(n_q_tiles, n_bh), WARPS * 32, Smem<D>::bytes, stream>>>(prm);
    return cudaGetLastError();
}

}  // namespace f32

// The bf16 path: tensor maps over the caller's strides, then the launch.
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int B, int H, int H_kv, int L_q, int L_k, int D,
                        const long long (&qs)[3], const long long (&ks)[3], const long long (&vs)[3],
                        int causal, int window, int sinks, float scale, float softcap, cudaStream_t stream) {
    if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
    tc::Params prm;
    const uint32_t boxw = D < 64 ? D : 64;
    const CUtensorMapSwizzle swz = D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    // Strides come in elements as (batch, head, row); maps take bytes as
    // (row, head, batch).
    const uint64_t q_st[3] = {2ull * qs[2], 2ull * qs[1], 2ull * qs[0]};
    const uint64_t k_st[3] = {2ull * ks[2], 2ull * ks[1], 2ull * ks[0]};
    const uint64_t v_st[3] = {2ull * vs[2], 2ull * vs[1], 2ull * vs[0]};
    const uint64_t o_st[3] = {2ull * D, 2ull * D * L_q, 2ull * D * L_q * H};
    const uint64_t q_dims[4] = {uint64_t(D), uint64_t(L_q), uint64_t(H), uint64_t(B)};
    const uint64_t kv_dims[4] = {uint64_t(D), uint64_t(L_k), uint64_t(H_kv), uint64_t(B)};
    const uint32_t q_box[4] = {boxw, tc::BM, 1, 1}, kv_box[4] = {boxw, tc::BN, 1, 1};
    const uint32_t o_box[4] = {boxw, tc::BM / tc::CONSUMERS, 1, 1};
    cudaError_t err = hopper::encode_bf16_4d(&prm.q, q, q_dims, q_st, q_box, swz);
    if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.k, k, kv_dims, k_st, kv_box, swz);
    if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.v, v, kv_dims, v_st, kv_box, swz);
    if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.o, o, q_dims, o_st, o_box, swz);
    if (err != cudaSuccess) return err;
    prm.lse = static_cast<float*>(lse);
    prm.H = H; prm.group = H / H_kv; prm.L_q = L_q; prm.L_k = L_k;
    prm.offset = causal ? L_k - L_q : 0;
    prm.causal = causal; prm.window = window; prm.sinks = sinks;
    prm.scale_log2 = scale * LOG2E;
    prm.scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;
    prm.cap_log2 = softcap * LOG2E;
    const int n_q_tiles = (L_q + tc::BM - 1) / tc::BM;
    if (n_q_tiles > 65535) return cudaErrorInvalidValue;  // grid y
    const bool cap = softcap > 0.f;
    switch (D) {
        case 32: return tc::launch<32>(prm, n_q_tiles, B * H, cap, stream);
        case 64: return tc::launch<64>(prm, n_q_tiles, B * H, cap, stream);
        default: return tc::launch<128>(prm, n_q_tiles, B * H, cap, stream);
    }
}

}  // namespace

// Raise the dynamic shared-memory limit of every kernel instance on the
// current device. Call once per device before the first launch.
extern "C" int flash_fwd_init() {
    cudaError_t err = tc::set_smem_limit<32, false>();
    if (err == cudaSuccess) err = tc::set_smem_limit<32, true>();
    if (err == cudaSuccess) err = tc::set_smem_limit<64, false>();
    if (err == cudaSuccess) err = tc::set_smem_limit<64, true>();
    if (err == cudaSuccess) err = tc::set_smem_limit<128, false>();
    if (err == cudaSuccess) err = tc::set_smem_limit<128, true>();
    if (err == cudaSuccess) err = f32::set_smem_limit<32>();
    if (err == cudaSuccess) err = f32::set_smem_limit<64>();
    if (err == cudaSuccess) err = f32::set_smem_limit<128>();
    return err;
}

// dtype: 0 = bf16, 1 = f32. window < 0 means no window; softcap <= 0 means
// no softcap; lse may be null. Strides are in elements; the head dim must
// be contiguous, and for bf16 the base and every stride 16-byte aligned
// (the tensor maps' rule).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int B, int H, int H_kv, int L_q, int L_k, int D,
                         long long q_sb, long long q_sh, long long q_sl,
                         long long k_sb, long long k_sh, long long k_sl,
                         long long v_sb, long long v_sh, long long v_sl,
                         int causal, int window, int sinks, float scale, float softcap,
                         void* stream) {
    if (H_kv < 1 || H % H_kv || L_q < 1 || L_k < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        const long long qs[3] = {q_sb, q_sh, q_sl}, ks[3] = {k_sb, k_sh, k_sl}, vs[3] = {v_sb, v_sh, v_sl};
        return launch_bf16(q, k, v, o, lse, B, H, H_kv, L_q, L_k, D, qs, ks, vs, causal, window, sinks,
                           scale, softcap, s);
    }
    if (dtype != 1) return cudaErrorInvalidValue;
    f32::Params prm;
    prm.q = static_cast<const float*>(q); prm.k = static_cast<const float*>(k);
    prm.v = static_cast<const float*>(v); prm.o = static_cast<float*>(o);
    prm.lse = static_cast<float*>(lse);
    prm.q_sb = q_sb; prm.q_sh = q_sh; prm.q_sl = q_sl;
    prm.k_sb = k_sb; prm.k_sh = k_sh; prm.k_sl = k_sl;
    prm.v_sb = v_sb; prm.v_sh = v_sh; prm.v_sl = v_sl;
    prm.H = H; prm.group = H / H_kv; prm.L_q = L_q; prm.L_k = L_k;
    prm.offset = causal ? L_k - L_q : 0;
    prm.causal = causal; prm.window = window; prm.sinks = sinks;
    prm.scale = scale; prm.softcap = softcap;
    switch (D) {
        case 32: return f32::launch<32>(prm, B * H, s);
        case 64: return f32::launch<64>(prm, B * H, s);
        case 128: return f32::launch<128>(prm, B * H, s);
        default: return cudaErrorInvalidValue;
    }
}
