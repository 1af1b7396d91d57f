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
// (≈ 13 µs at 3.35 TB/s). So both are bound by operations, and the bf16
// design is flash_fwd.cu's, built on hopper.cuh:
//
// - One block of three warpgroups. The producer warpgroup gives up its
//   registers (setmaxnreg); one of its threads issues TMA loads. The block
//   holds two resident tiles, loaded once, and streams pairs of 64-row
//   tiles through a ring of 4 stages, each with a full mbarrier per tile
//   and an empty one. Tensor maps are 4-D (D, L, H, B) over the caller's
//   strides, so strided head-split q, k, v and do are read in place; rows
//   past L read as zeros. Two consumer warpgroups run every product with
//   wgmma (m64n64k16 for the 64 x 64 score tiles, both operands K-major),
//   their accumulators in registers for the whole loop.
// - dq: one block per (q tile of 128 rows, b·h), the latest q tiles first.
//   Q and dO are resident; K and V tiles of 64 keys stream over the tiles
//   the band needs (the sink tiles, then the band, as in flash_fwd.cu).
//   Each consumer owns 64 query rows: per tile it computes S = Q·Kᵀ and
//   dP = dO·Vᵀ, then p and ds in registers (each thread holds two rows,
//   whose lse and Δ stay in registers), packs ds to bf16 pairs in place
//   (the accumulator layout is wgmma's register-A layout) and adds
//   dQ += dS·K with K read MN-major through the transpose bit.
// - dk/dv: one block per (k tile of 64 keys, b·h_kv), the earliest k tiles
//   first, transposed so that p and ds never leave the chip. K and V are
//   resident; Q and dO tiles of 64 queries stream over the group's q heads
//   and, for each, the q tiles of the transposed band (the TPU kernel's
//   _q_clamp as loop bounds; a k tile holding sink keys is attended by
//   every later query). A second producer warp writes each stage's lse (in
//   log2 units, +inf where p must be 0) and Δ beside its tiles. The
//   consumers split the work by product: consumer 0 computes Sᵀ = K·Qᵀ,
//   pᵀ and dV += Pᵀ·dO, consumer 1 dPᵀ = V·dOᵀ, dsᵀ and dK += dSᵀ·Q, with
//   dO and Q read MN-major, and p·chain passes from one to the other in
//   f32 through shared memory. dK and dV stay in f32 registers across the
//   whole GQA group and are written once: no per-q-head partials, no
//   atomics, the same bits on every run.
// - p and ds are rounded to bf16 before their products, as the TPU kernel
//   does; p is 2^(s·scale·log2 e − lse·log2 e) on ex2.approx, and only
//   tiles not wholly inside the band are masked, against per-row bounds.
//   The outputs are scaled, rounded to bf16 into a resident tile that is
//   no longer read, and stored by TMA (rows past L are not written).
//
// Not done yet: overlap of one tile's element-wise work with the next
// tile's products, ping-pong of the consumers, a persistent scheduler.
//
// f32 inputs take a scalar path (the tensor cores have no f32 x f32
// product; f32 is not on the probe's path): one block of 4 warps per 64-row
// tile, the same loops, tiles and score tiles in padded shared memory, the
// accumulators in registers.
//
// Launch contract: the C entries launch on the caller's stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().
// flash_bwd_init raises the dynamic shared-memory limit of every instance
// once, at load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // large-but-finite, as in the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;

// The k tiles of BN keys that a q tile of BM rows needs, in loop order:
// the sink tiles [0, sink_end), then the band [band_begin, band_end), never
// a tile twice (flash_fwd.cu's bounds: the TPU kernel's clamped index map).
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

// The q tiles of BQ rows that a k tile of BK keys at k0 needs, [begin, end):
// the transposed band (the TPU kernel's _q_clamp as loop bounds). The first
// query that sees key k0 sits at k0 − offset; with a window, the last one at
// k_last + window − offset, unless the tile holds sink keys, which every
// later query attends.
template <int BK, int BQ>
struct QTiles {
    int begin = 0, end = 0;

    __device__ QTiles(int k0, int L_q, int L_k, int offset, int causal, int window, int sinks) {
        end = (L_q + BQ - 1) / BQ;
        if (causal) {
            begin = max(0, k0 - offset) / BQ;
            if (window >= 0 && k0 >= sinks) {
                const int q_last = min(k0 + BK, L_k) - 1 + window - offset;
                end = q_last < 0 ? 0 : min(end, q_last / BQ + 1);
            }
        }
        end = max(begin, end);
    }
};

// ------------------------------------------------------------------ bf16

namespace tc {

constexpr int SMALL = 64;      // rows of a streamed tile and of a consumer's wgmma tiles
constexpr int STAGES = 4;      // ring depth: what 227 KB holds at D=128
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int DQ_ROWS = 128;   // dq: query rows of a block, 64 a consumer
constexpr int DKV_ROWS = 64;   // dk/dv: keys of a block, shared by the consumers
constexpr int PBUFS = 2;       // dk/dv: buffers handing p·chain from one consumer to the other
constexpr int PBUF_BYTES = SMALL * SMALL * 4;

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp, results
// below 2^-126 flushed to 0; 2^-inf is 0).
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&pair);
}

// How a tile of R rows x D is stored, as TMA writes it: D / W boxes of R
// rows x W elements, one swizzle row (RB bytes) per tile row.
template <int D>
struct Box {
    static constexpr int W = D < 64 ? D : 64;
    static constexpr int RB = 2 * W;
    static constexpr int N = D / W;
};

// Shared-memory layout (byte offsets from a 1024-aligned base): two
// resident tiles of RES rows, a ring of two streamed tiles per stage, each
// stage's lse and Δ (dk/dv), NP buffers of p·chain (dk/dv), barriers.
template <int D_, int RES_, int NP>
struct Tiles {
    static constexpr int D = D_, RES = RES_;
    static constexpr uint32_t res_bytes = RES * D * 2, small_bytes = SMALL * D * 2;
    static constexpr uint32_t res0 = 0;                              // Q (dq), K (dk/dv)
    static constexpr uint32_t res1 = res0 + res_bytes;               // dO (dq), V (dk/dv)
    static constexpr uint32_t ring0 = res1 + res_bytes;              // K (dq), Q (dk/dv), per stage
    static constexpr uint32_t ring1 = ring0 + STAGES * small_bytes;  // V (dq), dO (dk/dv), per stage
    static constexpr uint32_t rows = ring1 + STAGES * small_bytes;   // lse·log2(e), Δ per stage
    static constexpr uint32_t pbuf = rows + STAGES * 2 * SMALL * 4;
    static constexpr uint32_t bars = pbuf + NP * PBUF_BYTES;  // res; full0, full1, empty per stage; pfull, pempty
    static constexpr size_t bytes = bars + 8 * (1 + 3 * STAGES + 2 * NP) + 1024;  // + base realignment
};

template <int D>
using DqLayout = Tiles<D, DQ_ROWS, 0>;
template <int D>
using DkvLayout = Tiles<D, DKV_ROWS, PBUFS>;

struct Params {
    CUtensorMap q, k, v, dout;  // (D, L, H, B) bf16 over the caller's strides
    CUtensorMap out0, out1;     // dq; or dk and dv: (D, L, H, B) bf16, contiguous
    const float* lse;           // (B, H, L_q) f32, contiguous
    const float* delta;         // (B, H, L_q) f32, contiguous
    int H, H_kv, group, L_q, L_k, offset;
    int causal, window, sinks;  // window < 0: no window
    float scale, scale_log2;    // scale, scale · log2(e)
    float scale_over_cap, cap_log2;  // softcap instances: scale / cap, cap · log2(e)
};

// The block's shared memory: addresses of its tiles and barriers.
template <class T>
struct Block {
    static constexpr int D = T::D, RB = Box<D>::RB;
    unsigned char* ptr;  // the 1024-aligned base
    uint32_t base;       // and its shared-space address

    __device__ explicit Block(unsigned char* raw) {
        const uint32_t at = hopper::smem_u32(raw);
        base = (at + 1023) & ~1023u;
        ptr = raw + (base - at);
    }

    __device__ uint32_t res(int i) const { return base + (i ? T::res1 : T::res0); }
    __device__ uint32_t ring(int i, int s) const { return base + (i ? T::ring1 : T::ring0) + s * T::small_bytes; }
    __device__ float* rows(int s) const { return reinterpret_cast<float*>(ptr + T::rows) + s * 2 * SMALL; }
    __device__ float4* pbuf(int i) const { return reinterpret_cast<float4*>(ptr + T::pbuf + i * PBUF_BYTES); }
    __device__ uint32_t bar_res() const { return base + T::bars; }
    __device__ uint32_t full(int i, int s) const { return base + T::bars + 8 * (1 + i * STAGES + s); }
    __device__ uint32_t empty(int s) const { return base + T::bars + 8 * (1 + 2 * STAGES + s); }
    __device__ uint32_t pfull(int i) const { return base + T::bars + 8 * (1 + 3 * STAGES + i); }
    __device__ uint32_t pempty(int i) const { return base + T::bars + 8 * (1 + 3 * STAGES + PBUFS + i); }

    // The resident tiles' barrier and each stage's full ones take the
    // producer's arrive.expect_tx (full1 also `extra` plain arrivals);
    // empty takes one arrive per consumer warp; the p buffers' barriers one
    // per thread of the consumer that arrives on them.
    __device__ void init(int extra) const {
        if (threadIdx.x == 0) {
            hopper::mbar_init(bar_res(), 1);
            for (int s = 0; s < STAGES; ++s) {
                hopper::mbar_init(full(0, s), 1);
                hopper::mbar_init(full(1, s), 1 + extra);
                hopper::mbar_init(empty(s), CONSUMERS * 4);
            }
            if (T::pbuf != T::bars) {
                for (int i = 0; i < PBUFS; ++i) {
                    hopper::mbar_init(pfull(i), 128);
                    hopper::mbar_init(pempty(i), 128);
                }
            }
            hopper::fence_barrier_init();
        }
        __syncthreads();
    }

    // TMA-load the tile of n_rows rows at (row0, head, batch) into dst.
    __device__ static void load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int n_rows, int row0, int head,
                                int batch) {
        for (int x = 0; x < Box<D>::N; ++x)
            hopper::tma_load_4d(dst + x * n_rows * RB, map, bar, x * Box<D>::W, row0, head, batch);
    }

    // acc·factor (64 x D f32 in a consumer's accumulator layout) in bf16
    // into rows r0 .. r0 + 63 of the resident tile i, swizzled as the
    // tensor maps expect; then, from one thread, a TMA store of those rows
    // to the box at (row0, head, batch) of map (rows outside are not
    // written). The tile must no longer be read.
    __device__ void write_out(int i, const float (&acc)[D / 2], float factor, int r0, const CUtensorMap* map,
                              int row0, int head, int batch, int cw) const {
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        unsigned char* tile = ptr + (i ? T::res1 : T::res0);
#pragma unroll
        for (int j = 0; j < D / 2; j += 2) {
            const int col = 8 * (j >> 2) + 2 * (lane % 4);
            const int row = r0 + warp * 16 + lane / 4 + 8 * ((j >> 1) & 1);
            const uint32_t off =
                (col / Box<D>::W) * T::RES * RB + hopper::swizzle<RB>(row * RB + (col % Box<D>::W) * 2);
            *reinterpret_cast<__nv_bfloat162*>(tile + off) =
                __floats2bfloat162_rn(acc[j] * factor, acc[j + 1] * factor);
        }
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(1 + cw, 128);
        if (t == 0) {
            for (int x = 0; x < Box<D>::N; ++x)
                hopper::tma_store_4d(map, res(i) + x * T::RES * RB + r0 * RB, x * Box<D>::W, row0, head, batch);
            hopper::tma_store_commit_and_wait();
        }
    }
};

// wgmma descriptors. K-major: the k16 slice kk of the rows from r0 of a
// tile of tile_rows rows (the A or B operand of a product over D).
// MN-major: rows 16·kk .. 16·kk + 15 of a tile of tile_rows rows x D, the
// B operand (16 x D) of a product over the tile's rows, read with the
// transpose bit.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int tile_rows, int r0, int kk) {
    constexpr int RB = Box<D>::RB, W = Box<D>::W;
    const int x = kk * 16 / W, inner = kk * 16 % W;
    return hopper::make_desc(tile + x * tile_rows * RB + r0 * RB + inner * 2, 16, 8 * RB, RB);
}

template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int tile_rows, int kk) {
    constexpr int RB = Box<D>::RB;
    return hopper::make_desc(tile + kk * 16 * RB, tile_rows * RB, 8 * RB, RB);
}

// a (64 x 64, the accumulator layout) = A·Bᵀ over D, A the 64 rows from r0
// of a resident tile of res_rows rows and B a streamed tile, both K-major.
template <int D>
__device__ __forceinline__ void product_t(float (&a)[SMALL / 2], uint32_t resident, int res_rows, int r0,
                                          uint32_t streamed) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<SMALL>(a, desc_k<D>(resident, res_rows, r0, kk), desc_k<D>(streamed, SMALL, 0, kk), kk > 0);
}

// acc (64 x D) += A·B over a streamed tile's 64 rows, A packed bf16 in
// registers, B the streamed tile read MN-major.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[SMALL / 16][4],
                                           uint32_t streamed) {
#pragma unroll
    for (int kk = 0; kk < SMALL / 16; ++kk) hopper::wgmma_rs_tb<D>(acc, a[kk], desc_mn<D>(streamed, SMALL, kk), 1);
}

// The argument of 2^x that gives p from one raw score s and lse in log2
// units, before any mask, and the softcap chain factor.
template <bool SOFTCAP>
__device__ __forceinline__ float log2_p(float s, float lse2, const Params& p, float& chain) {
    if constexpr (SOFTCAP) {
        const float th = tanhf(s * p.scale_over_cap);
        chain = 1.f - th * th;  // d(cap·tanh(s/cap))/ds = 1 − (s_cap/cap)²
        return fmaf(p.cap_log2, th, -lse2);
    } else {
        chain = 1.f;
        return fmaf(s, p.scale_log2, -lse2);
    }
}

// lse in log2 units; +inf (so that p = 0) for a row that sees no key.
__device__ __forceinline__ float lse_log2(float lse) { return lse <= NEG_INF / 2 ? INFINITY : lse * LOG2E; }

// The dq kernel's ds of one tile, packed to bf16 pairs as wgmma's A
// operand. sc[4c + 2r + e] is row my_row + 8r, key c0 + 8c + e with
// c0 = k0 + 2·(lane % 4); lse2 and dlt are the two rows' lse (log2 units)
// and Δ. MASKED keeps the keys at offsets j = 8c + e from c0 with j <= hi,
// and j >= lo or j < sink_hi (flash_fwd.cu's test).
template <bool SOFTCAP, bool MASKED>
__device__ __forceinline__ void dq_grads(uint32_t (&da)[SMALL / 16][4], const float (&sc)[SMALL / 2],
                                         const float (&dp)[SMALL / 2], const float (&lse2)[2],
                                         const float (&dlt)[2], const int (&lo)[2], const int (&hi)[2], int sink_hi,
                                         const Params& p) {
#pragma unroll
    for (int c = 0; c < SMALL / 8; ++c) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 4 * c + 2 * r + e, j = 8 * c + e;
                float chain;
                float x = log2_p<SOFTCAP>(sc[i], lse2[r], p, chain);
                if (MASKED && !(j <= hi[r] && (j >= lo[r] || j < sink_hi))) x = -INFINITY;
                ds[e] = exp2_approx(x) * chain * (dp[i] - dlt[r]);
            }
            da[c / 2][2 * (c % 2) + r] = pack_bf16(ds[0], ds[1]);
        }
    }
}

// The dk/dv kernel's pᵀ of one tile, packed to bf16 pairs as wgmma's A
// operand, and p·chain in place of the scores. st[4c + 2r + e] is key
// my_key + 8r, query c0 + 8c + e with c0 = q0 + 2·(lane % 4), whose lse
// (log2 units) is rows[4c + lane % 4].x for e = 0 and .y for e = 1. MASKED
// keeps the queries at offsets j = 8c + e from c0 with lo <= j <= hi.
template <bool SOFTCAP, bool MASKED>
__device__ __forceinline__ void dkv_probs(uint32_t (&pa)[SMALL / 16][4], float (&st)[SMALL / 2],
                                          const float2* rows, int lane, const int (&lo)[2], const int (&hi)[2],
                                          const Params& p) {
#pragma unroll
    for (int c = 0; c < SMALL / 8; ++c) {
        const float2 l2 = rows[4 * c + lane % 4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float pr[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 4 * c + 2 * r + e, j = 8 * c + e;
                float chain;
                float x = log2_p<SOFTCAP>(st[i], e ? l2.y : l2.x, p, chain);
                if (MASKED && !(j >= lo[r] && j <= hi[r])) x = -INFINITY;
                pr[e] = exp2_approx(x);
                st[i] = pr[e] * chain;
            }
            pa[c / 2][2 * (c % 2) + r] = pack_bf16(pr[0], pr[1]);
        }
    }
}

// The dk/dv kernel's dsᵀ = p·chain ∘ (dPᵀ − Δ) of one tile, packed to bf16
// pairs as wgmma's A operand. pc holds this thread's p·chain, as the other
// consumer's thread of the same index wrote it: float4 c (stride 128) is
// its st[4c .. 4c + 3], the same elements as dpt[4c .. 4c + 3]; Δ of query
// c0 + 8c + e is rows[SMALL / 2 + 4c + lane % 4].x for e = 0, .y for e = 1.
__device__ __forceinline__ void dkv_grads(uint32_t (&da)[SMALL / 16][4], const float (&dpt)[SMALL / 2],
                                          const float4* pc, const float2* rows, int lane) {
#pragma unroll
    for (int c = 0; c < SMALL / 8; ++c) {
        const float4 pcv = pc[c * 128];
        const float2 dl = rows[SMALL / 2 + 4 * c + lane % 4];
        da[c / 2][2 * (c % 2)] = pack_bf16(pcv.x * (dpt[4 * c] - dl.x), pcv.y * (dpt[4 * c + 1] - dl.y));
        da[c / 2][2 * (c % 2) + 1] = pack_bf16(pcv.z * (dpt[4 * c + 2] - dl.x), pcv.w * (dpt[4 * c + 3] - dl.y));
    }
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(const __grid_constant__ Params p) {
    using T = DqLayout<D>;
    extern __shared__ unsigned char smem_raw[];
    const Block<T> blk(smem_raw);
    // Blocks start in order of x, then y: every (b, h) of the latest q
    // tile first, since under a causal mask those carry the most k tiles.
    const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;
    const int bh = blockIdx.x;
    const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
    const KTiles<DQ_ROWS, SMALL> tiles(q0, p.L_q, p.L_k, p.offset, p.causal, p.window, p.sinks);
    blk.init(0);

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // Producer. Nothing below reconverges with the consumers.
        hopper::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            hopper::prefetch_tensor_map(&p.q);
            hopper::prefetch_tensor_map(&p.dout);
            hopper::prefetch_tensor_map(&p.k);
            hopper::prefetch_tensor_map(&p.v);
            hopper::mbar_arrive_expect_tx(blk.bar_res(), 2 * T::res_bytes);
            blk.load(blk.res(0), &p.q, blk.bar_res(), DQ_ROWS, q0, h, b);
            blk.load(blk.res(1), &p.dout, blk.bar_res(), DQ_ROWS, q0, h, b);
            for (int it = 0; it < tiles.n_iter; ++it) {
                const int s = it % STAGES, k0 = tiles.key0(it);
                hopper::mbar_wait(blk.empty(s), ((it / STAGES) & 1) ^ 1);  // first round passes
                // K and V on barriers of their own: S = Q·Kᵀ starts while V lands.
                hopper::mbar_arrive_expect_tx(blk.full(0, s), T::small_bytes);
                blk.load(blk.ring(0, s), &p.k, blk.full(0, s), SMALL, k0, hk, b);
                hopper::mbar_arrive_expect_tx(blk.full(1, s), T::small_bytes);
                blk.load(blk.ring(1, s), &p.v, blk.full(1, s), SMALL, k0, hk, b);
            }
        }
    } else {
        hopper::setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = wg - 1;
        const int lane = threadIdx.x % 32;
        const int row_lo = q0 + cw * 64;                   // the warpgroup's first query row
        const int row_hi = min(row_lo + 63, p.L_q - 1);    // and its last valid one
        const int my_row = row_lo + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and + 8: the thread's rows

        // lse (log2 units) and Δ of the thread's two rows; rows past L_q get
        // +inf, hence p = 0, and are never read.
        float lse2[2], dlt[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = my_row + 8 * r;
            lse2[r] = INFINITY;
            dlt[r] = 0.f;
            if (row < p.L_q) {
                const long long at = static_cast<long long>(bh) * p.L_q + row;
                lse2[r] = lse_log2(p.lse[at]);
                dlt[r] = p.delta[at];
            }
        }

        float dq[D / 2];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;

        hopper::mbar_wait(blk.bar_res(), 0);
        for (int it = 0; it < tiles.n_iter; ++it) {
            const int s = it % STAGES, k0 = tiles.key0(it);
            const uint32_t phase = (it / STAGES) & 1;

            // S = Q·Kᵀ and dP = dO·Vᵀ for the warpgroup's 64 rows.
            float sc[SMALL / 2], dp[SMALL / 2];
            hopper::mbar_wait(blk.full(0, s), phase);
            hopper::wgmma_fence();
            product_t<D>(sc, blk.res(0), DQ_ROWS, cw * 64, blk.ring(0, s));
            hopper::wgmma_commit();
            hopper::mbar_wait(blk.full(1, s), phase);
            hopper::wgmma_fence();
            product_t<D>(dp, blk.res(1), DQ_ROWS, cw * 64, blk.ring(1, s));
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_operands(sc);
            hopper::fence_operands(dp);

            // p and ds; only a tile not wholly inside the band is masked.
            const bool whole = k0 + SMALL <= p.L_k &&
                               (!p.causal || (k0 + SMALL - 1 <= p.offset + row_lo &&
                                              (p.window < 0 || k0 >= p.offset + row_hi - p.window ||
                                               k0 + SMALL <= p.sinks)));
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
            uint32_t da[SMALL / 16][4];
            if (whole)
                dq_grads<SOFTCAP, false>(da, sc, dp, lse2, dlt, lo, hi, sink_hi, p);
            else
                dq_grads<SOFTCAP, true>(da, sc, dp, lse2, dlt, lo, hi, sink_hi, p);

            // dQ += dS·K, dS from registers, K (keys x D) MN-major.
            hopper::wgmma_fence();
            accumulate<D>(dq, da, blk.ring(0, s));
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_operands(dq);
#pragma unroll
            for (int kk = 0; kk < SMALL / 16; ++kk) hopper::fence_operands(da[kk]);
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(blk.empty(s));  // K and V of stage s are free
        }

        // dQ·scale into this warpgroup's half of the Q tile (no longer read).
        if (row_lo < p.L_q) blk.write_out(0, dq, p.scale, cw * 64, &p.out0, row_lo, h, b, cw);
    }
}

// dk/dv. The consumers split the work by product, not by rows: both take
// the block's 64 keys; consumer 0 computes Sᵀ, pᵀ and dV += Pᵀ·dO, consumer
// 1 computes dPᵀ, dsᵀ and dK += dSᵀ·Q, each with one 64 x D accumulator (a
// consumer holding both dK and dV, 128 registers a thread at D=128, left
// ptxas no room for Sᵀ and dPᵀ: it spilled and serialized the products).
// Consumer 0 hands p·chain to consumer 1 in f32 through two shared buffers,
// each guarded by a full and an empty mbarrier; both consumers hold a tile
// in the same accumulator layout, so thread t reads what thread t wrote.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
    using T = DkvLayout<D>;
    extern __shared__ unsigned char smem_raw[];
    const Block<T> blk(smem_raw);
    // Earliest k tiles first: under a causal mask they carry the most q tiles.
    const int k0 = blockIdx.y * DKV_ROWS;
    const int bhk = blockIdx.x;
    const int b = bhk / p.H_kv, hk = bhk % p.H_kv;
    const QTiles<DKV_ROWS, SMALL> band(k0, p.L_q, p.L_k, p.offset, p.causal, p.window, p.sinks);
    // The group's q heads, then the q tiles of the band, in a fixed order.
    const int n_qt = band.end - band.begin, n_iter = p.group * n_qt;
    blk.init(32);

    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    if (wg == 0) {
        // Producer: thread 0 issues the TMA loads, warp 1 writes each
        // stage's lse and Δ. Nothing below reconverges with the consumers.
        hopper::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            hopper::prefetch_tensor_map(&p.k);
            hopper::prefetch_tensor_map(&p.v);
            hopper::prefetch_tensor_map(&p.q);
            hopper::prefetch_tensor_map(&p.dout);
            hopper::mbar_arrive_expect_tx(blk.bar_res(), 2 * T::res_bytes);
            blk.load(blk.res(0), &p.k, blk.bar_res(), DKV_ROWS, k0, hk, b);
            blk.load(blk.res(1), &p.v, blk.bar_res(), DKV_ROWS, k0, hk, b);
            for (int it = 0; it < n_iter; ++it) {
                const int s = it % STAGES, h = hk * p.group + it / n_qt, q0 = (band.begin + it % n_qt) * SMALL;
                hopper::mbar_wait(blk.empty(s), ((it / STAGES) & 1) ^ 1);  // first round passes
                hopper::mbar_arrive_expect_tx(blk.full(0, s), T::small_bytes);
                blk.load(blk.ring(0, s), &p.q, blk.full(0, s), SMALL, q0, h, b);
                hopper::mbar_arrive_expect_tx(blk.full(1, s), T::small_bytes);
                blk.load(blk.ring(1, s), &p.dout, blk.full(1, s), SMALL, q0, h, b);
            }
        } else if (warp == 1) {
            // Queries past L_q get lse +inf, hence p = 0, and are never read.
            for (int it = 0; it < n_iter; ++it) {
                const int s = it % STAGES, h = hk * p.group + it / n_qt, q0 = (band.begin + it % n_qt) * SMALL;
                const long long at = (static_cast<long long>(b) * p.H + h) * p.L_q + q0;
                float* rows = blk.rows(s);
                hopper::mbar_wait(blk.empty(s), ((it / STAGES) & 1) ^ 1);
                for (int i = lane; i < SMALL; i += 32) {
                    const bool ok = q0 + i < p.L_q;
                    rows[i] = ok ? lse_log2(p.lse[at + i]) : INFINITY;
                    rows[SMALL + i] = ok ? p.delta[at + i] : 0.f;
                }
                hopper::mbar_arrive(blk.full(1, s));
            }
        }
    } else {
        hopper::setmaxnreg_inc<CONSUMER_REGS>();
        const int t = threadIdx.x % 128;
        const int my_key = k0 + warp * 16 + lane / 4;  // and + 8: the thread's two keys
        float acc[D / 2];                              // consumer 0: dV; consumer 1: dK
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
        hopper::mbar_wait(blk.bar_res(), 0);

        if (wg == 1) {
            for (int it = 0; it < n_iter; ++it) {
                const int s = it % STAGES, q0 = (band.begin + it % n_qt) * SMALL, pb = it % PBUFS;
                const uint32_t phase = (it / STAGES) & 1;

                // Sᵀ = K·Qᵀ for the block's 64 keys and the tile's 64 queries.
                float st[SMALL / 2];
                hopper::mbar_wait(blk.full(0, s), phase);
                hopper::wgmma_fence();
                product_t<D>(st, blk.res(0), DKV_ROWS, 0, blk.ring(0, s));
                hopper::wgmma_commit();
                hopper::mbar_wait(blk.full(1, s), phase);  // dO, lse and Δ
                hopper::wgmma_wait<0>();
                hopper::fence_operands(st);

                // pᵀ; only a tile not wholly inside the band is masked.
                const bool whole = k0 + DKV_ROWS <= p.L_k &&
                                   (!p.causal || (k0 + DKV_ROWS - 1 <= p.offset + q0 &&
                                                  (p.window < 0 || k0 + DKV_ROWS <= p.sinks ||
                                                   k0 >= p.offset + q0 + SMALL - 1 - p.window)));
                const int c0 = q0 + 2 * (lane % 4);
                int lo[2], hi[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int key = my_key + 8 * r;
                    lo[r] = p.causal ? key - p.offset - c0 : INT_MIN;  // the first query that sees it
                    hi[r] = p.causal && p.window >= 0 && key >= p.sinks ? key + p.window - p.offset - c0
                                                                        : INT_MAX;
                    if (key >= p.L_k) lo[r] = INT_MAX;
                }
                const float2* rows = reinterpret_cast<const float2*>(blk.rows(s));
                uint32_t pa[SMALL / 16][4];
                if (whole)
                    dkv_probs<SOFTCAP, false>(pa, st, rows, lane, lo, hi, p);
                else
                    dkv_probs<SOFTCAP, true>(pa, st, rows, lane, lo, hi, p);

                // p·chain to consumer 1.
                hopper::mbar_wait(blk.pempty(pb), ((it / PBUFS) & 1) ^ 1);  // first round passes
                float4* pc = blk.pbuf(pb) + t;
#pragma unroll
                for (int c = 0; c < SMALL / 8; ++c)
                    pc[c * 128] = make_float4(st[4 * c], st[4 * c + 1], st[4 * c + 2], st[4 * c + 3]);
                hopper::mbar_arrive(blk.pfull(pb));

                // dV += Pᵀ·dO, Pᵀ from registers, dO (queries x D) MN-major.
                hopper::wgmma_fence();
                accumulate<D>(acc, pa, blk.ring(1, s));
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
                hopper::fence_operands(acc);
#pragma unroll
                for (int kk = 0; kk < SMALL / 16; ++kk) hopper::fence_operands(pa[kk]);
                __syncwarp();
                if (lane == 0) hopper::mbar_arrive(blk.empty(s));
            }
            // dV into the K tile, which only this consumer read.
            if (k0 < p.L_k) blk.write_out(0, acc, 1.f, 0, &p.out1, k0, hk, b, 0);
        } else {
            for (int it = 0; it < n_iter; ++it) {
                const int s = it % STAGES, pb = it % PBUFS;
                const uint32_t phase = (it / STAGES) & 1;

                // dPᵀ = V·dOᵀ for the block's 64 keys and the tile's 64 queries.
                float dpt[SMALL / 2];
                hopper::mbar_wait(blk.full(1, s), phase);
                hopper::wgmma_fence();
                product_t<D>(dpt, blk.res(1), DKV_ROWS, 0, blk.ring(1, s));
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
                hopper::fence_operands(dpt);

                // dsᵀ from consumer 0's p·chain.
                hopper::mbar_wait(blk.pfull(pb), (it / PBUFS) & 1);
                uint32_t da[SMALL / 16][4];
                dkv_grads(da, dpt, blk.pbuf(pb) + t, reinterpret_cast<const float2*>(blk.rows(s)), lane);
                hopper::mbar_arrive(blk.pempty(pb));

                // dK += dSᵀ·Q, dSᵀ from registers, Q (queries x D) MN-major.
                hopper::mbar_wait(blk.full(0, s), phase);
                hopper::wgmma_fence();
                accumulate<D>(acc, da, blk.ring(0, s));
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
                hopper::fence_operands(acc);
#pragma unroll
                for (int kk = 0; kk < SMALL / 16; ++kk) hopper::fence_operands(da[kk]);
                __syncwarp();
                if (lane == 0) hopper::mbar_arrive(blk.empty(s));
            }
            // dK·scale into the V tile, which only this consumer read.
            if (k0 < p.L_k) blk.write_out(1, acc, p.scale, 0, &p.out0, k0, hk, b, 1);
        }
    }
}

template <int D, bool SOFTCAP>
cudaError_t set_smem_limits() {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, SOFTCAP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(DqLayout<D>::bytes));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, SOFTCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(DkvLayout<D>::bytes));
}

template <int D, bool SOFTCAP>
cudaError_t launch(const Params& prm, bool dq, dim3 grid, cudaStream_t stream) {
    if (dq)
        flash_bwd_dq_kernel<D, SOFTCAP><<<grid, THREADS, DqLayout<D>::bytes, stream>>>(prm);
    else
        flash_bwd_dkv_kernel<D, SOFTCAP><<<grid, THREADS, DkvLayout<D>::bytes, stream>>>(prm);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& prm, bool dq, bool softcap, dim3 grid, cudaStream_t stream) {
    return softcap ? launch<D, true>(prm, dq, grid, stream) : launch<D, false>(prm, dq, grid, stream);
}

}  // namespace tc

// ------------------------------------------------------------------- f32

namespace f32 {

constexpr int TILE = 64;  // query rows of a q tile, keys of a k tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = TILE / WARPS;  // rows owned by one warp

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout, the same for both kernels: four input tiles and two
// score-shaped tiles, row strides padded against bank conflicts.
template <int D>
struct Smem {
    static constexpr int LD = D + 1;      // input tiles
    static constexpr int LDS = TILE + 4;  // score tiles
    static constexpr size_t in_tile = sizeof(float) * TILE * LD;
    static constexpr size_t score_tile = sizeof(float) * TILE * LDS;
    static constexpr size_t in0 = 0;
    static constexpr size_t in1 = align128(in0 + in_tile);
    static constexpr size_t in2 = align128(in1 + in_tile);
    static constexpr size_t in3 = align128(in2 + in_tile);
    static constexpr size_t s = align128(in3 + in_tile);
    static constexpr size_t dp = align128(s + score_tile);
    static constexpr size_t rows = align128(dp + score_tile);  // lse, Δ of a q tile
    static constexpr size_t bytes = align128(rows + sizeof(float) * 2 * TILE);
};

struct Params {
    const float* q;
    const float* k;
    const float* v;
    const float* dout;
    const float* lse;    // (B, H, L_q), contiguous
    const float* delta;  // (B, H, L_q), contiguous
    float* dq;           // (B, H, L_q, D), contiguous
    float* dk;           // (B, H_kv, L_k, D), contiguous
    float* dv;
    long long q_sb, q_sh, q_sl;  // element strides of batch, head, row
    long long k_sb, k_sh, k_sl;
    long long v_sb, v_sh, v_sl;
    long long o_sb, o_sh, o_sl;  // of dout
    int H, H_kv, group, L_q, L_k, offset;
    int causal, window, sinks;   // window < 0: no window
    float scale, softcap;        // softcap <= 0: no softcap
};

// Copy TILE rows of D elements into a padded shared tile; rows at or past
// rows_valid are zero-filled, so padded keys and queries stay finite.
template <int D>
__device__ void load_tile(float* dst, const float* src, long long row_stride, int rows_valid) {
    constexpr int LD = Smem<D>::LD;
    for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
        const int r = i / D, c = i % D;
        dst[r * LD + c] = r < rows_valid ? src[r * row_stride + c] : 0.f;
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

// The warp's 16 x TILE tiles of a·bᵀ and c·dᵀ: rows r0.. of a and c
// against all TILE rows of b and d. Each lane computes columns lane and
// lane + 32; one product at a time keeps the register count down.
template <int D>
__device__ void two_products_t(float* out_ab, float* out_cd, const float* a, const float* b, const float* c,
                               const float* d, int r0, int lane) {
    constexpr int LD = Smem<D>::LD, LDS = Smem<D>::LDS;
    for (int which = 0; which < 2; ++which) {
        const float* x = which ? c : a;
        const float* y = which ? d : b;
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

// acc[r][e] += Σ_c x[r0 + r][c] · y[c][lane + 32·e] for the warp's rows of
// the score tile x (16 x TILE) and the input tile y (TILE x D).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[ROWS][D / 32], const float* x, const float* y, int r0,
                                           int lane) {
    constexpr int LD = Smem<D>::LD, LDS = Smem<D>::LDS;
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

// Write the warp's rows of acc·factor to out; rows past n_valid are dropped.
template <int D>
__device__ void write_rows(float* out, float (&acc)[ROWS][D / 32], float factor, int r0, int n_valid, int lane) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        if (r0 + r >= n_valid) continue;
#pragma unroll
        for (int e = 0; e < D / 32; ++e) out[(r0 + r) * D + lane + 32 * e] = acc[r][e] * factor;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32_kernel(const Params prm) {
    using S = Smem<D>;
    constexpr int LDS = S::LDS;
    extern __shared__ __align__(128) unsigned char smem[];
    float* sQ = reinterpret_cast<float*>(smem + S::in0);
    float* sDO = reinterpret_cast<float*>(smem + S::in1);
    float* sK = reinterpret_cast<float*>(smem + S::in2);
    float* sV = reinterpret_cast<float*>(smem + S::in3);
    float* sS = reinterpret_cast<float*>(smem + S::s);
    float* sDP = reinterpret_cast<float*>(smem + S::dp);
    float* sLse = reinterpret_cast<float*>(smem + S::rows);
    float* sDelta = sLse + TILE;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * ROWS;
    // Latest q tiles first: under a causal mask they carry the most k tiles.
    const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
    const int bh = blockIdx.y;
    const int b = bh / prm.H, h = bh % prm.H, hk = h / prm.group;
    const float* gk = prm.k + b * prm.k_sb + hk * prm.k_sh;
    const float* gv = prm.v + b * prm.v_sb + hk * prm.v_sh;
    const int q_valid = min(TILE, prm.L_q - q0);

    load_tile<D>(sQ, prm.q + b * prm.q_sb + h * prm.q_sh + q0 * prm.q_sl, prm.q_sl, q_valid);
    load_tile<D>(sDO, prm.dout + b * prm.o_sb + h * prm.o_sh + q0 * prm.o_sl, prm.o_sl, q_valid);
    load_rows(sLse, sDelta, prm, bh, q0);
    const KTiles<TILE, TILE> tiles(q0, prm.L_q, prm.L_k, prm.offset, prm.causal, prm.window, prm.sinks);

    float acc[ROWS][D / 32] = {};
    for (int it = 0; it < tiles.n_iter; ++it) {
        const int k0 = tiles.key0(it);
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile<D>(sK, gk + k0 * prm.k_sl, prm.k_sl, min(TILE, prm.L_k - k0));
        load_tile<D>(sV, gv + k0 * prm.v_sl, prm.v_sl, min(TILE, prm.L_k - k0));
        __syncthreads();

        // S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 query rows.
        two_products_t<D>(sS, sDP, sQ, sK, sDO, sV, r0, lane);
        __syncwarp();

        // ds in place of S, one row at a time; each lane holds keys lane
        // and lane + 32.
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int row = r0 + r;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = lane + 32 * e;
                sS[row * LDS + col] = p_ds(sS[row * LDS + col], sDP[row * LDS + col], sLse[row], sDelta[row],
                                           q0 + row, k0 + col, prm).ds;
            }
        }
        __syncwarp();

        // dQ += dS·K (scaled once at the write-back).
        accumulate<D>(acc, sS, sK, r0, lane);
        __syncwarp();
    }
    write_rows<D>(prm.dq + (static_cast<long long>(bh) * prm.L_q + q0) * D, acc, prm.scale, r0, q_valid, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_f32_kernel(const Params prm) {
    using S = Smem<D>;
    constexpr int LDS = S::LDS;
    extern __shared__ __align__(128) unsigned char smem[];
    float* sK = reinterpret_cast<float*>(smem + S::in0);
    float* sV = reinterpret_cast<float*>(smem + S::in1);
    float* sQ = reinterpret_cast<float*>(smem + S::in2);
    float* sDO = reinterpret_cast<float*>(smem + S::in3);
    float* sST = reinterpret_cast<float*>(smem + S::s);    // Sᵀ, then pᵀ: keys x queries
    float* sDPT = reinterpret_cast<float*>(smem + S::dp);  // dPᵀ, then dsᵀ
    float* sLse = reinterpret_cast<float*>(smem + S::rows);
    float* sDelta = sLse + TILE;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * ROWS;
    // Earliest k tiles first: under a causal mask they carry the most q tiles.
    const int k0 = blockIdx.x * TILE;
    const int bhk = blockIdx.y;
    const int b = bhk / prm.H_kv, hk = bhk % prm.H_kv;
    const int k_valid = min(TILE, prm.L_k - k0);

    load_tile<D>(sK, prm.k + b * prm.k_sb + hk * prm.k_sh + k0 * prm.k_sl, prm.k_sl, k_valid);
    load_tile<D>(sV, prm.v + b * prm.v_sb + hk * prm.v_sh + k0 * prm.v_sl, prm.v_sl, k_valid);
    const QTiles<TILE, TILE> band(k0, prm.L_q, prm.L_k, prm.offset, prm.causal, prm.window, prm.sinks);

    float dk[ROWS][D / 32] = {}, dv[ROWS][D / 32] = {};
    // The group sum: every q head of this kv head adds into the same
    // accumulators, in a fixed order.
    for (int g = 0; g < prm.group; ++g) {
        const int h = hk * prm.group + g;
        const long long bh = static_cast<long long>(b) * prm.H + h;
        const float* gq = prm.q + b * prm.q_sb + h * prm.q_sh;
        const float* gdo = prm.dout + b * prm.o_sb + h * prm.o_sh;
        for (int qt = band.begin; qt < band.end; ++qt) {
            const int q0 = qt * TILE;
            __syncthreads();  // every warp is done with the previous Q/dO tile
            load_tile<D>(sQ, gq + q0 * prm.q_sl, prm.q_sl, min(TILE, prm.L_q - q0));
            load_tile<D>(sDO, gdo + q0 * prm.o_sl, prm.o_sl, min(TILE, prm.L_q - q0));
            load_rows(sLse, sDelta, prm, bh, q0);
            __syncthreads();

            // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys.
            two_products_t<D>(sST, sDPT, sK, sQ, sV, sDO, r0, lane);
            __syncwarp();

            // pᵀ and dsᵀ in place, one key row at a time; each lane holds
            // queries lane and lane + 32.
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const int row = r0 + r;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = lane + 32 * e;
                    const PDs pd = p_ds(sST[row * LDS + col], sDPT[row * LDS + col], sLse[col], sDelta[col],
                                        q0 + col, k0 + row, prm);
                    sST[row * LDS + col] = pd.p;
                    sDPT[row * LDS + col] = pd.ds;
                }
            }
            __syncwarp();

            // dV += Pᵀ·dO and dK += dSᵀ·Q (scaled once at the write-back).
            accumulate<D>(dv, sST, sDO, r0, lane);
            accumulate<D>(dk, sDPT, sQ, r0, lane);
            __syncwarp();
        }
    }
    const long long out_row = static_cast<long long>(bhk) * prm.L_k + k0;
    write_rows<D>(prm.dk + out_row * D, dk, prm.scale, r0, k_valid, lane);
    write_rows<D>(prm.dv + out_row * D, dv, 1.f, r0, k_valid, lane);
}

template <int D>
cudaError_t set_smem_limits() {
    constexpr int bytes = static_cast<int>(Smem<D>::bytes);
    const cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch(const Params& prm, bool dq, int B, cudaStream_t stream) {
    constexpr size_t bytes = Smem<D>::bytes;
    if (dq) {
        const dim3 grid((prm.L_q + TILE - 1) / TILE, B * prm.H);
        flash_bwd_dq_f32_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
    } else {
        const dim3 grid((prm.L_k + TILE - 1) / TILE, B * prm.H_kv);
        flash_bwd_dkv_f32_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
    }
    return cudaGetLastError();
}

}  // namespace f32

// The bf16 path: tensor maps over the caller's strides, then the launch.
// dq keeps Q and dO resident (128-row boxes) and streams K and V (64-row
// boxes); dk/dv keeps K and V resident (64 rows) and streams Q and dO.
// Each output is stored in boxes of 64 rows.
cudaError_t launch_bf16(bool dq, const void* q, const void* k, const void* v, const void* dout, const void* lse,
                        const void* delta, void* out0, void* out1, int B, int H, int H_kv, int L_q, int L_k, int D,
                        const long long (&qs)[3], const long long (&ks)[3], const long long (&vs)[3],
                        const long long (&os)[3], int causal, int window, int sinks, float scale, float softcap,
                        cudaStream_t stream) {
    using namespace tc;
    if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
    Params prm;
    const uint32_t boxw = D < 64 ? D : 64;
    const CUtensorMapSwizzle swz = D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    // Strides come in elements as (batch, head, row); maps take bytes as
    // (row, head, batch).
    const uint64_t q_st[3] = {2ull * qs[2], 2ull * qs[1], 2ull * qs[0]};
    const uint64_t k_st[3] = {2ull * ks[2], 2ull * ks[1], 2ull * ks[0]};
    const uint64_t v_st[3] = {2ull * vs[2], 2ull * vs[1], 2ull * vs[0]};
    const uint64_t o_st[3] = {2ull * os[2], 2ull * os[1], 2ull * os[0]};
    const uint64_t q_dims[4] = {uint64_t(D), uint64_t(L_q), uint64_t(H), uint64_t(B)};
    const uint64_t kv_dims[4] = {uint64_t(D), uint64_t(L_k), uint64_t(H_kv), uint64_t(B)};
    const uint32_t q_rows = dq ? DQ_ROWS : SMALL, kv_rows = dq ? SMALL : DKV_ROWS;
    const uint32_t q_box[4] = {boxw, q_rows, 1, 1}, kv_box[4] = {boxw, kv_rows, 1, 1};
    const uint32_t out_box[4] = {boxw, 64, 1, 1};
    cudaError_t err = hopper::encode_bf16_4d(&prm.q, q, q_dims, q_st, q_box, swz);
    if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.dout, dout, q_dims, o_st, q_box, swz);
    if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.k, k, kv_dims, k_st, kv_box, swz);
    if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.v, v, kv_dims, v_st, kv_box, swz);
    if (dq) {
        const uint64_t dq_st[3] = {2ull * D, 2ull * D * L_q, 2ull * D * L_q * H};
        if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.out0, out0, q_dims, dq_st, out_box, swz);
    } else {
        const uint64_t dkv_st[3] = {2ull * D, 2ull * D * L_k, 2ull * D * L_k * H_kv};
        if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.out0, out0, kv_dims, dkv_st, out_box, swz);
        if (err == cudaSuccess) err = hopper::encode_bf16_4d(&prm.out1, out1, kv_dims, dkv_st, out_box, swz);
    }
    if (err != cudaSuccess) return err;
    prm.lse = static_cast<const float*>(lse);
    prm.delta = static_cast<const float*>(delta);
    prm.H = H; prm.H_kv = H_kv; prm.group = H / H_kv; prm.L_q = L_q; prm.L_k = L_k;
    prm.offset = causal ? L_k - L_q : 0;
    prm.causal = causal; prm.window = window; prm.sinks = sinks;
    prm.scale = scale;
    prm.scale_log2 = scale * LOG2E;
    prm.scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;
    prm.cap_log2 = softcap * LOG2E;
    const int rows = dq ? DQ_ROWS : DKV_ROWS;
    const int n_tiles = ((dq ? L_q : L_k) + rows - 1) / rows;
    if (n_tiles > 65535) return cudaErrorInvalidValue;  // grid y
    const dim3 grid(B * (dq ? H : H_kv), n_tiles);
    const bool cap = softcap > 0.f;
    switch (D) {
        case 32: return launch<32>(prm, dq, cap, grid, stream);
        case 64: return launch<64>(prm, dq, cap, grid, stream);
        default: return launch<128>(prm, dq, cap, grid, stream);
    }
}

int run(bool dq, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* out0, void* out1, int dtype, int B, int H, int H_kv, int L_q, int L_k, int D,
        long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh, long long k_sl,
        long long v_sb, long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
        int causal, int window, int sinks, float scale, float softcap, void* stream) {
    if (H_kv < 1 || H % H_kv || L_q < 1 || L_k < 1 || (causal && L_q > L_k)) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        const long long qs[3] = {q_sb, q_sh, q_sl}, ks[3] = {k_sb, k_sh, k_sl};
        const long long vs[3] = {v_sb, v_sh, v_sl}, os[3] = {o_sb, o_sh, o_sl};
        return launch_bf16(dq, q, k, v, dout, lse, delta, out0, out1, B, H, H_kv, L_q, L_k, D, qs, ks, vs, os,
                           causal, window, sinks, scale, softcap, s);
    }
    if (dtype != 1) return cudaErrorInvalidValue;
    f32::Params prm;
    prm.q = static_cast<const float*>(q); prm.k = static_cast<const float*>(k);
    prm.v = static_cast<const float*>(v); prm.dout = static_cast<const float*>(dout);
    prm.lse = static_cast<const float*>(lse); prm.delta = static_cast<const float*>(delta);
    prm.dq = dq ? static_cast<float*>(out0) : nullptr;
    prm.dk = dq ? nullptr : static_cast<float*>(out0);
    prm.dv = dq ? nullptr : static_cast<float*>(out1);
    prm.q_sb = q_sb; prm.q_sh = q_sh; prm.q_sl = q_sl;
    prm.k_sb = k_sb; prm.k_sh = k_sh; prm.k_sl = k_sl;
    prm.v_sb = v_sb; prm.v_sh = v_sh; prm.v_sl = v_sl;
    prm.o_sb = o_sb; prm.o_sh = o_sh; prm.o_sl = o_sl;
    prm.H = H; prm.H_kv = H_kv; prm.group = H / H_kv; prm.L_q = L_q; prm.L_k = L_k;
    prm.offset = causal ? L_k - L_q : 0;
    prm.causal = causal; prm.window = window; prm.sinks = sinks;
    prm.scale = scale; prm.softcap = softcap;
    switch (D) {
        case 32: return f32::launch<32>(prm, dq, B, s);
        case 64: return f32::launch<64>(prm, dq, B, s);
        case 128: return f32::launch<128>(prm, dq, B, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int flash_bwd_init() {
    cudaError_t err = tc::set_smem_limits<32, false>();
    if (err == cudaSuccess) err = tc::set_smem_limits<32, true>();
    if (err == cudaSuccess) err = tc::set_smem_limits<64, false>();
    if (err == cudaSuccess) err = tc::set_smem_limits<64, true>();
    if (err == cudaSuccess) err = tc::set_smem_limits<128, false>();
    if (err == cudaSuccess) err = tc::set_smem_limits<128, true>();
    if (err == cudaSuccess) err = f32::set_smem_limits<32>();
    if (err == cudaSuccess) err = f32::set_smem_limits<64>();
    if (err == cudaSuccess) err = f32::set_smem_limits<128>();
    return err;
}

// dtype: 0 = bf16, 1 = f32. window < 0 means no window; softcap <= 0 means
// no softcap. Strides are in elements; the head dim of q, k, v and dout
// must be contiguous, and the base and every stride 16-byte aligned (for
// bf16, the tensor maps' rule; no broadcast dim). lse and delta are
// (B, H, L_q) f32; dq is (B, H, L_q, D), contiguous.
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
