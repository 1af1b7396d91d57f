// Flash-decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel gpumounter_tpu/ops/flash_decode.py::_decode_kernel
// (launched by flash_decode). Same function: the newest l_q tokens of each
// sequence, q (B, H, l_q, D), attend a fixed-shape KV cache (B, H_kv, L_max,
// D) whose valid length n is an int32 that lives on the device. n is
// clamped to [l_q, L_max]; query row i sits at position n - l_q + i and
// attends the keys k <= its position, within the window [pos - window, pos]
// joined with the sinks [0, sinks) when a window is set. Slots >= n never
// contribute, whatever they hold. q head h reads kv head h / group. Scores
// are f32, softmax is the natural-exp online softmax of the TPU kernel
// (NEG_INF finite, m stays NEG_INF for a row that has seen no key), and P
// is rounded to the cache's dtype before P·V, with f32 accumulators.
//
// The dynamic length. A block reads n from device memory and turns the TPU
// kernel's clamped kv_index into loop bounds: the sink tiles first, then
// [max(first band tile, sink tiles), last valid tile], never a tile twice.
// The grid and the shared memory depend only on the shapes and L_max,
// never on n, so one launch configuration (and one captured CUDA graph)
// serves every length; the wrapper never reads n on the host.
//
// What bounds it on the H100. At the serving shape (B=4, H=H_kv=8, l_q=1,
// D=128, bf16, n=2048) the valid K+V region is 2·4·8·2048·128·2 B = 33.6 MB,
// ≈ 10.0 µs at 3.35 TB/s, against 4·D operations per (query, key) pair:
// bound by bytes at every length and shape the probe runs. So the design
// keeps HBM busy from the first tile to the last and spends as few
// instructions per tile as it can:
//
// - bf16, one block an SM = one consumer warpgroup + one producer warp.
//   The producer's one thread issues TMA loads of 64-key K and V tiles (4-D
//   tensor maps over the caller's strides, 128-byte swizzle, 64-byte at
//   D=32) into a ring of as many stages as shared memory holds, at most 8
//   (6 at D=128: 192 KB in flight an SM), with full-K, full-V and empty
//   mbarriers. Measured on an H100: one block an SM with the deep ring
//   beat two blocks an SM with half the ring at every shape timed, since
//   the consumer keeps up (about 0.7 µs a tile from L2, against about 1.4
//   µs for a tile to arrive from HBM) and fewer splits mean less to merge.
// - The products run on the tensor cores with the query rows on wgmma's N
//   side ("swap AB"): Sᵀ = K·Qᵀ is m64nNk16 with the K tile as A (K-major)
//   and the block's query rows as B (N = group·l_q padded to 8, 16, 32 or
//   64, staged once in shared memory); Oᵀ += Vᵀ·Pᵀ has the V tile as A,
//   read MN-major through the transpose bit, and Pᵀ as B, written to shared
//   memory in bf16 after the softmax. The serving shape's single row wastes
//   7/8 of an N = 8 product instead of 63/64 of a 64-row tile. At D=32 the
//   m64 product's upper 32 rows of Oᵀ read whatever lies past the V tile
//   and are never stored.
// - Softmax along Sᵀ's columns: a thread holds two keys of N/4 columns; a
//   column's max is a 3-step shuffle and a 4-warp exchange in shared memory
//   (one named barrier of the consumer warpgroup), its sum stays per thread
//   until the end. A second named barrier publishes Pᵀ to the products. No
//   block-wide barrier sits in the tile loop.
// - TMA zero-fills only slots past L_max. Slots in [n, L_max) of the tile
//   that holds slot n - 1 arrive as whatever the cache holds (NaN too):
//   their scores are masked by selection, and the consumer zeroes those V
//   rows in shared memory before Vᵀ·Pᵀ, where 0 x NaN would be NaN.
// - Keys are split across blocks so that the grid fills the card whatever
//   B·H_kv is (the wrapper picks n_splits from the shapes: one block an SM,
//   one wave); each split writes an unnormalised partial (m, l, acc) in
//   f32. A second kernel, flash_decode_merge, launched after it on the same
//   stream, merges the partials in split order, its reads in flight
//   together, and writes the output: the same bits on every run. Measured
//   on an H100, merging in the split kernel's last block instead saved
//   0.5-1 µs a call, but needs tickets that are zero before the launch:
//   kept zeroed between calls, they are shared by every stream; zeroed by
//   a memset each call, they cost 2.6 µs.
// - group·l_q rows beyond 64 go to further row chunks (grid z), each
//   reading its K/V once.
//
// f32 inputs take a CUDA-core path (the tensor cores have no f32 x f32
// product; f32 is not on the probe's path): 128 threads, a two-stage
// cp.async ring zero-filled past n, scores and P·V as scalar FMAs, up to 64
// rows of a chunk in shared memory, and the same merge kernel.
//
// Launch contract: the C entry launches both kernels on the caller's
// stream, does not synchronise, allocates nothing (the wrapper allocates
// the output and the partials), and returns cudaGetLastError().
// flash_decode_init raises the dynamic shared-memory limit of every
// instance once, at load, so a launch does no per-launch host work that a
// graph capture would forbid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // large-but-finite, as in the TPU kernel
constexpr int CHUNK_ROWS = 64;     // group·l_q rows of one block; more take further chunks
constexpr int MERGE_THREADS = 128; // a merge block's threads

struct Params {
    CUtensorMap k_map, v_map;  // bf16: (D, L_max, H_kv, B) over the caller's strides
    const void* q;
    const void* k;
    const void* v;
    void* o;               // (B, H, l_q, D), contiguous
    float* part_acc;       // (B·H_kv, n_splits, rows, D)
    float* part_ml;        // (B·H_kv, n_splits, rows, 2): running max, sum
    const int* cache_len;  // one int32 on the device
    long long q_sb, q_sh, q_sl;  // element strides of batch, head, row
    long long k_sb, k_sh, k_sl;
    long long v_sb, v_sh, v_sl;
    int H, H_kv, group, l_q, L_max, rows, n_splits;
    int window, sinks;     // window < 0: no window
    float scale;
};

// The tiles of BN keys that the band needs at valid length n, in loop
// order: the sink tiles [0, sink_end), then [band_begin, last tile], never
// a tile twice; split `split` of n_splits takes the equal share
// [begin, end) of them.
template <int BN>
struct DecodeTiles {
    int sink_end = 0, band_begin = 0, begin = 0, end = 0;

    __device__ DecodeTiles(int n, int l_q, int window, int sinks, int split, int n_splits) {
        const int last_tile = (n - 1) / BN;
        if (window >= 0) {
            band_begin = max(0, n - l_q - window) / BN;
            sink_end = min((sinks + BN - 1) / BN, last_tile + 1);
            band_begin = max(band_begin, sink_end);
        }
        const int n_needed = sink_end + max(0, last_tile + 1 - band_begin);
        begin = static_cast<int>(static_cast<long long>(split) * n_needed / n_splits);
        end = static_cast<int>(static_cast<long long>(split + 1) * n_needed / n_splits);
    }

    __device__ int key0(int it) const { return (it < sink_end ? it : band_begin + it - sink_end) * BN; }
};

// Four consecutive outputs of a row, in the output's dtype.
__device__ __forceinline__ void store_out4(bf16* dst, float4 x) {
    __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w)};
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(pair);
}
__device__ __forceinline__ void store_out4(float* dst, float4 x) { *reinterpret_cast<float4*>(dst) = x; }

// The output of a block's (b·kv head, row chunk) from the n_splits
// partials, in the output's dtype. A thread takes four columns of a row
// (16-byte reads) and the splits in batches of MERGE_BATCH: a batch's reads
// are all issued before any is used, then its splits are rescaled to the
// running max and added in split order; then it divides.
constexpr int MERGE_BATCH = 8;

template <typename T, int D>
__global__ void __launch_bounds__(MERGE_THREADS) flash_decode_merge(const __grid_constant__ Params p) {
    constexpr int QUADS = D / 4;
    const int bhk = blockIdx.x, r0 = blockIdx.y * CHUNK_ROWS, r1 = min(r0 + CHUNK_ROWS, p.rows);
    const int b = bhk / p.H_kv, hk = bhk % p.H_kv;
    for (int idx = threadIdx.x; idx < (r1 - r0) * QUADS; idx += MERGE_THREADS) {
        const int r = r0 + idx / QUADS, d = idx % QUADS * 4;
        const size_t row0 = static_cast<size_t>(bhk) * p.n_splits * p.rows + r;  // split 0
        float m = NEG_INF, l = 0.f;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s0 = 0; s0 < p.n_splits; s0 += MERGE_BATCH) {
            float2 ml[MERGE_BATCH];
            float4 a[MERGE_BATCH];
#pragma unroll
            for (int j = 0; j < MERGE_BATCH; ++j) {
                const size_t row = row0 + static_cast<size_t>(s0 + j) * p.rows;
                const bool in = s0 + j < p.n_splits;
                ml[j] = in ? reinterpret_cast<const float2*>(p.part_ml)[row] : make_float2(NEG_INF, 0.f);
                a[j] = in ? *reinterpret_cast<const float4*>(p.part_acc + row * D + d) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            float m_new = m;
#pragma unroll
            for (int j = 0; j < MERGE_BATCH; ++j) m_new = fmaxf(m_new, ml[j].x);
            const float keep = expf(m - m_new);
            l *= keep;
            acc = make_float4(acc.x * keep, acc.y * keep, acc.z * keep, acc.w * keep);
#pragma unroll
            for (int j = 0; j < MERGE_BATCH; ++j) {
                // A split that saw no key of this row adds nothing.
                const float w = ml[j].x <= NEG_INF / 2 ? 0.f : expf(ml[j].x - m_new);
                l += w * ml[j].y;
                acc = make_float4(acc.x + w * a[j].x, acc.y + w * a[j].y, acc.z + w * a[j].z, acc.w + w * a[j].w);
            }
            m = m_new;
        }
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int h = hk * p.group + r / p.l_q, i = r % p.l_q;
        store_out4(static_cast<T*>(p.o) + ((static_cast<size_t>(b) * p.H + h) * p.l_q + i) * D + d,
                   make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    }
}

// The merge, launched after the split kernel (whose launch error it
// returns first) on the same stream: one block per (b·kv head, row chunk).
template <typename T, int D>
cudaError_t launch_merge(const Params& p, dim3 grid, cudaStream_t stream) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_decode_merge<T, D><<<dim3(grid.y, grid.z), MERGE_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

namespace tc {

constexpr int BN = 64;               // keys per tile: the M of Sᵀ = K·Qᵀ
constexpr int THREADS = 128 + 32;    // the consumer warpgroup, then the producer warp
// One block an SM: the most dynamic shared memory a block may take (227 KB).
constexpr int SMEM_BUDGET = 232448;

// Shared-memory layout (byte offsets from a 1024-aligned base). A K or V
// tile of BN keys x D is D / BOXW boxes of BN rows x BOXW elements, one
// swizzle row (RB bytes) per key, as TMA writes it; the query rows are
// stored the same way, N rows a box; Pᵀ is N rows of BN keys (128 bytes,
// 128-byte swizzle). The V stages come first: at D=32 the upper half of
// the m64 product Vᵀ·Pᵀ reads the 4 KB past a V tile, which is still ours.
template <int D, int N>
struct Tiles {
    static constexpr int BOXW = D < 64 ? D : 64;
    static constexpr int RB = 2 * BOXW;
    static constexpr int BOXES = D / BOXW;
    static constexpr uint32_t kv_bytes = BN * D * 2;
    static constexpr uint32_t p_bytes = N * BN * 2, q_bytes = N * D * 2, red_bytes = 4 * 4 * N;
    static constexpr int fixed = p_bytes + q_bytes + red_bytes + 1024;  // + base realignment
    static constexpr int fit = (SMEM_BUDGET - fixed - 8 * 3 * 4) / (2 * kv_bytes);
    static constexpr int STAGES = fit < 8 ? fit : 8;
    static_assert(STAGES >= 2, "a ring of two stages at least");
    static constexpr uint32_t v = 0;
    static constexpr uint32_t k = v + STAGES * kv_bytes;
    static constexpr uint32_t p = k + STAGES * kv_bytes;
    static constexpr uint32_t q = p + p_bytes;
    static constexpr uint32_t red = q + q_bytes;       // 4 floats (one a warp) per column
    static constexpr uint32_t bars = red + red_bytes;  // full_k, full_v, empty: STAGES each
    static constexpr size_t bytes = bars + 8 * 3 * STAGES + 1024;
    static_assert(bytes <= SMEM_BUDGET, "one block an SM");
};

template <int D, int N>
__global__ void __launch_bounds__(THREADS, 1) flash_decode_tc_kernel(const __grid_constant__ Params p) {
    using T = Tiles<D, N>;
    constexpr int RB = T::RB, BOXW = T::BOXW, STAGES = T::STAGES;
    constexpr int MT = (D + 63) / 64;  // m64 products of Oᵀ's D rows
    constexpr int NC = N / 4;          // Sᵀ columns (query rows) a thread holds
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = hopper::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* const base_ptr = smem_raw + (base - raw);
    const uint32_t sV = base + T::v, sK = base + T::k, sP = base + T::p, sQ = base + T::q;
    float* const red = reinterpret_cast<float*>(base_ptr + T::red);
    auto full_k = [&](int s) { return base + T::bars + 8 * s; };
    auto full_v = [&](int s) { return base + T::bars + 8 * (STAGES + s); };
    auto empty = [&](int s) { return base + T::bars + 8 * (2 * STAGES + s); };

    const int split = blockIdx.x, bhk = blockIdx.y, chunk = blockIdx.z;
    const int b = bhk / p.H_kv, hk = bhk % p.H_kv;
    const int r0 = chunk * CHUNK_ROWS, n_rows = min(CHUNK_ROWS, p.rows - r0);
    // The valid length, clamped as the reference clips it.
    const int n = min(max(*p.cache_len, p.l_q), p.L_max);
    const DecodeTiles<BN> tiles(n, p.l_q, p.window, p.sinks, split, p.n_splits);
    const int n_it = tiles.end - tiles.begin;

    if (threadIdx.x == 128) {
        hopper::prefetch_tensor_map(&p.k_map);
        hopper::prefetch_tensor_map(&p.v_map);
    }
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(full_k(s), 1);  // the producer's arrive.expect_tx
            hopper::mbar_init(full_v(s), 1);
            hopper::mbar_init(empty(s), 4);   // one arrive per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // The producer warp; its thread 0 streams the split's tiles.
        if (threadIdx.x == 128) {
            for (int i = 0; i < n_it; ++i) {
                const int s = i % STAGES, k0 = tiles.key0(tiles.begin + i);
                hopper::mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // the first round passes
                // K and V on barriers of their own: Sᵀ = K·Qᵀ starts while V lands.
                hopper::mbar_arrive_expect_tx(full_k(s), T::kv_bytes);
                for (int x = 0; x < T::BOXES; ++x)
                    hopper::tma_load_4d(sK + s * T::kv_bytes + x * BN * RB, &p.k_map, full_k(s), x * BOXW, k0, hk, b);
                hopper::mbar_arrive_expect_tx(full_v(s), T::kv_bytes);
                for (int x = 0; x < T::BOXES; ++x)
                    hopper::tma_load_4d(sV + s * T::kv_bytes + x * BN * RB, &p.v_map, full_v(s), x * BOXW, k0, hk, b);
            }
        }
        return;
    }

    // The consumer warpgroup.
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    auto sync = [] { hopper::named_barrier_sync(1, 128); };

    // The chunk's query rows, K-major and swizzled as the descriptors read
    // them; padding rows are zero. Row r is q head hk·group + R / l_q, query
    // R % l_q, with R = r0 + r.
    {
        constexpr int PER_ROW = D / 8;  // 16-byte chunks
        for (int c = t; c < N * PER_ROW; c += 128) {
            const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
            alignas(16) bf16 e[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(0.f);
            if (r < n_rows) {
                const int R = r0 + r, h = hk * p.group + R / p.l_q, i = R % p.l_q;
                const bf16* src = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + i * p.q_sl + col;
#pragma unroll
                for (int j = 0; j < 8; ++j) e[j] = src[j];
            }
            const uint32_t off = (col / BOXW) * N * RB + hopper::swizzle<RB>(r * RB + (col % BOXW) * 2);
            *reinterpret_cast<uint4*>(base_ptr + T::q + off) = *reinterpret_cast<const uint4*>(e);
        }
        hopper::fence_proxy_async();
        sync();
    }

    // Sᵀ and Oᵀ in wgmma's accumulator layout: element j of a product is
    // row 16·warp + lane/4 + 8·((j >> 1) & 1) (a key of the tile, or a
    // dim of Oᵀ in its m64 product), column 8·(j >> 2) + 2·(lane % 4) +
    // (j & 1) (a query row of the chunk). Column state is indexed by
    // c = 2·(j >> 2) + (j & 1); every thread of a lane % 4 class holds the
    // same columns, and the same m for each.
    const int key_lo = 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8
    auto column = [&](int c) { return 8 * (c >> 1) + 2 * (lane % 4) + (c & 1); };
    float o[MT][N / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < N / 2; ++j) o[mt][j] = 0.f;
    float m[NC], l[NC];  // l: this thread's share of the column sum
#pragma unroll
    for (int c = 0; c < NC; ++c) { m[c] = NEG_INF; l[c] = 0.f; }

    for (int i = 0; i < n_it; ++i) {
        const int s = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        const int k0 = tiles.key0(tiles.begin + i);
        hopper::mbar_wait(full_k(s), phase);

        // Sᵀ = K·Qᵀ: 64 keys x N rows.
        float sc[N / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int x = kk * 16 / BOXW, inner = kk * 16 % BOXW;
            const uint64_t da = hopper::make_desc(sK + s * T::kv_bytes + x * BN * RB + inner * 2, 16, 8 * RB, RB);
            const uint64_t db = hopper::make_desc(sQ + x * N * RB + inner * 2, 16, 8 * RB, RB);
            hopper::wgmma_ss<N>(sc, da, db, kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(sc);

        // Scale, and mask unless every key of the tile is kept for every
        // row; a masked score is -inf (also one that read NaN past n).
#pragma unroll
        for (int j = 0; j < N / 2; ++j) sc[j] *= p.scale;
        const bool whole = k0 + BN - 1 <= n - p.l_q &&
                           (p.window < 0 || k0 >= n - 1 - p.window || k0 + BN <= p.sinks);
        if (!whole) {
#pragma unroll
            for (int j = 0; j < N / 2; ++j) {
                const int key = k0 + key_lo + 8 * ((j >> 1) & 1);
                const int pos = n - p.l_q + (r0 + column(2 * (j >> 2) + (j & 1))) % p.l_q;
                bool keep = key <= pos;  // also drops every slot >= n
                if (p.window >= 0) keep = keep && (key >= pos - p.window || key < p.sinks);
                if (!keep) sc[j] = -INFINITY;
            }
        }

        // Column max: the thread's two keys, its warp's 16 (lanes of one
        // lane % 4 class), then the four warps through shared memory.
        float cm[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int j = 4 * (c >> 1) + (c & 1);
            cm[c] = fmaxf(sc[j], sc[j + 2]);
#pragma unroll
            for (int mask = 4; mask < 32; mask <<= 1)
                cm[c] = fmaxf(cm[c], __shfl_xor_sync(0xffffffffu, cm[c], mask));
        }
        if (lane < 4) {
#pragma unroll
            for (int c = 0; c < NC; ++c) red[column(c) * 4 + warp] = cm[c];
        }
        sync();

        // Online softmax per column, natural exp. A column that has seen no
        // key keeps m == NEG_INF (finite) and all its scores are -inf, so
        // its p are 0 and its O and l stay 0 whatever alpha is.
        unsigned char* const sp = base_ptr + T::p;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const float4 w4 = *reinterpret_cast<const float4*>(red + column(c) * 4);
            const float mt = fmaxf(fmaxf(w4.x, w4.y), fmaxf(w4.z, w4.w));
            const float m_new = fmaxf(m[c], mt == -INFINITY ? NEG_INF : mt);
            const float alpha = expf(m[c] - m_new);
            m[c] = m_new;
            const int j = 4 * (c >> 1) + (c & 1);
            const float p0 = expf(sc[j] - m_new), p1 = expf(sc[j + 2] - m_new);
            l[c] = alpha * l[c] + p0 + p1;
            const int col = column(c);
            *reinterpret_cast<bf16*>(sp + hopper::swizzle<128>(col * 128 + key_lo * 2)) = __float2bfloat16(p0);
            *reinterpret_cast<bf16*>(sp + hopper::swizzle<128>(col * 128 + (key_lo + 8) * 2)) = __float2bfloat16(p1);
#pragma unroll
            for (int mt2 = 0; mt2 < MT; ++mt2) {
                o[mt2][j] *= alpha;
                o[mt2][j + 2] *= alpha;
            }
        }

        // The tile that holds slot n - 1 also holds slots >= n, as the cache
        // has them: zero those V rows (whole swizzle rows, so the swizzle
        // does not matter), since their p = 0 times NaN would be NaN.
        if (k0 + BN > n) {
            hopper::mbar_wait(full_v(s), phase);
            const int first = n - k0;
            for (int x = 0; x < T::BOXES; ++x) {
                uint4* dst = reinterpret_cast<uint4*>(base_ptr + T::v + s * T::kv_bytes + x * BN * RB + first * RB);
                for (int c = t; c < (BN - first) * RB / 16; c += 128) dst[c] = make_uint4(0u, 0u, 0u, 0u);
            }
        }
        hopper::fence_proxy_async();  // Pᵀ (and the zeroed V rows) before the product reads them
        sync();

        // Oᵀ += Vᵀ·Pᵀ: D x N, Vᵀ MN-major through the transpose bit.
        hopper::mbar_wait(full_v(s), phase);
        hopper::wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                const uint64_t da = hopper::make_desc(sV + s * T::kv_bytes + mt * BN * RB + kk * 16 * RB,
                                                      BN * RB, 8 * RB, RB);
                const uint64_t db = hopper::make_desc(sP + kk * 32, 16, 8 * 128, 128);
                hopper::wgmma_ss_ta<N>(o[mt], da, db, 1);
            }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) hopper::fence_operands(o[mt]);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty(s));  // K and V of stage s are free
    }

    // Column sums: the lanes of a class, then the four warps (the loop's
    // last reads of `red` came before its last barrier).
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int mask = 4; mask < 32; mask <<= 1) l[c] += __shfl_xor_sync(0xffffffffu, l[c], mask);
    }
    if (lane < 4) {
#pragma unroll
        for (int c = 0; c < NC; ++c) red[column(c) * 4 + warp] = l[c];
    }
    sync();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const float4 w4 = *reinterpret_cast<const float4*>(red + column(c) * 4);
        l[c] = (w4.x + w4.y) + (w4.z + w4.w);
    }

    // This split's unnormalised partial.
    const size_t part_row0 = (static_cast<size_t>(bhk) * p.n_splits + split) * p.rows + r0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < N / 2; ++j) {
            const int d = 64 * mt + key_lo + 8 * ((j >> 1) & 1);
            const int col = column(2 * (j >> 2) + (j & 1));
            if (d < D && col < n_rows) p.part_acc[(part_row0 + col) * D + d] = o[mt][j];
        }
    }
    if (warp == 0 && lane < 4) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int col = column(c);
            if (col < n_rows) {
                p.part_ml[(part_row0 + col) * 2] = m[c];
                p.part_ml[(part_row0 + col) * 2 + 1] = l[c];
            }
        }
    }
}

template <int D, int N>
cudaError_t set_smem_limit() {
    cudaError_t err = cudaFuncSetAttribute(flash_decode_tc_kernel<D, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Tiles<D, N>::bytes));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_decode_tc_kernel<D, N>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    return err;
}

template <int D>
cudaError_t set_smem_limits() {
    cudaError_t err = set_smem_limit<D, 8>();
    if (err == cudaSuccess) err = set_smem_limit<D, 16>();
    if (err == cudaSuccess) err = set_smem_limit<D, 32>();
    if (err == cudaSuccess) err = set_smem_limit<D, 64>();
    return err;
}

// The instance whose N holds the first (largest) chunk's rows.
template <int D>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
    const int rows = p.rows < CHUNK_ROWS ? p.rows : CHUNK_ROWS;
    if (rows <= 8)
        flash_decode_tc_kernel<D, 8><<<grid, THREADS, Tiles<D, 8>::bytes, stream>>>(p);
    else if (rows <= 16)
        flash_decode_tc_kernel<D, 16><<<grid, THREADS, Tiles<D, 16>::bytes, stream>>>(p);
    else if (rows <= 32)
        flash_decode_tc_kernel<D, 32><<<grid, THREADS, Tiles<D, 32>::bytes, stream>>>(p);
    else
        flash_decode_tc_kernel<D, 64><<<grid, THREADS, Tiles<D, 64>::bytes, stream>>>(p);
    return launch_merge<bf16, D>(p, grid, stream);
}

}  // namespace tc

// ------------------------------------------------------------------- f32

namespace f32 {

constexpr int THREADS = MERGE_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 32;              // keys per tile
constexpr int VEC = 4;              // floats per 16-byte copy

template <int D>
struct Layout {
    static constexpr int LDK = D + VEC;                   // padded K/V row
    static constexpr size_t kv_tile = sizeof(float) * BN * LDK;
    static constexpr size_t q_off = 4 * kv_tile;          // K and V, two stages each
    // Then, for `rows` query rows: q (rows x D), scores and probabilities
    // (rows x BN), running max, running sum, rescale factor.
    static constexpr size_t bytes(int rows) { return q_off + sizeof(float) * rows * (D + BN + 3); }
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

// 16-byte global -> shared copy; with valid false it writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Layout: thread t takes key t % BN of a tile for scores and rows t / BN,
// t / BN + 128 / BN, ...; warp w takes rows w, w + 4, ... for the softmax;
// thread t owns column t % D of rows t / D, t / D + 128 / D, ... of the
// output. MAXR bounds the chunk's rows (1, 8 or 64).
template <int D, int MAXR>
__global__ void __launch_bounds__(THREADS) flash_decode_f32_kernel(const __grid_constant__ Params prm) {
    using L = Layout<D>;
    constexpr int LDK = L::LDK;
    constexpr int NRG = THREADS / BN;             // row groups of the score phase
    constexpr int US = (MAXR + NRG - 1) / NRG;    // score rows per thread
    constexpr int NRG2 = THREADS / D;             // row groups of the output
    constexpr int UP = (MAXR + NRG2 - 1) / NRG2;  // output rows per thread
    constexpr int PER_LANE = BN / 32;             // softmax keys per lane

    extern __shared__ __align__(128) unsigned char smem[];
    float* sK = reinterpret_cast<float*>(smem);
    float* sV = reinterpret_cast<float*>(smem + 2 * L::kv_tile);
    const int split = blockIdx.x, bhk = blockIdx.y, chunk = blockIdx.z;
    const int r0 = chunk * CHUNK_ROWS, rows = min(CHUNK_ROWS, prm.rows - r0);
    float* sQ = reinterpret_cast<float*>(smem + L::q_off);
    float* sS = sQ + rows * D;
    float* sM = sS + rows * BN;
    float* sL = sM + rows;
    float* sAlpha = sL + rows;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int b = bhk / prm.H_kv, hk = bhk % prm.H_kv;
    const float* gk = static_cast<const float*>(prm.k) + b * prm.k_sb + hk * prm.k_sh;
    const float* gv = static_cast<const float*>(prm.v) + b * prm.v_sb + hk * prm.v_sh;

    // The valid length, clamped as the reference clips it.
    const int n = min(max(*prm.cache_len, prm.l_q), prm.L_max);

    // Row r is q head hk·group + R / l_q, query R % l_q, with R = r0 + r.
    for (int idx = tid; idx < rows * D; idx += THREADS) {
        const int R = r0 + idx / D, d = idx % D;
        const int h = hk * prm.group + R / prm.l_q, i = R % prm.l_q;
        sQ[idx] = static_cast<const float*>(prm.q)[b * prm.q_sb + h * prm.q_sh + i * prm.q_sl + d];
    }
    for (int r = tid; r < rows; r += THREADS) { sM[r] = NEG_INF; sL[r] = 0.f; }

    const DecodeTiles<BN> tiles(n, prm.l_q, prm.window, prm.sinks, split, prm.n_splits);

    auto load_tile = [&](int it, int stage) {
        const int k0 = tiles.key0(it);
        float* dk = sK + stage * BN * LDK;
        float* dv = sV + stage * BN * LDK;
        constexpr int PER_ROW = D / VEC;
        for (int c = tid; c < BN * PER_ROW; c += THREADS) {
            const int row = c / PER_ROW, col = (c % PER_ROW) * VEC;
            const int key = k0 + row;
            const bool valid = key < n;
            const long long kr = valid ? key : 0;
            cp_async16(dk + row * LDK + col, gk + kr * prm.k_sl + col, valid);
            cp_async16(dv + row * LDK + col, gv + kr * prm.v_sl + col, valid);
        }
        cp_async_commit();
    };

    float acc_o[UP];
#pragma unroll
    for (int u = 0; u < UP; ++u) acc_o[u] = 0.f;
    const int kj = tid % BN, rg = tid / BN;       // score phase: key, row group
    const int dcol = tid % D, rg2 = tid / D;      // output: column, row group

    __syncthreads();  // sQ, sM, sL ready even when this split has no tile
    const int n_it = tiles.end - tiles.begin;
    if (n_it > 0) load_tile(tiles.begin, 0);
    for (int i = 0; i < n_it; ++i) {
        const int stage = i & 1;
        if (i + 1 < n_it) {
            load_tile(tiles.begin + i + 1, stage ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // this tile has landed for every thread
        const int k0 = tiles.key0(tiles.begin + i);
        const float* tK = sK + stage * BN * LDK;
        const float* tV = sV + stage * BN * LDK;

        // Scores S = q·kᵀ·scale, masked, for key kj and the thread's rows.
        {
            float acc_s[US];
#pragma unroll
            for (int u = 0; u < US; ++u) acc_s[u] = 0.f;
            const float* krow = tK + kj * LDK;
#pragma unroll 4
            for (int d0 = 0; d0 < D; d0 += VEC) {
                const float4 kv = *reinterpret_cast<const float4*>(krow + d0);
#pragma unroll
                for (int u = 0; u < US; ++u) {
                    const int r = rg + u * NRG;
                    if (r < rows) {
                        const float4 qv = *reinterpret_cast<const float4*>(sQ + r * D + d0);
                        acc_s[u] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
                    }
                }
            }
            const int key = k0 + kj;
#pragma unroll
            for (int u = 0; u < US; ++u) {
                const int r = rg + u * NRG;
                if (r < rows) {
                    const int pos = n - prm.l_q + (r0 + r) % prm.l_q;  // the query on the key timeline
                    bool keep = key <= pos;                            // also drops every slot >= n
                    if (prm.window >= 0) keep = keep && (key >= pos - prm.window || key < prm.sinks);
                    sS[r * BN + kj] = keep ? acc_s[u] * prm.scale : NEG_INF;
                }
            }
        }
        __syncthreads();

        // Online softmax, natural exp, one row per warp at a time; the
        // probabilities replace the scores in place.
        for (int r = warp; r < rows; r += WARPS) {
            const float m_prev = sM[r];
            float s[PER_LANE], mx = NEG_INF;
#pragma unroll
            for (int e = 0; e < PER_LANE; ++e) {
                s[e] = sS[r * BN + lane + 32 * e];
                mx = fmaxf(mx, s[e]);
            }
            const float m_new = fmaxf(m_prev, warp_max(mx));
            // A row with no key so far keeps m == NEG_INF: its p and alpha
            // are 0, not exp(0).
            const bool empty = m_new <= NEG_INF / 2;
            float sum = 0.f;
#pragma unroll
            for (int e = 0; e < PER_LANE; ++e) {
                const float pr = empty ? 0.f : expf(s[e] - m_new);
                sum += pr;
                sS[r * BN + lane + 32 * e] = pr;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = m_prev <= NEG_INF / 2 ? 0.f : expf(m_prev - m_new);
                sL[r] = alpha * sL[r] + sum;
                sM[r] = m_new;
                sAlpha[r] = alpha;
            }
        }
        __syncthreads();

        // acc = acc·alpha + P·V for column dcol of the thread's rows.
#pragma unroll
        for (int u = 0; u < UP; ++u) {
            const int r = rg2 + u * NRG2;
            if (r < rows) acc_o[u] *= sAlpha[r];
        }
#pragma unroll 4
        for (int j = 0; j < BN; ++j) {
            const float vv = tV[j * LDK + dcol];
#pragma unroll
            for (int u = 0; u < UP; ++u) {
                const int r = rg2 + u * NRG2;
                if (r < rows) acc_o[u] += sS[r * BN + j] * vv;
            }
        }
        __syncthreads();  // every thread is done with this stage and with sS
    }

    // This split's unnormalised partial.
    const size_t base = (static_cast<size_t>(bhk) * prm.n_splits + split) * prm.rows + r0;
#pragma unroll
    for (int u = 0; u < UP; ++u) {
        const int r = rg2 + u * NRG2;
        if (r < rows) prm.part_acc[(base + r) * D + dcol] = acc_o[u];
    }
    for (int r = tid; r < rows; r += THREADS) {
        prm.part_ml[(base + r) * 2] = sM[r];
        prm.part_ml[(base + r) * 2 + 1] = sL[r];
    }
}

template <int D, int MAXR>
cudaError_t set_smem_limit() {
    return cudaFuncSetAttribute(flash_decode_f32_kernel<D, MAXR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Layout<D>::bytes(MAXR)));
}

template <int D>
cudaError_t set_smem_limits() {
    cudaError_t err = set_smem_limit<D, 1>();
    if (err == cudaSuccess) err = set_smem_limit<D, 8>();
    if (err == cudaSuccess) err = set_smem_limit<D, CHUNK_ROWS>();
    return err;
}

template <int D>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
    const int rows = p.rows < CHUNK_ROWS ? p.rows : CHUNK_ROWS;
    const size_t bytes = Layout<D>::bytes(rows);
    if (rows <= 1)
        flash_decode_f32_kernel<D, 1><<<grid, THREADS, bytes, stream>>>(p);
    else if (rows <= 8)
        flash_decode_f32_kernel<D, 8><<<grid, THREADS, bytes, stream>>>(p);
    else
        flash_decode_f32_kernel<D, CHUNK_ROWS><<<grid, THREADS, bytes, stream>>>(p);
    return launch_merge<float, D>(p, grid, stream);
}

}  // namespace f32

// The bf16 path's tensor maps over the caller's strides: (D, L_max, H_kv,
// B), a box of 64 keys x 64 elements (32 at D=32).
cudaError_t encode_maps(Params& p, int B, int H_kv, int L_max, int D) {
    const uint32_t boxw = D < 64 ? D : 64;
    const CUtensorMapSwizzle swz = D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    const uint64_t dims[4] = {uint64_t(D), uint64_t(L_max), uint64_t(H_kv), uint64_t(B)};
    const uint32_t box[4] = {boxw, uint32_t(tc::BN), 1, 1};
    // Strides come in elements as (batch, head, row); maps take bytes as
    // (row, head, batch).
    const uint64_t k_st[3] = {2ull * p.k_sl, 2ull * p.k_sh, 2ull * p.k_sb};
    const uint64_t v_st[3] = {2ull * p.v_sl, 2ull * p.v_sh, 2ull * p.v_sb};
    cudaError_t err = hopper::encode_bf16_4d(&p.k_map, p.k, dims, k_st, box, swz);
    if (err == cudaSuccess) err = hopper::encode_bf16_4d(&p.v_map, p.v, dims, v_st, box, swz);
    return err;
}

}  // namespace

// Raise the dynamic shared-memory limit of every kernel instance on the
// current device. Call once per device before the first launch.
extern "C" int flash_decode_init() {
    cudaError_t err = tc::set_smem_limits<32>();
    if (err == cudaSuccess) err = tc::set_smem_limits<64>();
    if (err == cudaSuccess) err = tc::set_smem_limits<128>();
    if (err == cudaSuccess) err = f32::set_smem_limits<32>();
    if (err == cudaSuccess) err = f32::set_smem_limits<64>();
    if (err == cudaSuccess) err = f32::set_smem_limits<128>();
    return err;
}

// dtype: 0 = bf16, 1 = f32. window < 0 means no window. cache_len points to
// one int32 on the device. Strides are in elements; the head dim must be
// contiguous, and the caches' base and strides 16-byte aligned (the tensor
// maps' rule for bf16, the 16-byte copies' for f32). part_acc and part_ml
// are f32 scratch of B·H_kv·n_splits·(H / H_kv)·l_q rows (D and 2 floats a
// row). The split kernel's grid is (n_splits, B·H_kv, n_chunks), n_chunks
// = ceil(group·l_q / 64); the merge's is (B·H_kv, n_chunks).
extern "C" int flash_decode(const void* q, const void* k, const void* v, void* o,
                            void* part_acc, void* part_ml, const void* cache_len,
                            int dtype, int B, int H, int H_kv, int l_q, int L_max, int D,
                            long long q_sb, long long q_sh, long long q_sl,
                            long long k_sb, long long k_sh, long long k_sl,
                            long long v_sb, long long v_sh, long long v_sl,
                            int window, int sinks, float scale, int n_splits, int n_chunks, void* stream) {
    if (H_kv < 1 || H % H_kv || l_q < 1 || L_max < l_q || n_splits < 1) return cudaErrorInvalidValue;
    Params prm;
    prm.q = q; prm.k = k; prm.v = v; prm.o = o;
    prm.part_acc = static_cast<float*>(part_acc);
    prm.part_ml = static_cast<float*>(part_ml);
    prm.cache_len = static_cast<const int*>(cache_len);
    prm.q_sb = q_sb; prm.q_sh = q_sh; prm.q_sl = q_sl;
    prm.k_sb = k_sb; prm.k_sh = k_sh; prm.k_sl = k_sl;
    prm.v_sb = v_sb; prm.v_sh = v_sh; prm.v_sl = v_sl;
    prm.H = H; prm.H_kv = H_kv; prm.group = H / H_kv; prm.l_q = l_q; prm.L_max = L_max;
    prm.rows = prm.group * l_q; prm.n_splits = n_splits;
    prm.window = window; prm.sinks = sinks; prm.scale = scale;
    if (n_chunks != (prm.rows + CHUNK_ROWS - 1) / CHUNK_ROWS || B * H_kv > 65535 || n_chunks > 65535)
        return cudaErrorInvalidValue;
    const dim3 grid(n_splits, B * H_kv, n_chunks);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        const cudaError_t err = encode_maps(prm, B, H_kv, L_max, D);
        if (err != cudaSuccess) return err;
        switch (D) {
            case 32: return tc::launch<32>(prm, grid, s);
            case 64: return tc::launch<64>(prm, grid, s);
            case 128: return tc::launch<128>(prm, grid, s);
            default: return cudaErrorInvalidValue;
        }
    }
    if (dtype != 1) return cudaErrorInvalidValue;
    switch (D) {
        case 32: return f32::launch<32>(prm, grid, s);
        case 64: return f32::launch<64>(prm, grid, s);
        case 128: return f32::launch<128>(prm, grid, s);
        default: return cudaErrorInvalidValue;
    }
}
