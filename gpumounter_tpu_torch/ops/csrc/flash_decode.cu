// Flash-decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel gpumounter_tpu/ops/flash_decode.py::_decode_kernel
// (launched by flash_decode). Same function: the newest l_q tokens of each
// sequence, q (B, H, l_q, D), attend a fixed-shape KV cache (B, H_kv, L_max,
// D) whose valid length n is an int32 that lives on the device. n is
// clamped to [l_q, L_max]; query row i sits at position n - l_q + i and
// attends the keys k <= its position, within the window [pos - window, pos]
// joined with the sinks [0, sinks) when a window is set. Slots >= n never
// contribute. q head h reads kv head h / group. Scores are f32, softmax is
// the natural-exp online softmax of the TPU kernel, and P is rounded to the
// cache's dtype before P·V, with f32 accumulators.
//
// The dynamic length. The block reads n from device memory and turns the
// TPU kernel's clamped kv_index into loop bounds: the sink tiles first, then
// [max(first band tile, sink tiles), last valid tile], never a tile twice.
// The grid depends only on the shapes and L_max, never on n, so one launch
// configuration (and one captured CUDA graph) serves every length; the
// wrapper never reads n on the host.
//
// Bound on the H100 at the serving shape (B=4, H=H_kv=8, l_q=1, D=128,
// bf16, n=2048): the valid K+V region is 2·4·8·2048·128·2 B = 33.6 MB,
// ≈ 10.0 µs at 3.35 TB/s; the 4·B·H·l_q·n·D ≈ 33.6 MFLOP are nothing beside
// it. So it is bound by bytes, and the design is about keeping enough K/V
// bytes in flight:
//
// - Keys are split across blocks. B·H_kv = 32 (b, kv head) pairs would fill
//   a quarter of the 132 SMs, so the grid is (n_splits, B·H_kv), n_splits
//   chosen by the wrapper from the shapes (about two blocks per SM). Each
//   split takes an equal share of the tiles the band needs at this n and
//   writes an unnormalised partial (m, l, acc) in f32; a second kernel,
//   flash_decode_merge, launched by the same C entry, rescales and sums the
//   partials of each row and writes the output in q's dtype.
// - One block serves all group·l_q query rows of its kv head (at most 64),
//   so a K/V tile is read from device memory once per group, not once per q
//   head as the TPU grid does (bh // group).
// - K/V tiles stream through a two-stage cp.async ring in shared memory
//   (16-byte copies, zero-filled past n, so garbage past n never enters,
//   not even NaN), the next tile loading while this one is used.
// - The products run on CUDA cores in f32: at l_q·group <= 64 rows a tile
//   carries too few rows to feed the tensor cores, and the kernel waits on
//   memory, not arithmetic. This is the simple first version: no TMA, no
//   warp specialisation (PERF.md has its time).
//
// Layout: 128 threads. Scores: thread t takes key t % BN of the tile and
// rows t / BN, t / BN + 128 / BN, ... (16-byte K reads, conflict-free with
// the row padding; q rows broadcast from shared memory). Softmax: warp w
// takes rows w, w + 4, ... Output: thread t owns column t % D of rows
// t / D, t / D + 128 / D, ... in registers. A template parameter bounds the
// rows (1, 8 or 64) so the serving shape's single row costs no loop over 64.
//
// Launch contract: the C entry launches on the caller's stream, does not
// synchronise, allocates nothing (the wrapper allocates the output and the
// partials), and returns cudaGetLastError(). flash_decode_init raises the
// dynamic shared-memory limit of every instance once, at load, so a launch
// does no per-launch host work that a graph capture would forbid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;       // group · l_q
constexpr float NEG_INF = -1e30f;  // large-but-finite, as in the TPU kernel

template <typename T, int D>
struct Layout {
    static constexpr int BN = sizeof(T) == 2 ? 64 : 32;  // keys per tile
    static constexpr int VEC = 16 / sizeof(T);           // elements per 16-byte copy
    static constexpr int LDK = D + VEC;                  // padded K/V row
    static constexpr size_t kv_tile = sizeof(T) * BN * LDK;
    static constexpr size_t q_off = 4 * kv_tile;         // K and V, two stages each
    // Then, for `rows` query rows, all f32: q (rows x D), scores and
    // probabilities (rows x BN), running max, running sum, rescale factor.
    static constexpr size_t bytes(int rows) {
        return q_off + sizeof(float) * rows * (D + BN + 3);
    }
};

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;              // (B, H, l_q, D), contiguous
    float* part_acc;      // (B·H_kv, n_splits, rows, D)
    float* part_ml;       // (B·H_kv, n_splits, rows, 2): running max, sum
    const int* cache_len; // one int32 on the device
    long long q_sb, q_sh, q_sl;  // element strides of batch, head, row
    long long k_sb, k_sh, k_sl;
    long long v_sb, v_sh, v_sl;
    int H, H_kv, group, l_q, L_max, rows, n_splits;
    int window, sinks;    // window < 0: no window
    float scale;
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

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// p as the P·V product sees it: rounded to the cache's dtype.
__device__ __forceinline__ float round_to(float x, bf16) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float round_to(float x, float) { return x; }

__device__ __forceinline__ void store_out(bf16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

// 16-byte global -> shared copy; with valid false it writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

template <typename T, int D, int MAXR>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(const Params prm) {
    using L = Layout<T, D>;
    constexpr int BN = L::BN, VEC = L::VEC, LDK = L::LDK;
    constexpr int NRG = THREADS / BN;             // row groups of the score phase
    constexpr int US = (MAXR + NRG - 1) / NRG;    // score rows per thread
    constexpr int NRG2 = THREADS / D;             // row groups of the output
    constexpr int UP = (MAXR + NRG2 - 1) / NRG2;  // output rows per thread
    constexpr int PER_LANE = BN / 32;             // softmax keys per lane

    extern __shared__ __align__(128) unsigned char smem[];
    T* sK = reinterpret_cast<T*>(smem);
    T* sV = reinterpret_cast<T*>(smem + 2 * L::kv_tile);
    const int rows = prm.rows;
    float* sQ = reinterpret_cast<float*>(smem + L::q_off);
    float* sS = sQ + rows * D;
    float* sM = sS + rows * BN;
    float* sL = sM + rows;
    float* sAlpha = sL + rows;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int split = blockIdx.x, bhk = blockIdx.y;
    const int b = bhk / prm.H_kv, hk = bhk % prm.H_kv;
    const T* gk = static_cast<const T*>(prm.k) + b * prm.k_sb + hk * prm.k_sh;
    const T* gv = static_cast<const T*>(prm.v) + b * prm.v_sb + hk * prm.v_sh;

    // The valid length, clamped as the reference clips it.
    const int n = min(max(*prm.cache_len, prm.l_q), prm.L_max);

    // Row r is q head hk·group + r / l_q, query r % l_q.
    for (int idx = tid; idx < rows * D; idx += THREADS) {
        const int r = idx / D, d = idx % D;
        const int h = hk * prm.group + r / prm.l_q, i = r % prm.l_q;
        sQ[idx] = to_f(static_cast<const T*>(prm.q)[b * prm.q_sb + h * prm.q_sh + i * prm.q_sl + d]);
    }
    for (int r = tid; r < rows; r += THREADS) { sM[r] = NEG_INF; sL[r] = 0.f; }

    // The tiles the band needs at this n: [0, sink_end) then
    // [band_begin, last_tile], never a tile twice; this split takes its
    // equal share of them.
    const int last_tile = (n - 1) / BN;
    int sink_end = 0, band_begin = 0;
    if (prm.window >= 0) {
        band_begin = max(0, n - prm.l_q - prm.window) / BN;
        sink_end = min((prm.sinks + BN - 1) / BN, last_tile + 1);
        band_begin = max(band_begin, sink_end);
    }
    const int n_needed = sink_end + max(0, last_tile + 1 - band_begin);
    const int it_begin = static_cast<int>(static_cast<long long>(split) * n_needed / prm.n_splits);
    const int it_end = static_cast<int>(static_cast<long long>(split + 1) * n_needed / prm.n_splits);
    auto tile_start = [&](int it) { return (it < sink_end ? it : band_begin + it - sink_end) * BN; };

    auto load_tile = [&](int it, int stage) {
        const int k0 = tile_start(it);
        T* dk = sK + stage * BN * LDK;
        T* dv = sV + stage * BN * LDK;
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
    const int n_it = it_end - it_begin;
    if (n_it > 0) load_tile(it_begin, 0);
    for (int i = 0; i < n_it; ++i) {
        const int stage = i & 1;
        if (i + 1 < n_it) {
            load_tile(it_begin + i + 1, stage ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // this tile has landed for every thread
        const int k0 = tile_start(it_begin + i);
        const T* tK = sK + stage * BN * LDK;
        const T* tV = sV + stage * BN * LDK;

        // Scores S = q·kᵀ·scale, masked, for key kj and the thread's rows.
        {
            float acc_s[US];
#pragma unroll
            for (int u = 0; u < US; ++u) acc_s[u] = 0.f;
            const T* krow = tK + kj * LDK;
#pragma unroll 4
            for (int d0 = 0; d0 < D; d0 += VEC) {
                const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
                const T* kv = reinterpret_cast<const T*>(&raw);
                float kf[VEC];
#pragma unroll
                for (int e = 0; e < VEC; ++e) kf[e] = to_f(kv[e]);
#pragma unroll
                for (int u = 0; u < US; ++u) {
                    const int r = rg + u * NRG;
                    if (r < rows) {
                        const float4* q4 = reinterpret_cast<const float4*>(sQ + r * D + d0);
#pragma unroll
                        for (int e = 0; e < VEC / 4; ++e) {
                            const float4 qv = q4[e];
                            acc_s[u] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1]
                                      + qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
                        }
                    }
                }
            }
            const int key = k0 + kj;
#pragma unroll
            for (int u = 0; u < US; ++u) {
                const int r = rg + u * NRG;
                if (r < rows) {
                    const int pos = n - prm.l_q + r % prm.l_q;  // the query on the key timeline
                    bool keep = key <= pos;                      // also drops every slot >= n
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
                const float p = empty ? 0.f : expf(s[e] - m_new);
                sum += p;
                sS[r * BN + lane + 32 * e] = round_to(p, T());
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
            const float vv = to_f(tV[j * LDK + dcol]);
#pragma unroll
            for (int u = 0; u < UP; ++u) {
                const int r = rg2 + u * NRG2;
                if (r < rows) acc_o[u] += sS[r * BN + j] * vv;
            }
        }
        __syncthreads();  // every thread is done with this stage and with sS
    }

    // This split's unnormalised partial.
    const size_t base = (static_cast<size_t>(bhk) * prm.n_splits + split) * rows;
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

// One block per (row, b·kv head), one thread per column: rescale each
// split's partial to the row's overall max, sum, divide, write in q's dtype.
template <typename T, int D>
__global__ void __launch_bounds__(D) flash_decode_merge(const Params prm) {
    const int r = blockIdx.x, bhk = blockIdx.y, d = threadIdx.x;
    const int b = bhk / prm.H_kv, hk = bhk % prm.H_kv;
    const int h = hk * prm.group + r / prm.l_q, i = r % prm.l_q;
    const size_t row0 = static_cast<size_t>(bhk) * prm.n_splits * prm.rows + r;  // split 0
    float m = NEG_INF;
    for (int s = 0; s < prm.n_splits; ++s) m = fmaxf(m, prm.part_ml[(row0 + s * prm.rows) * 2]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < prm.n_splits; ++s) {
        const size_t row = row0 + s * prm.rows;
        const float ms = prm.part_ml[row * 2];
        const float w = ms <= NEG_INF / 2 ? 0.f : expf(ms - m);
        l += w * prm.part_ml[row * 2 + 1];
        acc += w * prm.part_acc[row * D + d];
    }
    T* out = static_cast<T*>(prm.o) + ((static_cast<size_t>(b) * prm.H + h) * prm.l_q + i) * D + d;
    store_out(out, acc / fmaxf(l, 1e-30f));
}

template <typename T, int D, int MAXR>
cudaError_t set_smem_limit() {
    return cudaFuncSetAttribute(flash_decode_kernel<T, D, MAXR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Layout<T, D>::bytes(MAXR)));
}

template <typename T, int D>
cudaError_t set_smem_limits() {
    cudaError_t err = set_smem_limit<T, D, 1>();
    if (err == cudaSuccess) err = set_smem_limit<T, D, 8>();
    if (err == cudaSuccess) err = set_smem_limit<T, D, MAX_ROWS>();
    return err;
}

template <typename T, int D>
cudaError_t launch(const Params& prm, int n_bhk, cudaStream_t stream) {
    const dim3 grid(prm.n_splits, n_bhk);
    const size_t bytes = Layout<T, D>::bytes(prm.rows);
    if (prm.rows <= 1)
        flash_decode_kernel<T, D, 1><<<grid, THREADS, bytes, stream>>>(prm);
    else if (prm.rows <= 8)
        flash_decode_kernel<T, D, 8><<<grid, THREADS, bytes, stream>>>(prm);
    else
        flash_decode_kernel<T, D, MAX_ROWS><<<grid, THREADS, bytes, stream>>>(prm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_decode_merge<T, D><<<dim3(prm.rows, n_bhk), D, 0, stream>>>(prm);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& prm, int d, int n_bhk, cudaStream_t stream) {
    switch (d) {
        case 32: return launch<T, 32>(prm, n_bhk, stream);
        case 64: return launch<T, 64>(prm, n_bhk, stream);
        case 128: return launch<T, 128>(prm, n_bhk, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Raise the dynamic shared-memory limit of every kernel instance on the
// current device. Call once per device before the first launch.
extern "C" int flash_decode_init() {
    cudaError_t err = set_smem_limits<bf16, 32>();
    if (err == cudaSuccess) err = set_smem_limits<bf16, 64>();
    if (err == cudaSuccess) err = set_smem_limits<bf16, 128>();
    if (err == cudaSuccess) err = set_smem_limits<float, 32>();
    if (err == cudaSuccess) err = set_smem_limits<float, 64>();
    if (err == cudaSuccess) err = set_smem_limits<float, 128>();
    return err;
}

// dtype: 0 = bf16, 1 = f32. window < 0 means no window. cache_len points to
// one int32 on the device. Strides are in elements; the head dim must be
// contiguous and K/V rows must start on 16-byte boundaries. part_acc and
// part_ml are f32 scratch of B·H_kv·n_splits·(H / H_kv)·l_q rows (D and 2
// floats a row).
extern "C" int flash_decode(const void* q, const void* k, const void* v, void* o,
                            void* part_acc, void* part_ml, const void* cache_len,
                            int dtype, int B, int H, int H_kv, int l_q, int L_max, int D,
                            long long q_sb, long long q_sh, long long q_sl,
                            long long k_sb, long long k_sh, long long k_sl,
                            long long v_sb, long long v_sh, long long v_sl,
                            int window, int sinks, float scale, int n_splits, void* stream) {
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
    if (prm.rows > MAX_ROWS) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_dim<bf16>(prm, D, B * H_kv, s);
    if (dtype == 1) return launch_dim<float>(prm, D, B * H_kv, s);
    return cudaErrorInvalidValue;
}
