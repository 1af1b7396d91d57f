"""Decode attention against a fixed-shape KV cache whose valid length lives
on the device: a hand-written Hopper kernel and its plain version.

Counterpart of ``gpumounter_tpu/ops/flash_decode.py``. The serving loop's
cache keeps one shape (B, H_kv, L_max, D) while it fills, and the number of
valid entries is an int32 on the device, so no step reads it on the host:
the reference compiles once for every length, and here one launch
configuration (and one captured CUDA graph) serves every length. The
kernel, ``csrc/flash_decode.cu``, ports the Pallas ``_decode_kernel``;
``flash_decode_plain`` is the same function written out in PyTorch. The
kernel takes any group·l_q: rows beyond 64 go to further row chunks of its
grid, each reading the cache once.

The path follows the tensors' device: a CUDA tensor runs the kernel or
raises ``ValueError`` naming what the kernel does not take, and a CPU
tensor runs ``flash_decode_plain``. The reference's ``block_k`` (tuned for
the TPU's grid overhead) and ``interpret`` are TPU knobs and are not
ported. There is no backward: training attends through
``ops.flash_attention``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from gpumounter_tpu_torch.ops import _build
from gpumounter_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS, NEG_INF

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# Keys per shared-memory tile in flash_decode.cu (tc::BN, f32::BN): the
# unit in which the wrapper splits the cache across blocks.
_KEYS_PER_TILE = {torch.bfloat16: 64, torch.float32: 32}
CHUNK_ROWS = 64  # group·l_q query rows per block (CHUNK_ROWS in the kernel)
GRID_YZ_MAX = 65535  # CUDA's limit on grid y (B·H_kv) and z (row chunks)


def _check_decode_args(q, k_cache, window, sinks):
    """The reference's argument checks (``flash_decode``), same messages."""
    h, l_q = q.shape[1], q.shape[2]
    h_kv, l_max = k_cache.shape[1], k_cache.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({h_kv})")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if sinks and window is None:
        raise ValueError("sinks only make sense with a sliding window")
    if l_q > l_max:
        # cache_len is clipped to [l_q, l_max]; with l_q > l_max the clip
        # inverts and every row would silently see no key.
        raise ValueError(f"l_q ({l_q}) must be <= cache capacity "
                         f"({l_max})")


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, cache_len, *,
                       scale: float | None = None, window: int | None = None,
                       sinks: int = 0) -> torch.Tensor:
    """The kernel's plain version: materialised (l_q, L_max) attention.

    q (B, H, l_q, D); k_cache, v_cache (B, H_kv, L_max, D); cache_len an
    int or a one-element integer tensor, clipped to [l_q, L_max]. Row i
    sits at position (cache_len − l_q) + i and attends the keys at or
    before it, within [pos − window, pos] joined with the sinks [0, sinks)
    when a window is set. Slots ≥ cache_len never contribute, whatever
    they hold. q head h reads kv head h // group. Scores and softmax are
    f32 with natural exp; the output is in q's dtype. The mask is built
    from the length on the device, so nothing here waits for the host.
    """
    _check_decode_args(q, k_cache, window, sinks)
    b, h, l_q, d = q.shape
    h_kv, l_max = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n = torch.as_tensor(cache_len, device=q.device).reshape(()).clamp(l_q, l_max)
    keys = torch.arange(l_max, device=q.device)
    pos = (n - l_q) + torch.arange(l_q, device=q.device)[:, None]
    keep = keys <= pos                                   # (l_q, L_max)
    if window is not None:
        in_band = keys >= pos - window
        if sinks:
            in_band = in_band | (keys < sinks)
        keep = keep & in_band
    group = h // h_kv
    k, v = k_cache.float(), v_cache.float()
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    v = torch.where((keys < n)[:, None], v, torch.zeros((), device=q.device))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v).to(q.dtype)


_ptr, _int, _ll, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _library(device_index: int) -> ctypes.CDLL:
    """The kernel's library, its shared-memory limits raised on the device
    once, at load."""
    lib = _build.load("flash_decode")
    lib.flash_decode_init.restype = _int
    lib.flash_decode_init.argtypes = []
    lib.flash_decode.restype = _int
    lib.flash_decode.argtypes = (
        [_ptr] * 7                 # q, k, v, o, part_acc, part_ml, cache_len
        + [_int] * 7               # dtype, B, H, H_kv, l_q, L_max, D
        + [_ll] * 9                # q, k, v strides: batch, head, row
        + [_int] * 2               # window, sinks
        + [_float]                 # scale
        + [_int] * 2               # n_splits, n_chunks
        + [_ptr])                  # stream
    with torch.cuda.device(device_index):
        err = lib.flash_decode_init()
    if err != 0:
        raise RuntimeError(f"flash_decode_init failed: cudaError_t {err}")
    return lib


def _check_kernel_inputs(q, k_cache, v_cache):
    """Raise ValueError for what flash_decode.cu does not take. q may be a
    strided view with a contiguous head dim. The caches are read by TMA
    tensor maps (bf16) or 16-byte copies (f32): their base and their batch,
    head and row strides must be multiples of 16 bytes, and a bf16 cache
    may not be a broadcast (zero-stride) view."""
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_decode takes bfloat16 or float32, got "
                         f"{q.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"expected q (B, H, l_q, D) and caches of one shape "
                         f"(B, H_kv, L_max, D); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, l_q, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)} in batch and head dim")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode takes head dim {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if l_q == 0 or b == 0:
        raise ValueError(f"flash_decode needs B, l_q >= 1, got q "
                         f"{tuple(q.shape)}")
    if b * k_cache.shape[1] > GRID_YZ_MAX:
        raise ValueError(f"flash_decode launches one grid row per (b, kv "
                         f"head): B*H_kv={b * k_cache.shape[1]} exceeds "
                         f"{GRID_YZ_MAX}")
    group = h // k_cache.shape[1]
    chunks = -(-group * l_q // CHUNK_ROWS)
    if chunks > GRID_YZ_MAX:
        raise ValueError(f"flash_decode launches one grid layer per "
                         f"{CHUNK_ROWS} query rows of a kv head: {group} x "
                         f"{l_q} rows need {chunks}, more than {GRID_YZ_MAX}")
    if q.stride(3) != 1:
        raise ValueError(f"q must be contiguous in the head dim, got strides "
                         f"{q.stride()}")
    size = q.element_size()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in the head dim, got "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary, got "
                             f"offset {t.data_ptr() % 16}")
        for dim, stride in zip(("batch", "head", "row"), t.stride()[:3]):
            if stride * size % 16:
                raise ValueError(f"{name}'s {dim} stride must be a multiple of "
                                 f"16 bytes, got {stride} elements = "
                                 f"{stride * size} bytes (strides {t.stride()})")
        if t.dtype == torch.bfloat16 and any(
                s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)):
            raise ValueError(f"{name} is a broadcast view (strides "
                             f"{t.stride()}, shape {tuple(t.shape)}), which a "
                             f"TMA tensor map cannot read")


def _device_length(cache_len, device) -> torch.Tensor:
    """cache_len as one int32 on `device`: an int is copied there (clipped
    to int32's range), a tensor is only cast, never read on the host."""
    if isinstance(cache_len, torch.Tensor):
        if cache_len.device != device or cache_len.numel() != 1 or (
                cache_len.is_floating_point() or cache_len.is_complex()):
            raise ValueError(f"cache_len must be one integer on {device}, got "
                             f"{cache_len.dtype} {tuple(cache_len.shape)} on "
                             f"{cache_len.device}")
        return cache_len.reshape(1).to(torch.int32)
    n = max(-2**31, min(int(cache_len), 2**31 - 1))
    return torch.full((1,), n, dtype=torch.int32, device=device)


def _launch_plan(sms: int, n_bhk: int, l_max: int, rows: int,
                 keys_per_tile: int) -> tuple[int, int]:
    """(n_chunks, n_splits) of the grid (n_splits, B·H_kv, n_chunks): the
    group·l_q rows of a kv head in chunks of CHUNK_ROWS, and the key tiles
    of each (b, kv head, chunk) split across as many blocks as fill the
    card in one wave of one block an SM, at most one a key tile and at
    least one. A function of the shapes and the card, never of the valid
    length, so one launch serves every length."""
    n_chunks = -(-rows // CHUNK_ROWS)
    tiles = -(-l_max // keys_per_tile)
    slots = sms // (n_bhk * n_chunks)
    return n_chunks, max(1, min(tiles, slots))


def flash_decode_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, cache_len, *,
                        scale: float | None = None, window: int | None = None,
                        sinks: int = 0) -> torch.Tensor:
    """(B, H, l_q, D) decode attention through ``csrc/flash_decode.cu``;
    the wrapper of the port, counterpart of the reference's ``pallas_call``.

    CUDA tensors launch the kernel on the current stream (or raise
    ValueError); CPU tensors run ``flash_decode_plain``. cache_len is a
    Python int or a one-element integer tensor on q's device, passed to the
    kernel by pointer, so a captured graph replays at whatever length the
    tensor holds. Each call launches the split kernel and the merge of its
    partials, and adds one to ``flash_decode_kernel.launches``.
    """
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k_cache.device}, {v_cache.device}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cache_len, scale=scale,
                                  window=window, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_kernel runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check_decode_args(q, k_cache, window, sinks)
    _check_kernel_inputs(q, k_cache, v_cache)
    length = _device_length(cache_len, q.device)
    b, h, l_q, d = q.shape
    h_kv, l_max = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rows = h // h_kv * l_q
    n_chunks, n_splits = _launch_plan(
        torch.cuda.get_device_properties(q.device).multi_processor_count,
        b * h_kv, l_max, rows, _KEYS_PER_TILE[q.dtype])
    o = torch.empty((b, h, l_q, d), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b * h_kv, n_splits, rows, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b * h_kv, n_splits, rows, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library(q.device.index).flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), length.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, h_kv, l_q, l_max, d,
            *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
            -1 if window is None else window, sinks, scale, n_splits,
            n_chunks, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError_t {err} "
                           f"for q {tuple(q.shape)} caches "
                           f"{tuple(k_cache.shape)} {q.dtype}")
    flash_decode_kernel.launches += 1
    return o


flash_decode_kernel.launches = 0


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len, *, scale: float | None = None,
                 window: int | None = None, sinks: int = 0) -> torch.Tensor:
    """Attend the last l_q tokens against a fixed-shape KV cache.

    q: (B, H, l_q, D), the newest l_q tokens, ending at position
    cache_len − 1. k_cache, v_cache: (B, H_kv, L_max, D); entries at
    positions ≥ cache_len are ignored (any garbage is safe). cache_len: an
    int or a one-element int32 tensor on q's device, clipped to
    [l_q, L_max]; the same launch serves every value. window and sinks as
    in ``flash_attention``. Returns (B, H, l_q, D) in q's dtype.

    The reference's ``block_k`` and ``interpret`` are TPU knobs and are not
    ported: the kernel picks its own tiles and splits. The reference's
    argument checks and messages hold on both paths.
    """
    return flash_decode_kernel(q, k_cache, v_cache, cache_len, scale=scale,
                               window=window, sinks=sinks)
