"""Drive the PyTorch/CUDA port on one card and hold it to its plain versions.

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):

1. build every kernel of the port (each ``gpumounter_tpu_torch/ops/csrc/*.cu``)
   with nvcc (sm_90a), all at once, and print the card's name and power
   limit, and the registers and spills that ptxas reports for each
   instance of ``flash_fwd.cu``, ``flash_bwd.cu`` and ``flash_decode.cu``
   (failing on a warning that their wgmma structure broke, or on a spill in
   a wgmma instance);
2. hold each kernel against its plain PyTorch version on the card, case by
   case, with the tolerance stated beside each (``flash_fwd``, then
   ``flash_decode`` and the two backward kernels of ``flash_bwd``, whose
   reruns must also be bit-equal);
3. run the main paths at full width (the config of the repo's train-step
   bench: vocab 2048, d_model 1024, 8 heads of 128, 2 layers, d_ff 4096,
   rope, bf16, max_len 2048), each with the launch counts set to 0 just
   before and read just after:
   - the forward on 3 batches of 4 x 2048 random tokens, its logits held
     against the same forward with the plain attention;
   - serving: greedy ``generate`` from 4 random prompts of 1536 tokens, 512
     new tokens (up to max_len), the first decode step eager and the other
     510 replays of one captured step, the launch counts following the
     replays (``ops.graphs``); teacher-forced ``prefill`` + ``decode_step``
     logits held against ``forward`` at every generated position; the
     captured loop's tokens held bit for bit against ``generate_loop`` with
     capture=False, greedy and seeded (a CUDA generator, 512 tokens), seeded
     sampling reproducible per seed and different across seeds, and
     ``torch.cuda.memory_allocated()`` unchanged over repeated calls;
   - training: 3 SGD steps of ``make_train_step`` on 4 x 2048 random
     tokens, the grads of one batch held leaf by leaf against the grads
     through the plain attention; then ``entry.train_check()``;
4. capture one greedy ``decode_step`` as a CUDA graph and replay it at two
   cache lengths, each against an eager step and the forward (a raw
   replay goes through no wrapper; a counted replay adds n_layers
   ``flash_decode`` launches);
   then the MoE probe (the same config with 8 experts): ``moe_ffn`` against
   ``moe_ffn_plain`` at (8192, 1024) in bf16 and f32, and its forward,
   serving (the captured loop and its checks, and the captured step) and
   training paths as above, each
   held block by block against the plain attention (or, serving, against
   the forward's blocks) because a top-1 routing near tie may flip between
   two runs, then ``entry.moe_check()``;
5. time each kernel, its plain version and the PyTorch library call that
   computes the same function (kernels and library calls as device time by
   replaying a CUDA graph of 20 calls, and ``flash_fwd`` and SDPA also
   eagerly per call), the forward, the prefill, the whole greedy
   ``generate``, its capture and its replayed loop (ms per step, decode
   tokens/s, and the share of it the replayed step's device time fills),
   the eager loop beside it, and the train step split into forward,
   backward and update, with CUDA events;
   the backward kernels also with GQA H_kv 2 and window 255, ``flash_decode``
   also at a GQA shape (H 32, H_kv 4) with its achieved TB/s and the device
   time of its split kernel and of its merge from ``torch.profiler``; and
   print the slowest device kernels of one SGD step from ``torch.profiler``;
   the MoE forward, SGD step (split, profiled), prefill and decode loops;
6. the tenant's hot-mount side (``torchside``), each part in child
   processes that run this script with ``--handoff-child``:
   a. CUDA's enumeration is fixed at init: a process started with
      ``CUDA_VISIBLE_DEVICES=""`` reads 0 devices, still reads 0 through
      CUDA after ``set_visibility_env`` (``torch.cuda.init()`` and
      ``refresh_devices()`` raise), then ``handoff``s to a new image that
      sees the card, whose ``wait_for_gpus(1)`` counts 1, and which trains
      one AdamW step on it (the 0 -> 1 hot-add);
   b, c. the full-width dense and MoE trainers: 3 AdamW steps, ``pack``
      (params and optimizer state), ``handoff``; the new image loads,
      restores, takes 3 more steps and a greedy ``generate``; losses, final
      params and tokens held bit for bit against the same run in this
      process without a handoff, 3 handoffs each, the launch counts of
      every image checked, and the median time of each part of the
      handoff printed (pack, save, exec to CUDA ready, load, restore, the
      optimizer's state, the first step, the tenant's whole side) with
      the checkpoint directory's filesystem (a ``tempfile.mkdtemp()``,
      removed after);
7. dp x tp and expert parallelism (``parallel/``): 4 ranks started once
   (``parallel.launch.run_ranks``) on a 2 x 2 ("data", "model") mesh, all
   sharing the one card over gloo (NCCL refuses two ranks on one device;
   gloo's all-reduce takes CUDA tensors by way of the host). In them:
   ``entry.tp_checks`` (the dryrun's sharded sections at ``train_check``'s
   dialect: the kernel-vs-plain grads on the mesh within 5e-3, the MoE
   flagship, ``make_moe_step`` over ("data", "expert")); then the full-width
   dense and MoE sharded SGD steps (``entry.sharded_step_check``: local
   shapes, ``flash_fwd``, dq and dk/dv n_layers times a step on every rank
   at H/tp heads, the collectives of ``step_collectives``, replicas
   bit-equal), their gathered new params and loss held against the
   one-process ``make_train_step`` on the same card, weights and tokens, the
   dense grads through the kernels against the plain attention's on the
   mesh, and each rank's step time, gloo all-reduce time and gradient
   sums' time;
8. sequence and pipeline parallelism (``parallel/ring_attention.py``,
   ``pipeline.py``, ``pipeline_train.py``): 4 ranks started once on the
   card over gloo (its point-to-point calls take no CUDA tensor, so the
   ring's shifts go by way of host buffers), with (data, seq) meshes of
   2 x 2 and 1 x 4 and a ("pipe",) mesh of 4. In them: ring attention on
   1 x 4 at the full-width chunk shapes (B4 H8 L2048 as 4 chunks of 512,
   D128, bf16: every rank meets a skipped, the diagonal and a past chunk)
   against ``flash_attention`` over the whole sequence, forward and dq,
   dk, dv; the full-width dense and MoE SGD steps with attn_parallel "seq"
   on both meshes (``step_collectives``, each training kernel (c + 1) x
   n_layers times a step at seq coordinate c, replicas bit-equal, the
   loss and params against the one-process step on the same card); GPipe
   (P 4, n_layers 4) and the interleaved schedule (P 4, v 2, n_layers 8)
   at full width, n_micro 4 on B4 L2048, against the one-process step;
   and times: each step a rank, one shift, the ring a layer against one
   ``flash_attention`` over the whole sequence, and the pipelines'
   ``schedule_info`` bubble fraction against each rank's time in the
   shifts;
9. the mesh-growing hot-add and the multichip dryrun, ranks sharing the
   card over gloo:
   a. ``entry.grow_check`` at full width, dense then MoE: 2 ranks on a
      (1, 2) ("data", "model") mesh take 2 AdamW steps, pack params and
      optimizer state through the placement (every leaf gathered whole),
      rank 0 saves; 4 new ranks on (2, 2) load, restore their shards (held
      bit-equal to ``shard_params`` of the packed state, and gathered again
      bit-equal), load the optimizer's state and take 2 more steps, the
      first held against one process from the same state; the launches of
      every rank's steps, and the host-clock parts of the hot-add (pack
      with its gather, save, the new world's start, load, restore, the
      optimizer's state, the first step);
   b. ``entry.dryrun_multichip(8)``, the reference's own shape: its
      sections on 8 ranks (``tp_checks`` on (1, 8): 2 q heads and 1 kv head
      a rank; ``seq_checks`` on (2, 4); ``pipeline_checks`` on 4 stages),
      then the stretch, 16 ranks on the H100 plan's (2, 8) mesh; each
      section's numbers against its limits and its launches per rank.

The last lines are a JSON object per kernel (``{"kernels": [...]}``) and
``{"ok": true, "device": {...}}``, and the exit code is 0. A failing check
raises: the script prints which phase failed and why, and exits 1. Run
alone, without ``gpumounter_tpu_torch`` beside it, it says so and exits 2.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

try:
    import gpumounter_tpu_torch  # noqa: F401
except ModuleNotFoundError as err:
    if err.name != "gpumounter_tpu_torch":
        raise
    print("chip_smoke: the package gpumounter_tpu_torch is not beside this script; "
          "run it from the root of the repository", file=sys.stderr)
    sys.exit(2)
from gpumounter_tpu_torch.entry import (MOE_ROUTE_GAP, ONE_PROCESS_LOSS_ATOL,
                                        RING_TOL, SHARDED_LOSS_ATOL, SHARDED_PARAM_OF_MAX,
                                        TRAIN_GRAD_ATOL, _check_equal_over, _masked_err,
                                        against_one_process, check_config, dryrun_multichip,
                                        grow_check,
                                        kernel_launches, moe_blocks_vs_plain, moe_check,
                                        reset_kernel_launches, route_flips,
                                        sharded_step_check, tp_checks, train_check)
from gpumounter_tpu_torch.models.probe import (TransformerConfig, _attend, _attend_decode,
                                               _decoder, _embed, _finish_block, _forward_impl,
                                               _picker, decode_step, forward, generate,
                                               generate_loop, init_params, local_heads,
                                               loss_fn, next_token_nll, prefill)
from gpumounter_tpu_torch.parallel import collectives
from gpumounter_tpu_torch.parallel.collectives import all_gather, all_reduce, ring_shift
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.parallel.mesh import build_mesh, shard_qkv
from gpumounter_tpu_torch.parallel.moe import _route, init_moe_params, moe_ffn, moe_ffn_plain
from gpumounter_tpu_torch.ops import _build
from gpumounter_tpu_torch.ops import flash_attention as fa, flash_decode as fd
from gpumounter_tpu_torch.ops.graphs import capture
from gpumounter_tpu_torch.ops.flash_attention import (_band_mask, _bwd_launch,
                                                      attention_bwd_plain,
                                                      attention_plain, flash_attention,
                                                      flash_attention_bwd_kernel,
                                                      flash_attention_kernel)
from gpumounter_tpu_torch.parallel.pipeline import schedule_info
from gpumounter_tpu_torch.parallel.pipeline_train import (make_pipeline_train_step,
                                                          shard_pipeline_params,
                                                          to_pipeline_params)
from gpumounter_tpu_torch.parallel.ring_attention import ring_attention
from gpumounter_tpu_torch.parallel.train_step import (gather_params, loss_and_grads,
                                                      make_train_step, shard_params,
                                                      make_train_step_optim,
                                                      sgd_update, step_collectives,
                                                      tree_leaves, tree_map, tree_names)
from gpumounter_tpu_torch.ops.flash_decode import (flash_decode_kernel,
                                                   flash_decode_plain)
from gpumounter_tpu_torch.torchside import (HotResumable, handoff, load_optimizer_state,
                                            optimizer_state_tree, refresh_devices,
                                            set_visibility_env, wait_for_gpus)
from gpumounter_tpu_torch.torchside.visibility import HANDOFF_AT_ENV

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the bf16 tensor-core rate and its bytes
# (each input read once, each output written once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FULL = dict(B=4, H=8, L=2048, D=128)
# bf16 output: 1 ulp is 2^-8 relative; the kernel also rounds P to bf16
# before P·V (as the TPU kernel does) where the plain version keeps f32.
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# A decode output averages up to 32768 unit-normal V rows, so |o| can be far
# below BF16_TOL's atol: the bf16 cases are held to DECODE_ULPS_OF_MAX ulps
# (2^-8) of the output's max |value| instead, never looser than BF16_TOL.
# Then one 64-key tile left out of 32768 keys fails (checked on the CPU with
# the plain version: 251 of 4096 outputs beyond the limit).
DECODE_ULPS_OF_MAX = 4
LSE_ATOL = 1e-4  # lse is f32 from f32 scores on both sides
# Logits of the full forward: attention outputs that differ by ~1 bf16 ulp
# pass through two layers of bf16 matmuls and residual adds.
LOGITS_RTOL_OF_MAX = 2e-2
NLL_ATOL = 1e-3  # the mean over 4 x 2047 positions smooths those errors
NLL_ABOVE_UNIFORM = 0.5
# Serving at full width: prompts of 1536 tokens, decoding up to max_len.
SERVE = dict(B=4, T0=1536, N_NEW=512)
# Decode timings: the repo's decode bench shape (bench_flash_features.py:289)
# at three valid lengths, a GQA decode shape (group 8), and the serving shape.
DECODE_BENCH = dict(B=4, H=8, L_Q=8, D=128, L_MAX=32768, LENS=(1024, 8192, 32768))
DECODE_GQA = dict(H=32, H_KV=4, L_Q=1, L_MAX=32768, LEN=8192)
L2_COPIES = 4  # inputs cycled so that a timed launch finds its K/V outside L2
# Backward kernels against attention_bwd_plain, as a share of each gradient's
# max |value|. bf16: each gradient is rounded once to bf16 from f32
# accumulators (0.4% of max at most) and, as in the TPU kernel, p and ds are
# rounded to bf16 before their products where the plain version keeps f32;
# the first card run measured at most 0.8% of max. f32: the order of
# summation only (measured below 1e-6).
BWD_RTOL_OF_MAX = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Training at full width: 3 SGD steps on fresh 4 x 2048 batches.
TRAIN = dict(B=4, L=2048, STEPS=3, LR=1e-3)
# Grads of the bf16 weights through the kernels against those through the
# plain attention, per leaf, as a share of the leaf's max |grad|: attention
# grads that differ by up to 0.8% of max pass through two layers of bf16
# matmuls, rmsnorm and GELU backward, and every leaf is rounded to bf16.
GRAD_RTOL_OF_MAX = 5e-2
# The MoE configuration: the full-width config with the reference's 8
# experts (__graft_entry__.py:195-201).
MOE_EXPERTS = 8
# moe_ffn (batched products over every token) against moe_ffn_plain (each
# expert's own tokens): cuBLAS may sum the two shapes in other orders. bf16:
# both round the expert products to bf16, held to 4 bf16 ulps (2^-8 each)
# of the output's max |value|; f32 (no TF32): summation order, 1e-5 of max.
MOE_OUT_OF_MAX = {torch.bfloat16: 4 * 2**-8, torch.float32: 1e-5}
MOE_AUX_ATOL = 1e-5
# Teacher-forced MoE decode against the forward: the generated tokens are
# the model's own picks, so their NLL sits below log V and the forward's
# range does not apply. A routing flip (about 1% of positions a layer)
# changes its position's logits wholly; those logits spread s ~ 0.5, so a
# flip moves its position's NLL by about a nat and the mean by about 0.01.
MOE_SERVE_NLL_ATOL = 0.05
# Phase 7: 4 ranks on a 2 x 2 ("data", "model") mesh sharing the card over
# gloo; TIMED sharded steps a config timed on each rank, after the checks.
SHARDED = dict(SHAPE=(2, 2), BACKEND="gloo", SEED=200, TIMED=3)
# Phase 8: 4 ranks sharing the card over gloo, on (data, seq) meshes of
# 2 x 2 and 1 x 4 and a ("pipe",) mesh of 4; the pipelines run N_MICRO
# microbatches of the TRAIN batch (one row each), the interleaved one
# VIRTUAL chunks a rank; TIMED timed runs of each step a rank.
SEQ_PIPE = dict(WORLD=4, SEQ_SHAPES=((2, 2), (1, 4)), BACKEND="gloo", SEED=300, TIMED=3,
                N_MICRO=4, VIRTUAL=2)
# Phase 9: the hot-add that grows a job's mesh at full width, from OLD to
# NEW ("data", "model") ranks sharing the card over gloo (the data axis
# grows as well as model), STEPS AdamW steps in each world; then the
# reference's dryrun at the shape its __main__ runs (__graft_entry__.py:347), its
# 16-rank stretch included. TIMEOUT_S: each spawn's own limit.
GROW = dict(OLD=(1, 2), NEW=(2, 2), STEPS=(2, 2), BACKEND="gloo", TIMEOUT_S=300.0)
DRYRUN = dict(N=8, BACKEND="gloo", TIMEOUT_S=300.0)


def _card(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters runs, with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_pairs(l_q, l_k, causal=True, window=None):
    """(query, key) pairs one head attends: the causal band, L(L+1)/2 when
    L_q == L_k, cut to the window [p − window, p] when one is set."""
    if not causal:
        return l_q * l_k
    offset = l_k - l_q
    return sum(min(p, window) + 1 if window is not None else p + 1
               for p in range(offset, offset + l_q))


def _attention_bound_ms(b, h, l_q, l_k, d, itemsize, causal=True, h_kv=None, window=None):
    """Least time for the attention forward: 4·D operations per attended
    (query, key) pair against q and o (H heads) and k and v (H_kv heads)
    bytes. Returns (ms, what bounds it, the operations)."""
    flops = 4 * d * b * h * _attention_pairs(l_q, l_k, causal, window)
    nbytes = itemsize * d * b * (2 * h * l_q + 2 * (h_kv or h) * l_k)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def _bwd_bound_ms(b, h, h_kv, l_q, l_k, d, itemsize, products, n_out, causal=True, window=None):
    """Least time for one backward kernel: `products` products of 2·D
    operations per attended (query, key) pair (dq: S, dP, dQ; dk/dv: S, dP,
    dV, dK) against q, do, k, v, lse and Δ read once and its n_out
    outputs (dq: (B, H, L_q, D); dk, dv: (B, H_kv, L_k, D)) written once.
    Returns (ms, what bounds it, the operations)."""
    flops = 2 * products * d * b * h * _attention_pairs(l_q, l_k, causal, window)
    out_rows = b * h * l_q if n_out == 1 else 2 * b * h_kv * l_k
    nbytes = (itemsize * d * (2 * b * h * l_q + 2 * b * h_kv * l_k + out_rows)
              + 4 * 2 * b * h * l_q)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def _decode_bound_ms(b, h, h_kv, l_q, n, d, itemsize):
    """Least time for decode attention at valid length n (no window): the
    valid K/V region read once plus q and o, against 4·D operations per
    attended (query, key) pair — row i of l_q attends n − l_q + 1 + i keys.
    Returns (ms, what bounds it, the bytes)."""
    pairs = l_q * (n - l_q + 1) + l_q * (l_q - 1) // 2
    flops = 4 * d * b * h * pairs
    nbytes = itemsize * d * (2 * b * h_kv * n + 2 * b * h * l_q)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", nbytes


def _cycle(fns):
    """One callable that calls fns in turn, one per call."""
    state = {"i": 0}

    def call():
        fns[state["i"] % len(fns)]()
        state["i"] += 1
    return call


def _graph_ms(fns, calls: int = 20, replays: int = 5) -> float:
    """Device time per call of fns (taken in turn), without the host's
    launch overhead: `calls` calls are captured once in a CUDA graph (after
    one eager warm-up call) and the graph's replays timed with CUDA
    events."""
    call = _cycle(fns)
    graph, _, _ = capture(lambda: [call() for _ in range(calls)])
    return _time_ms(graph.replay, replays, warmup=1) / calls


def _profile_ms(fn, calls: int, names) -> dict:
    """Device ms a call of fn() spends in the kernels whose names hold each
    of `names`, by torch.profiler over `calls` calls."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for evt in prof.key_averages():
        for name in names:
            if evt.device_type == torch.autograd.DeviceType.CUDA and name in evt.key:
                out[name] += evt.self_device_time_total / 1e3 / calls
    return out


def _check_close(name, got, want, tol):
    """Raise unless |got − want| <= atol + rtol·|want| everywhere and got is
    finite; returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    bad = diff > tol["atol"] + tol["rtol"] * want.float().abs()
    if not torch.isfinite(got).all() or bad.any():
        raise RuntimeError(f"{name}: max abs err {err} beyond atol "
                           f"{tol['atol']} + rtol {tol['rtol']}")
    return err


# A mangled kernel name: its length, then e.g. flash_bwd_dkv_kernel, then
# the template arguments (the anonymous namespace's own name also holds
# "flash_bwd_", after an underscore, not a digit).
_PTXAS_ENTRY = re.compile(r"Compiling entry function '\S*?\d(flash_(?:fwd|bwd|decode)_[a-z0-9_]+?_kernel)I(\w*?)EEv")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
# Warnings that mean the warp-specialised structure or the accumulator
# fences broke: ptxas dropped the register reallocation, or made the
# asynchronous products wait for each other.
_PTXAS_BROKEN = re.compile(r"setmaxnreg ignored|wgmma.*serialized|C7508", re.IGNORECASE)
PTXAS_REPORTED = ("flash_fwd", "flash_bwd", "flash_decode")
# The wgmma instances, which must not spill (the f32 scalar ones may).
_PTXAS_NO_SPILL = re.compile(r"ptxas (flash_fwd_tc|flash_bwd_dq|flash_bwd_dkv|flash_decode_tc)_kernel<")


def _ptxas_lines(log: str) -> list[str]:
    """One line per kernel instance of ptxas's -v report: its registers (the
    launch's cap; setmaxnreg moves them between warpgroups later) and its
    spills."""
    lines, name, spill = [], None, None
    for line in log.splitlines():
        if entry := _PTXAS_ENTRY.search(line):
            args = re.findall(r"L[ib](\d+)E?", entry.group(2) + "E")
            name = f"{entry.group(1)}<{', '.join(args)}>"
        elif name and (found := _PTXAS_SPILL.search(line)):
            spill = found.groups()
        elif name and spill and (found := _PTXAS_REGS.search(line)):
            lines.append(f"ptxas {name}: {found.group(1)} registers, spill stores "
                         f"{spill[0]} B, spill loads {spill[1]} B")
            name = spill = None
    return lines


def phase_build(card: str) -> None:
    """Build every kernel; beside the build, compile the wgmma sources once
    more with ptxas's -v report and print each instance's registers and
    spills, and ptxas's other notes. Fails on a warning that the
    warp-specialised structure broke."""
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports = {}
    for name in PTXAS_REPORTED:
        report_so = _build.BUILD_DIR / f"ptxas-report-{name}.so"
        reports[name] = (report_so, subprocess.Popen(
            _build.nvcc_command(_build.CSRC / f"{name}.cu", report_so) + ["-Xptxas", "-v"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = _build.build(sorted(src.stem for src in _build.CSRC.glob("*.cu")))
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(p.name for p in paths.values())})",
          flush=True)
    for name, (report_so, report) in reports.items():
        log, _ = report.communicate()
        report_so.unlink(missing_ok=True)
        lines = _ptxas_lines(log)
        if report.returncode != 0 or not lines:
            raise RuntimeError(f"ptxas report of {name}.cu failed:\n{log[-3000:]}")
        notes = [line.strip() for line in log.splitlines()
                 if re.search(r"warning|\(C\d+\)", line)]
        print("\n".join(lines + [f"ptxas note ({name}.cu): {note}" for note in notes]), flush=True)
        if broken := [note for note in notes if _PTXAS_BROKEN.search(note)]:
            raise RuntimeError(f"{name}.cu: ptxas warns that the wgmma structure broke: {broken}")
        if spilled := [line for line in lines if _PTXAS_NO_SPILL.match(line)
                       and not line.endswith("spill stores 0 B, spill loads 0 B")]:
            raise RuntimeError(f"{name}.cu: wgmma instances spill: {spilled}")
    print(f"ptxas reports: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_kernel_vs_plain(gen) -> float:
    """Each case runs the kernel and the plain version on the same inputs;
    returns the max abs error of the full-width causal case."""

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    cases = [  # (name, (B, H, H_kv, L_q, L_k, D), kwargs, dtype)
        ("causal B4 H8 L2048 D128", (b, h, h, l, l, d), dict(causal=True), torch.bfloat16),
        ("GQA H_kv=2", (b, h, 2, l, l, d), dict(causal=True), torch.bfloat16),
        ("window 255", (b, h, h, l, l, d), dict(causal=True, window=255), torch.bfloat16),
        ("window 255 + sinks 4", (b, h, h, l, l, d), dict(causal=True, window=255, sinks=4), torch.bfloat16),
        ("softcap 30", (b, h, h, l, l, d), dict(causal=True, softcap=30.0), torch.bfloat16),
        ("return_lse", (b, h, h, l, l, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("causal cross-length L_q=128 L_k=2048", (b, h, h, 128, l, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("D=32", (b, h, h, l, l, 32), dict(causal=True), torch.bfloat16),
        ("D=64", (b, h, h, l, l, 64), dict(causal=True), torch.bfloat16),
        ("ragged L=1000", (b, h, h, 1000, 1000, d), dict(causal=True), torch.bfloat16),
        ("non-causal L_q=300 L_k=700 D=64", (2, 4, 4, 300, 700, 64), dict(causal=False), torch.bfloat16),
        # The edges of the bf16 kernel's 128-row q tiles and 128-key k tiles.
        ("ragged L=129 + lse", (b, h, h, 129, 129, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("causal cross-length L_q=1 L_k=300", (b, h, h, 1, 300, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("causal cross-length L_q=100 L_k=300", (b, h, h, 100, 300, d), dict(causal=True, return_lse=True), torch.bfloat16),
        *[(f"window {w} L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=w), torch.bfloat16)
          for w in (17, 127, 128, 129)],
        ("window 200 + sinks 130 L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=200, sinks=130, return_lse=True), torch.bfloat16),
        ("GQA group 8 L=1000", (b, h, 1, 1000, 1000, d), dict(causal=True), torch.bfloat16),
        ("softcap 30 + lse", (b, h, h, l, l, d), dict(causal=True, softcap=30.0, return_lse=True), torch.bfloat16),
        ("f32 GQA window 17 + sinks 2 L=500 D=64", (2, 4, 2, 500, 500, 64), dict(causal=True, window=17, sinks=2, return_lse=True), torch.float32),
        # Ring attention's chunk steps at the full-width chunk (L 2048 over
        # 4 ranks): an earlier chunk whole, with lse.
        ("ring chunk non-causal L=512 + lse", (b, h, h, 512, 512, d), dict(causal=False, return_lse=True), torch.bfloat16),
        ("ring chunk non-causal GQA H_kv=2 L=512 + lse", (b, h, 2, 512, 512, d), dict(causal=False, return_lse=True), torch.bfloat16),
    ]
    full_err = None
    for name, (cb, ch, chk, lq, lk, cd), kw, dtype in cases:
        q = rand(cb, ch, lq, cd, dtype=dtype)
        k = rand(cb, chk, lk, cd, dtype=dtype)
        v = rand(cb, chk, lk, cd, dtype=dtype)
        got = flash_attention_kernel(q, k, v, **kw)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = attention_plain(q, k, v, **kw)
        if kw.get("return_lse"):
            (got, got_lse), (want, want_lse) = got, want
            lse_err = (got_lse - want_lse).abs().max().item()
            if not lse_err <= LSE_ATOL:
                raise RuntimeError(f"{name}: lse max abs err {lse_err} > {LSE_ATOL}")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        err = _check_close(f"{name}: kernel vs plain", got, want, tol)
        lse_note = f", lse err {lse_err:.3g}" if kw.get("return_lse") else ""
        print(f"case {name}: max abs err {err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}){lse_note}",
              flush=True)
        if full_err is None:
            full_err = err
    return full_err


def full_width_config(n_experts: int | None = None) -> TransformerConfig:
    return TransformerConfig(vocab=2048, d_model=1024, n_heads=8, n_layers=2,
                             d_ff=4096, max_len=FULL["L"], rope=True,
                             dtype=torch.bfloat16, n_experts=n_experts)


def phase_main_path(cfg, params, batches) -> int:
    """Forward on each batch through the kernel; returns its launch count."""
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    outs = [forward(params, tokens, cfg) for tokens in batches]
    torch.cuda.synchronize()
    launches = flash_attention_kernel.launches
    want_launches = cfg.n_layers * len(batches)
    if launches != want_launches:
        raise RuntimeError(f"flash_fwd launched {launches} times on the main "
                           f"path, expected n_layers x batches = {want_launches}")
    for i, (tokens, logits) in enumerate(zip(batches, outs)):
        if logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all():
            raise RuntimeError(f"batch {i}: logits {tuple(logits.shape)} not "
                               f"finite of shape {(*tokens.shape, cfg.vocab)}")
        nll = next_token_nll(logits, tokens).item()
        # Random weights give near-uniform predictions: logits of std s put
        # the NLL about s²/2 above log(vocab) (s ~ 0.5 at this width).
        if not 0 <= nll - math.log(cfg.vocab) < NLL_ABOVE_UNIFORM:
            raise RuntimeError(f"batch {i}: next-token nll {nll} not within "
                               f"{NLL_ABOVE_UNIFORM} above log(vocab) = "
                               f"{math.log(cfg.vocab)}")
        plain = forward(params, tokens, cfg, attention=attention_plain)
        err = (logits - plain).abs().max().item()
        limit = LOGITS_RTOL_OF_MAX * plain.abs().max().item()
        nll_plain = next_token_nll(plain, tokens).item()
        if not (err <= limit and abs(nll - nll_plain) <= NLL_ATOL):
            raise RuntimeError(f"batch {i}: vs plain-attention forward: logits "
                               f"max abs err {err} (limit {limit}), nll {nll} "
                               f"vs {nll_plain} (limit {NLL_ATOL})")
        print(f"main path batch {i}: logits {tuple(logits.shape)} finite, nll "
              f"{nll:.4f} (log V {math.log(cfg.vocab):.4f}, plain-attention "
              f"forward {nll_plain:.4f}), logits vs plain-attention forward "
              f"max abs err {err:.3g} (limit {limit:.3g} = "
              f"{LOGITS_RTOL_OF_MAX} x max |logits|)", flush=True)
    print(f"main path: flash_fwd launches {launches} (n_layers {cfg.n_layers} "
          f"x batches {len(batches)})", flush=True)
    return launches


def phase_decode_vs_plain(gen) -> float:
    """flash_decode against flash_decode_plain, case by case; the length
    goes in as a CUDA int32 tensor and as an int, which must agree
    exactly, and a rerun must give the same bits. Returns the max abs
    error of the serving case at 2048."""

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, d = FULL["B"], FULL["H"], FULL["D"]
    serve = (b, h, h, 1, FULL["L"], d)
    cases = [  # (name, (B, H, H_kv, l_q, L_max, D), cache_len, kwargs, dtype, tail)
        *[(f"serving B4 H8 l_q1 D128 L_max2048 len {n}", serve, n, {}, torch.bfloat16, None)
          for n in (2048, 1, 37, 1537)],
        ("len 3000 clipped to L_max", serve, 3000, {}, torch.bfloat16, None),
        ("len 3 below l_q 8, clipped up", (b, h, h, 8, 2048, d), 3, {}, torch.bfloat16, None),
        ("tail 1e9 past len 1000", serve, 1000, {}, torch.bfloat16, 1e9),
        ("l_q 8 window 50", (b, h, h, 8, 2048, d), 1537, dict(window=50), torch.bfloat16, None),
        ("window 40 + sinks 8", serve, 1537, dict(window=40, sinks=8), torch.bfloat16, None),
        ("GQA H_kv 2", (b, h, 2, 1, 2048, d), 1537, {}, torch.bfloat16, None),
        ("MQA H_kv 1", (b, h, 1, 1, 2048, d), 1537, {}, torch.bfloat16, None),
        ("D 32", (b, h, h, 1, 2048, 32), 1537, {}, torch.bfloat16, None),
        ("D 64", (b, h, h, 1, 2048, 64), 1537, {}, torch.bfloat16, None),
        ("f32 GQA l_q 4 window 100 + sinks 3 D 64", (2, 8, 2, 4, 700, 64), 650,
         dict(window=100, sinks=3), torch.float32, None),
        # One block's 64 rows, then beyond them (two row chunks).
        ("GQA group 8 l_q 8 = 64 rows", (b, h, 1, 8, 2048, d), 1537, {}, torch.bfloat16, None),
        ("MQA H16 l_q 8 = 128 rows window 100 + sinks 4", (b, 16, 1, 8, 2048, d), 1537,
         dict(window=100, sinks=4), torch.bfloat16, None),
        ("f32 MQA H16 l_q 8 = 128 rows window 100 + sinks 3 D 64", (2, 16, 1, 8, 700, 64), 650,
         dict(window=100, sinks=3), torch.float32, None),
        # A length inside a 64-key tile: the tile's NaN slots arrive by TMA.
        ("NaN tail past len 1001", serve, 1001, {}, torch.bfloat16, float("nan")),
        ("bench shape len = L_max 32768", (b, h, h, DECODE_BENCH["L_Q"], DECODE_BENCH["L_MAX"], d),
         DECODE_BENCH["L_MAX"], {}, torch.bfloat16, None),
    ]
    serve_err = None
    for name, (cb, ch, chk, lq, lmax, cd), n, kw, dtype, tail in cases:
        q = rand(cb, ch, lq, cd, dtype=dtype)
        k = rand(cb, chk, lmax, cd, dtype=dtype)
        v = rand(cb, chk, lmax, cd, dtype=dtype)
        if tail is not None:
            k[:, :, n:] = tail
            v[:, :, n:] = tail
        got = flash_decode_kernel(q, k, v, torch.tensor([n], dtype=torch.int32, device="cuda"), **kw)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        by_int = flash_decode_kernel(q, k, v, n, **kw)
        if not torch.equal(got, by_int):
            raise RuntimeError(f"{name}: length as a tensor and as an int disagree")
        if not torch.equal(got, flash_decode_kernel(q, k, v, n, **kw)):
            raise RuntimeError(f"{name}: a rerun gave other bits")
        want = flash_decode_plain(q, k, v, n, **kw)
        tol = F32_TOL
        if dtype == torch.bfloat16:
            of_max = DECODE_ULPS_OF_MAX * 2**-8 * want.float().abs().max().item()
            tol = dict(BF16_TOL, atol=min(BF16_TOL["atol"], of_max))
        err = _check_close(f"{name}: kernel vs plain", got, want, tol)
        print(f"case flash_decode {name}: max abs err {err:.3g} (atol {tol['atol']:.3g}, "
              f"rtol {tol['rtol']}), tensor and int length equal, rerun bit-equal", flush=True)
        if serve_err is None:
            serve_err = err
    return serve_err


def phase_bwd_vs_plain(gen) -> tuple[float, float]:
    """flash_bwd's two kernels against attention_bwd_plain on the forward's
    cases: o and lse from the forward kernel, do random, and a nonzero lse
    cotangent in the cross-length case. Returns the max abs errors of dq
    and of dk/dv in the full-width causal case."""

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, (B, H, H_kv, L_q, L_k, D), kwargs, dtype, with dlse)
        ("causal B4 H8 L2048 D128", (b, h, h, l, l, d), dict(causal=True), bf16, False),
        ("GQA H_kv=2", (b, h, 2, l, l, d), dict(causal=True), bf16, False),
        ("window 255", (b, h, h, l, l, d), dict(causal=True, window=255), bf16, False),
        ("window 255 + sinks 4", (b, h, h, l, l, d), dict(causal=True, window=255, sinks=4), bf16, False),
        ("softcap 30", (b, h, h, l, l, d), dict(causal=True, softcap=30.0), bf16, False),
        ("causal cross-length L_q=128 L_k=2048 + dlse", (b, h, h, 128, l, d), dict(causal=True), bf16, True),
        ("D=32", (b, h, h, l, l, 32), dict(causal=True), bf16, False),
        ("D=64", (b, h, h, l, l, 64), dict(causal=True), bf16, False),
        ("ragged L=1000", (b, h, h, 1000, 1000, d), dict(causal=True), bf16, False),
        ("non-causal L_q=300 L_k=700 D=64", (2, 4, 4, 300, 700, 64), dict(causal=False), bf16, False),
        # The edges of the bf16 kernels' tiles: blocks of 128 queries (dq)
        # and of 64 keys (dk/dv), tiles of 64 rows streamed against them.
        ("ragged L=129", (b, h, h, 129, 129, d), dict(causal=True), bf16, False),
        ("ragged L=300", (b, h, h, 300, 300, d), dict(causal=True), bf16, False),
        ("causal cross-length L_q=1 L_k=300", (b, h, h, 1, 300, d), dict(causal=True), bf16, False),
        ("causal cross-length L_q=100 L_k=300 + dlse", (b, h, h, 100, 300, d), dict(causal=True), bf16, True),
        *[(f"window {w} L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=w), bf16, False)
          for w in (17, 127, 128, 129)],
        ("window 200 + sinks 130 L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=200, sinks=130),
         bf16, False),
        ("window 50 + sinks 70 L=1000 D=64", (b, h, h, 1000, 1000, 64), dict(causal=True, window=50, sinks=70),
         bf16, False),
        ("GQA group 4 L=1000", (b, h, 2, 1000, 1000, d), dict(causal=True), bf16, False),
        ("GQA group 8 L=1000", (b, h, 1, 1000, 1000, d), dict(causal=True), bf16, False),
        ("negative scale L=1000 D=64", (b, h, h, 1000, 1000, 64), dict(causal=True, scale=-0.1), bf16, False),
        ("f32 GQA window 17 + sinks 2 L=500 D=64 + dlse", (2, 4, 2, 500, 500, 64),
         dict(causal=True, window=17, sinks=2), f32, True),
        # Ring attention's backward: the chunks merge through their lse, so
        # every chunk's lse cotangent is non-zero, on earlier chunks whole.
        ("ring chunk non-causal L=512 + dlse", (b, h, h, 512, 512, d), dict(causal=False), bf16,
         True),
        ("ring chunk non-causal GQA H_kv=2 L=512 + dlse", (b, h, 2, 512, 512, d),
         dict(causal=False), bf16, True),
    ]
    full = None
    for name, (cb, ch, chk, lq, lk, cd), kw, dtype, with_dlse in cases:
        q = rand(cb, ch, lq, cd, dtype=dtype)
        k = rand(cb, chk, lk, cd, dtype=dtype)
        v = rand(cb, chk, lk, cd, dtype=dtype)
        o, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
        do = rand(cb, ch, lq, cd, dtype=dtype)
        dlse = rand(cb, ch, lq, dtype=f32) if with_dlse else None
        got = flash_attention_bwd_kernel(q, k, v, o, lse, do, dlse, **kw)
        torch.cuda.synchronize()  # a fault in the kernels surfaces here
        # No atomics and a fixed order of the group sum: the same bits again.
        if not all(map(torch.equal, got, flash_attention_bwd_kernel(q, k, v, o, lse, do, dlse, **kw))):
            raise RuntimeError(f"{name}: a rerun of the backward kernels gave other bits")
        want = attention_bwd_plain(q, k, v, o, lse, do, dlse, **kw)
        rtol = BWD_RTOL_OF_MAX[dtype]
        errs, limits = [], []
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w.float()).abs().max().item()
            limit = rtol * w.float().abs().max().item()
            if not (torch.isfinite(g).all() and err <= limit):
                raise RuntimeError(f"{name}: {grad} kernel vs plain max abs err {err} "
                                   f"(limit {limit} = {rtol} x max |{grad}|)")
            errs.append(err)
            limits.append(limit)
        print(f"case flash_bwd {name}: dq / dk / dv max abs err "
              f"{' / '.join(f'{e:.3g}' for e in errs)} (limits "
              f"{' / '.join(f'{x:.3g}' for x in limits)} = {rtol} x max |grad|), rerun bit-equal",
              flush=True)
        if full is None:
            full = (errs[0], max(errs[1:]))
    return full


def phase_train(cfg, params, batches) -> tuple[int, int, int]:
    """SGD steps through make_train_step, one per batch, with the counts
    set to 0 just before and read just after; then one batch's grads
    through the kernels against the grads through the plain attention, and
    train_check(). Returns the (flash_fwd, dq, dk/dv) launches."""
    step = make_train_step(cfg, TRAIN["LR"])
    bwd = flash_attention_bwd_kernel
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    bwd.dq_launches = bwd.dkv_launches = 0
    p, losses = params, []
    for tokens in batches:
        p, loss = step(p, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = (flash_attention_kernel.launches, bwd.dq_launches, bwd.dkv_launches)
    want = cfg.n_layers * len(batches)
    if counts != (want,) * 3 or flash_decode_kernel.launches:
        raise RuntimeError(f"train steps launched flash_fwd / dq / dk/dv {counts} and "
                           f"flash_decode {flash_decode_kernel.launches} times, expected "
                           f"n_layers x steps = {want} each and 0")
    log_v = math.log(cfg.vocab)
    losses = [loss.item() for loss in losses]
    if not all(0 <= x - log_v < NLL_ABOVE_UNIFORM for x in losses):
        raise RuntimeError(f"train losses {losses} not within {NLL_ABOVE_UNIFORM} above "
                           f"log(vocab) = {log_v}")
    if not all(torch.isfinite(t).all() for t in tree_leaves(p)):
        raise RuntimeError("params after the train steps are not finite")
    print(f"training path: {len(batches)} SGD steps (lr {TRAIN['LR']}) on "
          f"{tuple(batches[0].shape)} tokens, losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"(log V {log_v:.4f}); launches flash_fwd {counts[0]}, dq {counts[1]}, dk/dv "
          f"{counts[2]} (n_layers {cfg.n_layers} x {len(batches)} steps each)", flush=True)

    _, grads = loss_and_grads(params, batches[0], cfg)
    _, plain = loss_and_grads(params, batches[0], cfg, attention=attention_plain)
    bad, worst = [], (-1.0, "")
    for name, g, w in zip(tree_names(params), tree_leaves(grads), tree_leaves(plain)):
        err = (g.float() - w.float()).abs().max().item()
        peak = w.float().abs().max().item()
        share = err / peak if peak else math.inf
        print(f"training grads {name}: max abs err {err:.3g} vs plain-attention grads, "
              f"{share:.3g} of max |grad| {peak:.3g}", flush=True)
        if not (torch.isfinite(g).all() and err <= GRAD_RTOL_OF_MAX * peak):
            bad.append(name)
        worst = max(worst, (share, name))
    if bad:
        raise RuntimeError(f"grads of {bad} differ from the plain-attention grads by more "
                           f"than {GRAD_RTOL_OF_MAX} x max |grad|")
    print(f"training path: grads through the kernels vs plain attention, worst leaf "
          f"{worst[1]} at {worst[0]:.3g} of its max |grad| (limit {GRAD_RTOL_OF_MAX})", flush=True)
    result = train_check()
    print(f"train_check(): flagship dialect at d_head 32, loss {result['loss']:.4f}, "
          f"grads vs plain max abs err {result['max_grad_err']:.3g} (limit 5e-3)", flush=True)
    return counts


def phase_serving(cfg, params, prompt) -> tuple[int, int, torch.Tensor, torch.Tensor]:
    """Greedy generate with the counts set to 0 just before; then the
    teacher-forced and sampled checks. Returns (flash_fwd launches,
    flash_decode launches, tokens, forward's logits on the tokens)."""
    t0, n_new = prompt.shape[1], SERVE["N_NEW"]
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    tokens = generate(params, prompt, cfg, n_new)
    torch.cuda.synchronize()
    fwd, dec = flash_attention_kernel.launches, flash_decode_kernel.launches
    if (fwd, dec) != (cfg.n_layers, cfg.n_layers * (n_new - 1)):
        raise RuntimeError(f"generate launched flash_fwd {fwd} and flash_decode "
                           f"{dec} times, expected n_layers = {cfg.n_layers} and "
                           f"n_layers x (n_new - 1) = {cfg.n_layers * (n_new - 1)}")
    length = t0 + n_new
    if (tokens.shape != (prompt.shape[0], length) or not torch.equal(tokens[:, :t0], prompt)
            or tokens.min() < 0 or tokens.max() >= cfg.vocab):
        raise RuntimeError(f"generate returned {tuple(tokens.shape)} tokens in "
                           f"[{tokens.min().item()}, {tokens.max().item()}]")
    print(f"serving path: generate {tuple(prompt.shape)} + {n_new} -> "
          f"{tuple(tokens.shape)} tokens in range; flash_fwd launches {fwd} "
          f"(prefill, n_layers {cfg.n_layers}), flash_decode launches {dec} "
          f"(n_layers x {n_new - 1} steps)", flush=True)

    # Teacher forcing: the prefill's logits and one decode_step per
    # generated token give the logits at positions t0-1 .. length-2, which
    # the forward on the whole sequence gives too.
    ref = forward(params, tokens, cfg)
    logits, caches = prefill(params, prompt, cfg)
    steps = [logits]
    cur_len = torch.full((), t0, dtype=torch.int32, device="cuda")
    for p in range(t0, length - 1):
        steps.append(decode_step(params, caches, tokens[:, p], cur_len, cfg))
        cur_len = cur_len + 1
    got, want = torch.stack(steps, dim=1), ref[:, t0 - 1:length - 1]
    limit = LOGITS_RTOL_OF_MAX * want.abs().max().item()
    err = (got - want).abs().max().item()
    # Each greedy token is forward's argmax up to that tolerance (bf16 ties).
    chosen = want.gather(-1, tokens[:, t0:, None].long())[..., 0]
    gap = (want.amax(dim=-1) - chosen).max().item()
    if not (torch.isfinite(got).all() and err <= limit and gap <= limit):
        raise RuntimeError(f"teacher-forced decode vs forward: logits max abs err "
                           f"{err}, greedy token below forward's max by {gap} "
                           f"(limit {limit})")
    print(f"serving path: teacher-forced prefill + {length - 1 - t0} decode steps vs "
          f"forward at {length - t0} positions: logits max abs err {err:.3g}, greedy "
          f"tokens within {gap:.3g} of forward's max (limit {limit:.3g} = "
          f"{LOGITS_RTOL_OF_MAX} x max |logits|)", flush=True)

    _check_captured_loop(cfg, params, prompt, tokens, "serving path")
    return fwd, dec, tokens, ref


def _check_captured_loop(cfg, params, prompt, tokens, what) -> None:
    """generate's captured loop against generate_loop(capture=False), bit
    for bit: greedy (`tokens`, the counted run's) and seeded (a CUDA
    generator, T=1); seeded sampling reproducible per seed and different
    across seeds; torch.cuda.memory_allocated() the same after two more
    greedy calls (each call's graph and pool go with it)."""
    n_new = SERVE["N_NEW"]
    eager = generate_loop(params, prompt, cfg, n_new, capture=False)
    if not torch.equal(tokens, eager):
        raise RuntimeError(f"{what}: captured greedy tokens differ from the eager loop's at "
                           f"{int((tokens != eager).sum())} places")

    def sample(seed, captured=True):
        return generate_loop(params, prompt, cfg, n_new, torch.Generator(device="cuda").manual_seed(seed),
                             1.0, capture=captured)

    a, b, c, e = sample(1), sample(1), sample(2), sample(1, captured=False)
    if (not torch.equal(a, e) or not torch.equal(a, b) or torch.equal(a, c)
            or a.min() < 0 or a.max() >= cfg.vocab):
        raise RuntimeError(f"{what}: sampled tokens captured vs eager equal {torch.equal(a, e)}, "
                           f"reproducible {torch.equal(a, b)}, equal across seeds "
                           f"{torch.equal(a, c)}, in range {0 <= a.min() and a.max() < cfg.vocab}")
    del a, b, c, e, eager
    torch.cuda.synchronize()
    allocated = [torch.cuda.memory_allocated()]
    for _ in range(2):
        if not torch.equal(generate(params, prompt, cfg, n_new), tokens):
            raise RuntimeError(f"{what}: a repeated greedy generate gave other tokens")
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    if len(set(allocated)) != 1:
        raise RuntimeError(f"{what}: memory_allocated over repeated generate calls {allocated}")
    print(f"{what}: captured loop bit-equal to capture=False, greedy and sampled ({n_new} "
          f"tokens, T=1, a CUDA generator); sampled reproducible per seed, different across "
          f"seeds, in range; greedy reruns equal; memory_allocated {allocated[0]} B, the same "
          f"after each of two more calls", flush=True)


def phase_graph(cfg, params, tokens, ref, card) -> float:
    """Capture one greedy decode_step as a CUDA graph (a host sync inside
    the step would make the capture raise), replay it at two cache
    lengths by writing cur_len in place, and hold each replay against an
    eager step and, for a dense config, the forward (an MoE step may route
    a token otherwise than the forward, so its distance is printed only).
    Returns the replayed step's ms."""
    lens = (700, tokens.shape[1] - 8)
    _, caches = prefill(params, tokens[:, :lens[1]], cfg)
    token = tokens[:, lens[0]].clone()
    cur_len = torch.full((), lens[0], dtype=torch.int32, device="cuda")
    before = flash_decode_kernel.launches
    graph, replay, logits = capture(lambda: decode_step(params, caches, token, cur_len, cfg))
    # The eager warm-up counts its launches; the capture's are taken out,
    # and a counted replay adds them once.
    if flash_decode_kernel.launches - before != cfg.n_layers:
        raise RuntimeError(f"warm-up and capture counted {flash_decode_kernel.launches - before} "
                           f"flash_decode launches, expected the warm-up's {cfg.n_layers}")
    before = flash_decode_kernel.launches
    replay()
    if flash_decode_kernel.launches - before != cfg.n_layers:
        raise RuntimeError(f"a counted replay added {flash_decode_kernel.launches - before} "
                           f"flash_decode launches, expected n_layers = {cfg.n_layers}")
    for n in lens:
        token.copy_(tokens[:, n])
        cur_len.fill_(n)
        before = flash_decode_kernel.launches
        graph.replay()
        torch.cuda.synchronize()
        if flash_decode_kernel.launches != before:
            raise RuntimeError("graph replay went through the wrapper")
        replayed = logits.clone()
        eager = decode_step(params, caches, tokens[:, n],
                            torch.full((), n, dtype=torch.int32, device="cuda"), cfg)
        err = _check_close(f"graph replay at length {n + 1} vs eager", replayed, eager, BF16_TOL)
        limit = LOGITS_RTOL_OF_MAX * ref[:, n].abs().max().item()
        ref_err = (replayed - ref[:, n]).abs().max().item()
        if cfg.n_experts is None and not ref_err <= limit:
            raise RuntimeError(f"graph replay at length {n + 1} vs forward: max abs "
                               f"err {ref_err} (limit {limit})")
        print(f"graph{' MoE' if cfg.n_experts else ''}: one captured decode_step replayed at "
              f"length {n + 1}: vs eager max abs err {err:.3g} (bit-equal "
              f"{torch.equal(replayed, eager)}), vs forward {ref_err:.3g} (limit {limit:.3g}"
              f"{'' if cfg.n_experts is None else ', not held: routing flips'}), no wrapper "
              f"launch during replay (a counted replay adds n_layers)", flush=True)
    ms = _time_ms(graph.replay, 50)
    print(f"time{' MoE' if cfg.n_experts else ''} decode_step as a replayed CUDA graph "
          f"B{tokens.shape[0]}: {ms:.4f} ms [{card}]", flush=True)
    return ms


def phase_timings(gen, cfg, params, tokens, card) -> dict:
    """flash_fwd and the PyTorch call for the same function, device time by
    graph replay (the wrapper's host time hidden) and eagerly per call, at
    the full-width shape, the prefill's and GQA with a window; the plain
    version at the full-width shape; then the forward. Returns the
    full-width shape's numbers."""
    shapes = [  # (name, (B, H, H_kv, L, D), window)
        ("B4 H8 L2048 D128 causal", (FULL["B"], FULL["H"], FULL["H"], FULL["L"], FULL["D"]), None),
        ("prefill B4 H8 L1536 D128 causal", (SERVE["B"], FULL["H"], FULL["H"], SERVE["T0"], FULL["D"]), None),
        ("GQA B4 H8 H_kv2 L2048 D128 window 255", (FULL["B"], FULL["H"], 2, FULL["L"], FULL["D"]), 255),
    ]
    out = None
    for name, (b, h, h_kv, l, d), window in shapes:
        q = torch.randn((b, h, l, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, h_kv, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))

        def kernel():
            return flash_attention_kernel(q, k, v, causal=True, window=window)

        if window is None:
            def library():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        else:
            mask = _band_mask(l, l, window, 0, "cuda")

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        ms, library_ms = _graph_ms([kernel]), _graph_ms([library])
        eager_ms, eager_library_ms = _time_ms(kernel, 20), _time_ms(library, 20)
        bound_ms, bound_by, flops = _attention_bound_ms(b, h, l, l, d, q.element_size(),
                                                        h_kv=h_kv, window=window)
        print(f"time flash_fwd {name} bf16, device (graph-replayed): kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of bound {bound_ms:.4f} ms, "
              f"{bound_by}), sdpa {library_ms:.4f} ms; eager per call (host included): kernel "
              f"{eager_ms:.4f} ms, sdpa {eager_library_ms:.4f} ms [{card}]", flush=True)
        if out is None:
            plain_ms = _time_ms(lambda: attention_plain(q, k, v, causal=True), 5)
            print(f"time attention_plain {name} bf16: {plain_ms:.4f} ms [{card}]", flush=True)
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)
        del q, k, v
    phase_forward_timing(cfg, params, tokens, card)
    return out


def phase_bwd_timings(gen, card) -> dict:
    """Each backward kernel alone (device time from graph replays), the
    whole wrapper eagerly, the plain backward, and SDPA's backward (its
    forward + backward through autograd, minus its forward, graph-replayed
    and eagerly): one library time for the pair of kernels. At the
    full-width shape, then with GQA H_kv 2 and window 255 (SDPA with the
    band mask). Returns the full-width shape's numbers."""
    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    shapes = [  # (name, H_kv, window)
        (f"B{b} H{h} L{l} D{d} causal", h, None),
        (f"GQA B{b} H{h} H_kv2 L{l} D{d} window 255", 2, 255),
    ]
    out = None
    for shape, h_kv, window in shapes:
        q, do = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, h_kv, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        o, lse = flash_attention_kernel(q, k, v, causal=True, window=window, return_lse=True)
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        band = dict(causal=True, scale=1.0 / math.sqrt(d), window=window, softcap=None, sinks=0)
        ms = {"dq": _graph_ms([lambda: _bwd_launch("dq", q, k, v, do, lse, delta, (dq,), **band)]),
              "dkv": _graph_ms([lambda: _bwd_launch("dkv", q, k, v, do, lse, delta, (dk, dv), **band)])}
        eager_ms = _time_ms(lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=True,
                                                               window=window), 10)
        plain_ms = _time_ms(lambda: attention_bwd_plain(q, k, v, o, lse, do, causal=True, window=window),
                            3, warmup=1)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        if window is None:
            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        else:
            mask = _band_mask(l, l, window, 0, "cuda")

            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)

        def sdpa_both():
            return torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        sdpa_both_ms, sdpa_fwd_ms = _graph_ms([sdpa_both]), _graph_ms([sdpa])
        library_ms = sdpa_both_ms - sdpa_fwd_ms
        eager_library_ms = _time_ms(sdpa_both, 20) - _time_ms(sdpa, 20)
        times = {}
        for name, products, n_out in (("dq", 3, 1), ("dkv", 4, 2)):
            bound_ms, bound_by, flops = _bwd_bound_ms(b, h, h_kv, l, l, d, 2, products, n_out, window=window)
            print(f"time flash_bwd_{name} {shape} bf16, device (graph-replayed): kernel "
                  f"{ms[name]:.4f} ms ({flops / ms[name] / 1e9:.1f} TFLOP/s, {bound_ms / ms[name]:.1%} "
                  f"of bound {bound_ms:.4f} ms, {bound_by}) [{card}]", flush=True)
            times[name] = dict(ms=ms[name], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=library_ms)
        print(f"time backward {shape} bf16: dq + dk/dv {ms['dq'] + ms['dkv']:.4f} ms, wrapper "
              f"(Δ + both kernels) eager {eager_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward, "
              f"device (graph-replayed) {library_ms:.4f} ms (forward + backward {sdpa_both_ms:.4f} ms − "
              f"forward {sdpa_fwd_ms:.4f} ms), eager {eager_library_ms:.4f} ms [{card}]", flush=True)
        out = out or times
        del q, k, v, do, o, lse, delta, dq, dk, dv, qg, kg, vg
    return out


def phase_train_profile(cfg, params, tokens, card, top: int = 15) -> None:
    """The device kernels of one SGD step by torch.profiler: name, calls
    and device ms of the `top` slowest, and their sum. Printed only."""
    step = make_train_step(cfg, TRAIN["LR"])
    step(params, tokens)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        step(params, tokens)
        torch.cuda.synchronize()
    kernels = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key) for evt in prof.key_averages()
                      if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0),
                     reverse=True)
    total = sum(ms for ms, _, _ in kernels)
    print(f"profile of one{' MoE' if cfg.n_experts else ''} SGD step B{tokens.shape[0]} L{tokens.shape[1]}: "
          f"{len(kernels)} device kernels, "
          f"{total:.3f} ms of device time in all [{card}]", flush=True)
    for ms, calls, name in kernels[:top]:
        print(f"profile kernel {ms:.4f} ms, {calls} calls: {name[:140]}", flush=True)


def phase_train_timings(cfg, params, tokens, card) -> None:
    """The SGD step as make_train_step runs it, and the same step with CUDA
    events between its forward (loss_fn), backward (autograd) and update."""
    step = make_train_step(cfg, TRAIN["LR"])
    step_ms = _time_ms(lambda: step(params, tokens), 5, warmup=1)

    def split():
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(leaves, tokens, cfg)
        events[1].record()
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        events[2].record()
        sgd_update(params, tree_map(lambda _: next(grads), params), TRAIN["LR"])
        events[3].record()
        return events

    split()
    runs = [split() for _ in range(5)]
    torch.cuda.synchronize()
    fwd, bwd, upd = (sum(e[i].elapsed_time(e[i + 1]) for e in runs) / len(runs)
                     for i in range(3))
    print(f"time{' MoE' if cfg.n_experts else ''} train step B{tokens.shape[0]} L{tokens.shape[1]} "
          f"(SGD): {step_ms:.3f} ms, "
          f"{tokens.numel() / (step_ms / 1e3):.0f} tokens/s; split: forward {fwd:.3f} ms, "
          f"backward {bwd:.3f} ms, update {upd:.3f} ms [{card}]", flush=True)


def phase_decode_timings(gen, card) -> dict:
    """flash_decode, its plain version and SDPA on the cache sliced to the
    length (``enable_gqa`` for a GQA shape), at the decode bench shape, a
    GQA shape and the serving shape, with the kernel's achieved TB/s and
    share of its bound, and the device time of its two kernels (the split
    kernel, the merge) by torch.profiler; each input set cycled L2_COPIES
    times so the K/V come from device memory. Returns the serving shape's
    numbers."""
    b, d = FULL["B"], FULL["D"]
    shapes = [  # (H, H_kv, l_q, L_max, lengths)
        (FULL["H"], FULL["H"], DECODE_BENCH["L_Q"], DECODE_BENCH["L_MAX"], DECODE_BENCH["LENS"]),
        (DECODE_GQA["H"], DECODE_GQA["H_KV"], DECODE_GQA["L_Q"], DECODE_GQA["L_MAX"], (DECODE_GQA["LEN"],)),
        (FULL["H"], FULL["H"], 1, FULL["L"], (FULL["L"],)),
    ]
    out = None
    for h, h_kv, l_q, l_max, lens in shapes:
        sets = [[torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for shape in ((b, h, l_q, d), (b, h_kv, l_max, d), (b, h_kv, l_max, d))]
                for _ in range(L2_COPIES)]
        for n in lens:
            length = torch.tensor([n], dtype=torch.int32, device="cuda")
            # imported here: it pulls in torch._dynamo, seconds of import time
            # that the handoff's children, which import this script, would pay
            from torch.nn.attention.bias import causal_lower_right
            mask = causal_lower_right(l_q, n) if l_q > 1 else None
            kernel = [lambda s=s: flash_decode_kernel(*s, length) for s in sets]
            library = [lambda s=s: F.scaled_dot_product_attention(
                s[0], s[1][:, :, :n], s[2][:, :, :n], attn_mask=mask, enable_gqa=h != h_kv)
                for s in sets]
            ms = _graph_ms(kernel)
            plain_ms = _graph_ms([lambda s=s: flash_decode_plain(*s, length) for s in sets], calls=4)
            library_ms = _graph_ms(library)
            eager_ms = _time_ms(_cycle(kernel), 40)
            eager_library_ms = _time_ms(_cycle(library), 40)
            split_ms, merge_ms = _profile_ms(_cycle(kernel), 20, ("flash_decode_tc_kernel",
                                                                  "flash_decode_merge")).values()
            bound_ms, bound_by, nbytes = _decode_bound_ms(b, h, h_kv, l_q, n, d, 2)
            print(f"time flash_decode B{b} H{h} H_kv{h_kv} l_q{l_q} D{d} L_max{l_max} len {n} "
                  f"bf16, device (graph-replayed): kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s, "
                  f"{bound_ms / ms:.1%} of bound {bound_ms:.4f} ms, {bound_by}), plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms ({bound_ms / library_ms:.1%} of "
                  f"bound); eager per call (host included): kernel {eager_ms:.4f} ms, sdpa "
                  f"{eager_library_ms:.4f} ms; by torch.profiler: split kernel {split_ms:.4f} ms + "
                  f"merge {merge_ms:.4f} ms [{card}]", flush=True)
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)
        del sets
    return out


def _runs(values) -> str:
    """The median of runs, then every run: work on the host (a capture, an
    eager loop) spreads widely between runs on a shared host."""
    return f"{statistics.median(values):.3f} ms (runs {', '.join(f'{x:.3f}' for x in values)})"


def phase_serving_timings(cfg, params, prompt, graph_step_ms, card) -> None:
    """The whole greedy generate, each call by the host's clock between two
    synchronizes; prefill alone (eagerly, and its device time by graph
    replay); then generate's pieces as it runs them (``probe._decoder``,
    ``ops.graphs.capture``, the counted replays): the first step and the
    capture by the host's clock, and the replayed loop by CUDA events
    around its replays. The replayed graph of one decode_step (phase 4) is
    the step's device time, so its share of a step of the loop is how busy
    the loop keeps the card. Then the eager loop (generate_loop with
    capture=False) beside it."""
    n_new, b = SERVE["N_NEW"], prompt.shape[0]
    moe = " MoE" if cfg.n_experts else ""

    def host_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    gen = [host_ms(lambda: generate(params, prompt, cfg, n_new))[0] for _ in range(6)][1:]
    prefill_ms = _time_ms(lambda: prefill(params, prompt, cfg), 5, warmup=1)
    prefill_device_ms = _graph_ms([lambda: prefill(params, prompt, cfg)], calls=5)
    eager = [host_ms(lambda: generate_loop(params, prompt, cfg, n_new, capture=False))[0]
             for _ in range(3)]
    eager_step_ms = (statistics.median(eager) - prefill_ms) / (n_new - 1)
    first, loop, reserved, enqueue, clocks = [], [], [], [], []
    for _ in range(3):
        step, out = _decoder(params, prompt, cfg, n_new, _picker(None, None))
        # What the capture's empty_cache (torch.cuda.graph's) may free.
        reserved.append(torch.cuda.memory_reserved() / 2**30)
        ms, (_, replay, _) = host_ms(lambda: capture(step))
        first.append(ms)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        for _ in range(n_new - 2):
            replay()
        enqueue.append((time.perf_counter() - t) * 1e3)
        end.record()
        # Read while the card still runs the replays the host has queued.
        clocks.append(_card("clocks.sm,power.draw"))
        torch.cuda.synchronize()
        loop.append(start.elapsed_time(end))
        del step, out, replay
    gen_ms, loop_ms = statistics.median(gen), statistics.median(loop)
    replay_ms = loop_ms / (n_new - 2)
    decode_ms = gen_ms - prefill_ms
    print(f"time{moe} serving B{b} prompt {prompt.shape[1]} n_new {n_new}: generate "
          f"{_runs(gen)}, prefill {prefill_ms:.3f} ms (device, graph-replayed: "
          f"{prefill_device_ms:.3f} ms), decode {decode_ms:.3f} ms = "
          f"{b * (n_new - 1) / (decode_ms / 1e3):.0f} decode tokens/s over {n_new - 1} steps "
          f"(the first eager, the capture included) [{card}]", flush=True)
    print(f"time{moe} captured loop: first step + capture {_runs(first)}, the capture alone ≈ "
          f"{statistics.median(first) - eager_step_ms:.3f} ms (less an eager step; the allocator "
          f"held {', '.join(f'{x:.2f}' for x in reserved)} GiB before each); replayed "
          f"loop {_runs(loop)} by CUDA events = {replay_ms:.4f} ms per step over {n_new - 2} "
          f"replays, {b / (replay_ms / 1e3):.0f} decode tokens/s; decode_step's replayed device "
          f"time {graph_step_ms:.4f} ms = {graph_step_ms / replay_ms:.1%} of a step of the loop "
          f"(card busy); the host queued the replays in {_runs(enqueue)}; SM clock and power "
          f"during the loops: {'; '.join(clocks)} [{card}]", flush=True)
    print(f"time{moe} eager loop (capture=False): generate {_runs(eager)}, "
          f"{eager_step_ms:.4f} ms per step, {b / (eager_step_ms / 1e3):.0f} decode tokens/s, "
          f"card busy at most {graph_step_ms / eager_step_ms:.1%} [{card}]", flush=True)


def phase_moe_ffn_vs_plain(gen) -> float:
    """moe_ffn against moe_ffn_plain on x (B·L, d_model) of the MoE path,
    in bf16 and in f32: the same expert for every token, the aux within
    MOE_AUX_ATOL and the outputs within MOE_OUT_OF_MAX of their max.
    Returns the bf16 case's max abs error."""
    t, d, ff = FULL["B"] * FULL["L"], 1024, 4096
    bf16_err = None
    for dtype in (torch.bfloat16, torch.float32):
        params = init_moe_params(torch.Generator().manual_seed(0), MOE_EXPERTS, d, ff, dtype, "cuda")
        x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
        out, aux = moe_ffn(params, x)
        want, want_aux, want_idx = moe_ffn_plain(params, x)
        idx, _ = _route(params, x)
        per_expert = torch.bincount(idx, minlength=MOE_EXPERTS).tolist()
        err = (out.float() - want.float()).abs().max().item()
        limit = MOE_OUT_OF_MAX[dtype] * want.float().abs().max().item()
        aux_err = abs(aux.item() - want_aux.item())
        if not (torch.equal(idx, want_idx) and aux_err <= MOE_AUX_ATOL and err <= limit
                and torch.isfinite(out).all()):
            raise RuntimeError(f"moe_ffn vs moe_ffn_plain {dtype}: experts equal "
                               f"{torch.equal(idx, want_idx)}, aux err {aux_err} (limit "
                               f"{MOE_AUX_ATOL}), out max abs err {err} (limit {limit})")
        print(f"case moe_ffn vs moe_ffn_plain T{t} d{d} ff{ff} E{MOE_EXPERTS} {dtype}: same "
              f"expert for every token (tokens per expert {per_expert}), aux {aux.item():.6f} "
              f"err {aux_err:.3g}, out max abs err {err:.3g} (limit {limit:.3g} = "
              f"{MOE_OUT_OF_MAX[dtype]:.3g} x max |out|)", flush=True)
        bf16_err = err if bf16_err is None else bf16_err
        del params, x, out, want
    return bf16_err


def _print_blocks(what, records) -> None:
    """Print, and hold to the limits, the per-block records of
    moe_blocks_vs_plain (or of the serving check): the unflipped tokens'
    block output within LOGITS_RTOL_OF_MAX of its max, each grad within
    GRAD_RTOL_OF_MAX of its max."""
    for i, r in enumerate(records):
        limit = LOGITS_RTOL_OF_MAX * r["out_max"]
        n = r["flipped"].numel()
        line = (f"{what} block {i}: {int(r['flipped'].sum())} of {n} tokens routed to "
                f"another expert (largest top-1/top-2 gap among them {r['worst_gap']:.3g}, "
                f"limit {MOE_ROUTE_GAP}; router logits max abs diff {r['logit_err']:.3g}), "
                f"unflipped block output max abs err {r['out_err']:.3g} (limit {limit:.3g} = "
                f"{LOGITS_RTOL_OF_MAX} x max |out|)")
        bad = [] if r["out_err"] <= limit else ["output"]
        if "grads" in r:
            worst = max((err / peak if peak else math.inf, name)
                        for name, (err, peak) in r["grads"].items())
            bad += [name for name, (err, peak) in r["grads"].items()
                    if not err <= GRAD_RTOL_OF_MAX * peak]
            line += f"; grads worst {worst[1]} at {worst[0]:.3g} of its max (limit {GRAD_RTOL_OF_MAX})"
        print(line, flush=True)
        if bad:
            raise RuntimeError(f"{what} block {i}: {bad} beyond the limits: {line}")


def phase_moe_forward(cfg, params, batches) -> int:
    """The MoE forward on each batch with the counts set to 0 just before;
    then per batch the logits and NLL beside the plain-attention forward's
    (printed) and the block-by-block check (held). Returns its flash_fwd
    launches."""
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    outs = [forward(params, tokens, cfg) for tokens in batches]
    torch.cuda.synchronize()
    launches, want = flash_attention_kernel.launches, cfg.n_layers * len(batches)
    if launches != want or flash_decode_kernel.launches:
        raise RuntimeError(f"MoE forward launched flash_fwd {launches} and flash_decode "
                           f"{flash_decode_kernel.launches} times, expected {want} and 0")
    log_v = math.log(cfg.vocab)
    for i, (tokens, logits) in enumerate(zip(batches, outs)):
        nll = next_token_nll(logits, tokens).item()
        if (logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all()
                or not 0 <= nll - log_v < NLL_ABOVE_UNIFORM):
            raise RuntimeError(f"MoE batch {i}: logits {tuple(logits.shape)} finite "
                               f"{bool(torch.isfinite(logits).all())}, nll {nll} (log V {log_v})")
        plain = forward(params, tokens, cfg, attention=attention_plain)
        print(f"MoE forward batch {i}: logits {tuple(logits.shape)} finite, nll {nll:.4f} (log V "
              f"{log_v:.4f}; plain-attention forward {next_token_nll(plain, tokens).item():.4f}), "
              f"logits vs plain-attention forward max abs err {(logits - plain).abs().max().item():.3g} "
              f"({LOGITS_RTOL_OF_MAX} x max |logits| = "
              f"{LOGITS_RTOL_OF_MAX * plain.abs().max().item():.3g}; not held: routing flips)",
              flush=True)
        del plain
        _print_blocks(f"MoE forward batch {i}", moe_blocks_vs_plain(params, tokens, cfg))
    print(f"MoE forward: flash_fwd launches {launches} (n_layers {cfg.n_layers} x batches "
          f"{len(batches)})", flush=True)
    return launches


def phase_moe_train(cfg, params, batches) -> tuple[int, int, int]:
    """SGD steps of the MoE config with the counts set to 0 just before and
    read just after; the aux term in the loss; one batch's grads block by
    block (and whole-model, printed); then moe_check(). Returns the
    (flash_fwd, dq, dk/dv) launches."""
    step = make_train_step(cfg, TRAIN["LR"])
    bwd = flash_attention_bwd_kernel
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    bwd.dq_launches = bwd.dkv_launches = 0
    p, losses = params, []
    for tokens in batches:
        p, loss = step(p, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = (flash_attention_kernel.launches, bwd.dq_launches, bwd.dkv_launches)
    want = cfg.n_layers * len(batches)
    if counts != (want,) * 3 or flash_decode_kernel.launches:
        raise RuntimeError(f"MoE train steps launched flash_fwd / dq / dk/dv {counts} and "
                           f"flash_decode {flash_decode_kernel.launches} times, expected {want} "
                           f"each and 0")
    log_v = math.log(cfg.vocab)
    losses = [loss.item() for loss in losses]
    if not all(0 <= x - log_v < NLL_ABOVE_UNIFORM for x in losses):
        raise RuntimeError(f"MoE train losses {losses} not within {NLL_ABOVE_UNIFORM} above "
                           f"log(vocab) = {log_v}")
    if not all(torch.isfinite(t).all() for t in tree_leaves(p)):
        raise RuntimeError("MoE params after the train steps are not finite")
    routers = {t.dtype for blk in p["blocks"] for key, t in blk.items() if key == "router"}
    if routers != {torch.float32}:
        raise RuntimeError(f"MoE routers after the SGD steps are {routers}, not float32")
    print(f"MoE training: {len(batches)} SGD steps (lr {TRAIN['LR']}) on "
          f"{tuple(batches[0].shape)} tokens, losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"(log V {log_v:.4f}); launches flash_fwd {counts[0]}, dq {counts[1]}, dk/dv "
          f"{counts[2]} (n_layers {cfg.n_layers} x {len(batches)} steps each); routers float32",
          flush=True)

    # The aux term: loss_fn − the nll of the same forward's logits.
    tokens = batches[0]
    with torch.no_grad():
        logits, aux = _forward_impl(params, tokens, cfg, flash_attention)
        nll = next_token_nll(logits, tokens).item()
        loss = loss_fn(params, tokens, cfg).item()
    term = loss - nll
    if not (0.5 < aux.item() < 2 and abs(term - cfg.moe_aux_weight * aux.item()) <= 1e-5):
        raise RuntimeError(f"MoE loss {loss} − nll {nll} = {term}, expected moe_aux_weight "
                           f"{cfg.moe_aux_weight} x aux {aux.item()}")
    print(f"MoE training: loss_fn {loss:.6f} − next_token_nll {nll:.6f} = {term:.6g} = "
          f"{cfg.moe_aux_weight} x aux {aux.item():.6f} (mean over the layers)", flush=True)

    _, grads = loss_and_grads(params, tokens, cfg)
    _, plain = loss_and_grads(params, tokens, cfg, attention=attention_plain)
    worst = max(((g.float() - w.float()).abs().max().item() / w.float().abs().max().item(), name)
                for name, g, w in zip(tree_names(params), tree_leaves(grads), tree_leaves(plain)))
    print(f"MoE training: whole-model grads through the kernels vs plain attention, worst "
          f"leaf {worst[1]} at {worst[0]:.3g} of its max |grad| ({GRAD_RTOL_OF_MAX} held "
          f"block by block below: routing flips)", flush=True)
    del grads, plain
    _print_blocks("MoE training grads", moe_blocks_vs_plain(params, tokens, cfg, grads=True))
    result = moe_check()
    print(f"moe_check(): MoE flagship at d_head 32, loss {result['loss']:.4f}, block grads vs "
          f"plain max abs err {result['max_grad_err']:.3g} (limit 5e-3), flipped tokens per "
          f"layer {result['flipped']}; make_moe_step losses "
          f"{', '.join(f'{x:.6f}' for x in result['moe_step_losses'])}", flush=True)
    return counts


def _serving_blocks_vs_forward(cfg, params, tokens, t0) -> list[dict]:
    """Each block as the serving path runs it (the prefill's block on the
    first t0 positions, then one decode block a position against the
    cache) against the forward's block, at positions t0 − 1 .. T − 2, both
    on the forward's input to that layer, so a routing flip changes only
    its own position."""
    b, length = tokens.shape
    x, records = _embed(params, tokens, cfg), []
    for blk in params["blocks"]:
        xa_fwd = _attend(x, blk, cfg, flash_attention)[0]
        xa_pre, k, v = _attend(x[:, :t0], blk, cfg, flash_attention)
        shape = (b, cfg.kv_heads, cfg.max_len, cfg.d_head)
        kc, vc = (torch.zeros(shape, dtype=k.dtype, device="cuda") for _ in range(2))
        kc[:, :, :t0], vc[:, :, :t0] = k, v
        rows = [xa_pre[:, -1:]]
        for pos in range(t0, length - 1):
            cur_len = torch.full((), pos + 1, dtype=torch.int32, device="cuda")
            rows.append(_attend_decode(x[:, pos:pos + 1], blk, cfg, kc, vc, cur_len))
        xa_srv, xa_ref = torch.cat(rows, dim=1), xa_fwd[:, t0 - 1:length - 1]
        record = route_flips(xa_srv, xa_ref, blk)
        out_srv, out_ref = _finish_block(xa_srv, blk)[0], _finish_block(xa_ref, blk)[0]
        record.update(out_err=_masked_err(out_srv, out_ref, ~record["flipped"]),
                      out_max=out_ref.float().abs().max().item())
        records.append(record)
        x = _finish_block(xa_fwd, blk)[0]
    return records


@torch.no_grad()
def phase_moe_serving(cfg, params, prompt) -> tuple[int, int, torch.Tensor, torch.Tensor]:
    """Greedy generate of the MoE config with the counts set to 0 just
    before; the teacher-forced logits and NLL beside the forward's
    (printed; the NLL range held), the serving blocks against the
    forward's (held), seeded sampling. Returns (flash_fwd launches,
    flash_decode launches, tokens, forward's logits on the tokens)."""
    t0, n_new = prompt.shape[1], SERVE["N_NEW"]
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    tokens = generate(params, prompt, cfg, n_new)
    torch.cuda.synchronize()
    fwd, dec = flash_attention_kernel.launches, flash_decode_kernel.launches
    if (fwd, dec) != (cfg.n_layers, cfg.n_layers * (n_new - 1)):
        raise RuntimeError(f"MoE generate launched flash_fwd {fwd} and flash_decode {dec} "
                           f"times, expected {cfg.n_layers} and {cfg.n_layers * (n_new - 1)}")
    length = t0 + n_new
    if (tokens.shape != (prompt.shape[0], length) or not torch.equal(tokens[:, :t0], prompt)
            or tokens.min() < 0 or tokens.max() >= cfg.vocab):
        raise RuntimeError(f"MoE generate returned {tuple(tokens.shape)} tokens in "
                           f"[{tokens.min().item()}, {tokens.max().item()}]")
    print(f"MoE serving: generate {tuple(prompt.shape)} + {n_new} -> {tuple(tokens.shape)} "
          f"tokens in range; flash_fwd launches {fwd} (prefill), flash_decode launches {dec} "
          f"(n_layers x {n_new - 1} steps)", flush=True)

    ref = forward(params, tokens, cfg)
    logits, caches = prefill(params, prompt, cfg)
    steps = [logits]
    cur_len = torch.full((), t0, dtype=torch.int32, device="cuda")
    for pos in range(t0, length - 1):
        steps.append(decode_step(params, caches, tokens[:, pos], cur_len, cfg))
        cur_len = cur_len + 1
    got, want = torch.stack(steps, dim=1), ref[:, t0 - 1:length - 1]
    log_v = math.log(cfg.vocab)
    nll, nll_ref = (-torch.log_softmax(a, dim=-1).gather(-1, tokens[:, t0:, None].long()).mean().item()
                    for a in (got, want))
    limit = LOGITS_RTOL_OF_MAX * want.abs().max().item()
    chosen = want.gather(-1, tokens[:, t0:, None].long())[..., 0]
    off = int(((want.amax(dim=-1) - chosen) > limit).sum())
    if not (torch.isfinite(got).all() and abs(nll - nll_ref) <= MOE_SERVE_NLL_ATOL):
        raise RuntimeError(f"MoE teacher-forced decode: logits finite "
                           f"{bool(torch.isfinite(got).all())}, nll {nll} vs the forward's "
                           f"{nll_ref} (limit {MOE_SERVE_NLL_ATOL})")
    print(f"MoE serving: teacher-forced prefill + {length - 1 - t0} decode steps vs forward at "
          f"{length - t0} positions: logits max abs err {(got - want).abs().max().item():.3g} "
          f"({LOGITS_RTOL_OF_MAX} x max |logits| = {limit:.3g}; not held: routing flips), nll "
          f"{nll:.4f} vs forward's {nll_ref:.4f} (limit {MOE_SERVE_NLL_ATOL}; log V "
          f"{log_v:.4f}); {off} of "
          f"{chosen.numel()} greedy tokens below forward's max by more than that", flush=True)
    _print_blocks("MoE serving", _serving_blocks_vs_forward(cfg, params, tokens, t0))

    _check_captured_loop(cfg, params, prompt, tokens, "MoE serving")
    return fwd, dec, tokens, ref


# --- phase 6: the tenant's hot-mount side (torchside): the handoff ---

# The handoff's training: full-width batches of B 4 x L 2048 (numpy seeds
# SEED + step), AdamW (lr 1e-3, weight decay 1e-4), STEPS steps before the
# handoff and STEPS in the new image, then a greedy generate of PROMPTS
# prompts of T0 tokens + N_NEW; RUNS handoffs each, dense and MoE.
HANDOFF = dict(B=4, L=2048, STEPS=3, RUNS=3, PROMPTS=2, T0=64, N_NEW=32, SEED=100)
HANDOFF_ADAMW = dict(lr=1e-3, weight_decay=1e-4)
HANDOFF_PARTS = ("pack", "save", "exec_to_cuda_ready", "load", "restore", "optimizer_load",
                 "first_step", "tenant_side")


def _kernel_counts() -> dict:
    return {**kernel_launches(), "flash_decode": flash_decode_kernel.launches}


def _reset_kernel_counts() -> None:
    reset_kernel_launches()
    flash_decode_kernel.launches = 0


def _handoff_batch(cfg, step: int) -> torch.Tensor:
    rng = np.random.default_rng(HANDOFF["SEED"] + step)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (HANDOFF["B"], HANDOFF["L"]))).cuda()


def _handoff_prompt(cfg) -> torch.Tensor:
    rng = np.random.default_rng(HANDOFF["SEED"] - 1)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (HANDOFF["PROMPTS"], HANDOFF["T0"]))).cuda()


def _adamw_step(cfg):
    return make_train_step_optim(cfg, lambda ps: torch.optim.AdamW(ps, **HANDOFF_ADAMW))


def _expected_counts(cfg, steps: int, generate_calls: int) -> dict:
    """Launches of `steps` train steps and `generate_calls` greedy generates."""
    n = cfg.n_layers
    return {"flash_fwd": n * (steps + generate_calls), "dq": n * steps, "dkv": n * steps,
            "flash_decode": n * (HANDOFF["N_NEW"] - 1) * generate_calls}


def _check_counts(what, got, want) -> None:
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def _child_argv(spec: dict) -> list[str]:
    return [os.path.abspath(__file__), "--handoff-child", json.dumps(spec)]


def _handoff_child(spec: dict) -> None:
    """The tenant programs of phase 6, one stage per process image:

    enumerate (started with CUDA_VISIBLE_DEVICES=""): CUDA's count is 0 and
        stays 0 after set_visibility_env, torch.cuda.init() and
        refresh_devices() raise; hands off the full-width dense params,
        made on the CPU, to an image that sees the device;
    enumerated: wait_for_gpus(1), restore on cuda:0, one AdamW step;
    train: STEPS AdamW steps at full width, pack, hand off;
    resumed: wait_for_gpus(1), load, restore, STEPS more steps, generate;
        saves params, losses and tokens for the smoke to hold bit for bit
        against its own uninterrupted run, and prints its timings.

    Each prints one JSON line; any failure raises (exit code 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    stage, ckpt = spec["stage"], spec["ckpt"]
    cfg = full_width_config(spec.get("n_experts"))
    init_fn, step_fn = _adamw_step(cfg)
    if stage == "enumerate":
        report = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "device_count": torch.cuda.device_count(),
                  "is_available": torch.cuda.is_available()}
        # is_available() read CUDA's own count: the enumeration is fixed now.
        set_visibility_env(visible_devices=spec["visible"])
        report["after_set_visibility_env"] = {
            "device_count": torch.cuda.device_count(),
            "is_available": torch.cuda.is_available()}
        for name, call in (("cuda_init", torch.cuda.init), ("refresh_devices", refresh_devices)):
            try:
                call()
            except RuntimeError as err:
                report[name] = f"raised: {err}"
            else:
                raise RuntimeError(f"{name}() worked in a process that enumerated no device")
        if (report["device_count"], report["is_available"],
                report["after_set_visibility_env"]["is_available"]) != (0, False, False):
            raise RuntimeError(f"enumeration not fixed at init: {report}")
        print(json.dumps({"enumerate": report}))
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        handoff(HotResumable.pack(params), ckpt, argv=_child_argv({**spec, "stage": "enumerated"}))
    elif stage == "enumerated":
        wait = wait_for_gpus(1, timeout_s=60.0)
        if wait["device_count"] != 1 or torch.cuda.device_count() != 1:
            raise RuntimeError(f"the new image sees {torch.cuda.device_count()} device(s), "
                               f"wait_for_gpus {wait}")
        (params,) = HotResumable.load(ckpt).restore("cuda")
        _reset_kernel_counts()
        params, opt, loss = step_fn(params, init_fn(params), _handoff_batch(cfg, 0))
        loss = loss.item()
        if not math.isfinite(loss):
            raise RuntimeError(f"the new image's step gave loss {loss}")
        print(json.dumps({"enumerated": {
            "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "wait_for_gpus": wait, "device": torch.cuda.get_device_name(0),
            "param_device": str(params["embed"].device), "loss": loss,
            "launches": _kernel_counts()}}))
    elif stage == "train":
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        opt, losses = init_fn(params), []
        _reset_kernel_counts()
        for step in range(HANDOFF["STEPS"]):
            params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, step))
            losses.append(loss)
        torch.cuda.synchronize()
        launches = _kernel_counts()
        t_pack = time.time()
        state = HotResumable.pack(params, optimizer_state_tree(opt), torch.stack(losses))
        t_packed = time.time()
        nbytes = sum(t.nbytes for t in _leaves(state.host_state))
        handoff(state, ckpt, argv=_child_argv({
            **spec, "stage": "resumed", "launches_before": launches, "pack_at": t_pack,
            "packed_at": t_packed, "bytes": nbytes}))
    elif stage == "resumed":
        t_exec, t_main = float(os.environ[HANDOFF_AT_ENV]), time.time()
        fds = _device_fds()  # the old image's device files, if exec kept any
        wait = wait_for_gpus(1, timeout_s=60.0)
        torch.cuda.init()
        fa._library(0), fa._bwd_library(0), fd._library(0)
        torch.cuda.synchronize()
        t_ready = time.time()
        state = HotResumable.load(ckpt)
        t_load = time.time()
        params, tree, losses = state.restore("cuda")
        torch.cuda.synchronize()
        t_restore = time.time()
        opt = init_fn(params)
        load_optimizer_state(opt, tree)
        t_opt = time.time()
        _reset_kernel_counts()
        params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, HANDOFF["STEPS"]))
        torch.cuda.synchronize()
        t_step = time.time()
        more = [loss]
        for step in range(HANDOFF["STEPS"] + 1, 2 * HANDOFF["STEPS"]):
            params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, step))
            more.append(loss)
        torch.cuda.synchronize()
        steady_ms = (time.time() - t_step) * 1e3 / (HANDOFF["STEPS"] - 1)
        tokens = generate(params, _handoff_prompt(cfg), cfg, HANDOFF["N_NEW"])
        torch.cuda.synchronize()
        launches = _kernel_counts()
        HotResumable.pack({"params": params, "losses": torch.cat([losses, torch.stack(more)]),
                           "tokens": tokens}).save(spec["out"])
        pack_at, packed_at = spec["pack_at"], spec["packed_at"]
        ms = {"pack": packed_at - pack_at, "save": t_exec - packed_at,
              "exec_to_cuda_ready": t_ready - t_exec, "load": t_load - t_ready,
              "restore": t_restore - t_load, "optimizer_load": t_opt - t_restore,
              "first_step": t_step - t_opt,
              "tenant_side": t_step - pack_at, "exec_to_main": t_main - t_exec,
              "wait_for_gpus": wait["total_ms"] / 1e3}
        print(json.dumps({"resumed": {
            "ms": {k: v * 1e3 for k, v in ms.items()}, "bytes": spec["bytes"],
            "steady_step_ms": steady_ms, "wait_for_gpus": wait,
            "launches_before": spec["launches_before"], "launches_after": launches,
            "device_fds_at_start": fds}}))
    else:
        raise RuntimeError(f"unknown handoff stage {stage!r}")


def _device_fds() -> int:
    """Open descriptors of this process on /dev/nvidia* files."""
    count = 0
    for name in os.listdir("/proc/self/fd"):
        try:
            count += os.readlink(f"/proc/self/fd/{name}").startswith("/dev/nvidia")
        except OSError:
            pass
    return count


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [] if tree is None else [tree]


def _run_child(spec: dict, env: dict | None = None) -> dict:
    """Run one handoff child to its end (both images); returns its JSON
    lines merged. Fails on a non-zero exit or on a missing line."""
    out = subprocess.run([sys.executable, *_child_argv(spec)], capture_output=True, text=True,
                         timeout=600, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"handoff child {spec['stage']} exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    report = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            report.update(json.loads(line))
    return report


def _filesystem(path: str) -> str:
    """The type of the filesystem that holds `path` (/proc/self/mounts)."""
    path, best = os.path.realpath(path), ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) and len(mount) > len(best[0]):
                best = (mount, fstype)
    return best[1]


def _uninterrupted(cfg) -> tuple[dict, torch.Tensor, torch.Tensor, dict]:
    """The handoff's 2 x STEPS steps and its generate in this process,
    without a handoff: (params, losses, tokens, launches)."""
    init_fn, step_fn = _adamw_step(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    opt, losses = init_fn(params), []
    _reset_kernel_counts()
    for step in range(2 * HANDOFF["STEPS"]):
        params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, step))
        losses.append(loss)
    tokens = generate(params, _handoff_prompt(cfg), cfg, HANDOFF["N_NEW"])
    torch.cuda.synchronize()
    return params, torch.stack(losses), tokens, _kernel_counts()


def _bit_equal(what, got, want) -> None:
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else None
        raise RuntimeError(f"{what}: not bit-equal to the uninterrupted run "
                           f"({got.dtype} {tuple(got.shape)} vs {want.dtype} "
                           f"{tuple(want.shape)}, max abs diff {diff})")


def phase_handoff(card: str) -> dict:
    """Phase 6: a. CUDA enumeration fixed at init, and the 0 -> 1 hot-add by
    handoff; b, c. RUNS handoffs of the full-width dense and MoE trainers,
    held bit for bit against this process's uninterrupted run, and the
    median time of each part. Returns the launches on this phase's path
    (the children's and the uninterrupted runs')."""
    total = dict.fromkeys(("flash_fwd", "dq", "dkv", "flash_decode"), 0)

    def add(counts):
        for key in total:
            total[key] += counts[key]

    root = tempfile.mkdtemp(prefix="handoff-")
    try:
        fs = _filesystem(root)
        print(f"handoff: checkpoints under {root} ({fs}) [{card}]", flush=True)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES") or "0"
        hidden = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        report = _run_child({"stage": "enumerate", "ckpt": os.path.join(root, "enum"),
                             "visible": visible}, env=hidden)
        first, new = report["enumerate"], report["enumerated"]
        _check_counts("handoff a: the new image's step", new["launches"],
                      _expected_counts(full_width_config(), 1, 0))
        if new["wait_for_gpus"]["device_count"] != 1 or new["param_device"] != "cuda:0":
            raise RuntimeError(f"handoff a: the new image {new}")
        add(new["launches"])
        print(f"handoff a (enumeration fixed at init): a process started with "
              f"CUDA_VISIBLE_DEVICES='' reads torch.cuda.device_count() {first['device_count']}, "
              f"is_available() {first['is_available']}; after set_visibility_env("
              f"visible_devices={visible!r}) torch.cuda.device_count() reads "
              f"{first['after_set_visibility_env']['device_count']} (NVML, from the environment) "
              f"but is_available() {first['after_set_visibility_env']['is_available']}, "
              f"torch.cuda.init() {first['cuda_init']!r}, refresh_devices() "
              f"{first['refresh_devices']!r}", flush=True)
        print(f"handoff a (0 -> 1 by handoff): the new image (CUDA_VISIBLE_DEVICES="
              f"{new['CUDA_VISIBLE_DEVICES']!r}) wait_for_gpus(1) {new['wait_for_gpus']}, "
              f"restored the full-width dense params onto {new['param_device']} "
              f"({new['device']}), one AdamW step loss {new['loss']:.4f}, launches "
              f"{new['launches']} [{card}]", flush=True)

        for name, n_experts in (("dense", None), ("MoE", MOE_EXPERTS)):
            cfg = full_width_config(n_experts)
            params, losses, tokens, launches = _uninterrupted(cfg)
            _check_counts(f"handoff {name}: the uninterrupted run", launches,
                          _expected_counts(cfg, 2 * HANDOFF["STEPS"], 1))
            add(launches)
            leaves = tree_leaves(params)
            n_params = sum(t.numel() for t in leaves)
            runs = []
            for run in range(HANDOFF["RUNS"]):
                spec = {"stage": "train", "n_experts": n_experts,
                        "ckpt": os.path.join(root, f"{name}-{run}"),
                        "out": os.path.join(root, f"{name}-{run}-out")}
                got = _run_child(spec)["resumed"]
                _check_counts(f"handoff {name}: the first image", got["launches_before"],
                              _expected_counts(cfg, HANDOFF["STEPS"], 0))
                _check_counts(f"handoff {name}: the new image", got["launches_after"],
                              _expected_counts(cfg, HANDOFF["STEPS"], 1))
                add(got["launches_before"])
                add(got["launches_after"])
                (out,) = HotResumable.load(spec["out"]).restore("cuda")
                _bit_equal(f"handoff {name} run {run}: losses", out["losses"], losses)
                _bit_equal(f"handoff {name} run {run}: tokens", out["tokens"], tokens)
                for i, (g, w) in enumerate(zip(tree_leaves(out["params"]), leaves, strict=True)):
                    _bit_equal(f"handoff {name} run {run}: param leaf {i}", g, w.detach())
                del out
                shutil.rmtree(spec["ckpt"])
                shutil.rmtree(spec["out"])
                runs.append(got)
            state_mb = runs[0]["bytes"] / 1e6
            print(f"handoff {name}: {n_params / 1e6:.1f}M params, state {state_mb:.1f} MB "
                  f"(params + AdamW moments, bf16{', f32 routers' if n_experts else ''}); "
                  f"{HANDOFF['RUNS']} runs, each 2 x {HANDOFF['STEPS']} AdamW steps on "
                  f"{HANDOFF['B']} x {HANDOFF['L']} and a greedy generate of "
                  f"{HANDOFF['PROMPTS']} x {HANDOFF['T0']} + {HANDOFF['N_NEW']}: losses "
                  f"{', '.join(f'{x:.4f}' for x in losses.tolist())}, the final params and "
                  f"the tokens bit-equal to the uninterrupted run in every run; launches "
                  f"a run: first image {runs[0]['launches_before']}, new image "
                  f"{runs[0]['launches_after']}; /dev/nvidia* descriptors open in the new "
                  f"image before it touched CUDA: {[r['device_fds_at_start'] for r in runs]}",
                  flush=True)
            for part in HANDOFF_PARTS + ("exec_to_main", "wait_for_gpus"):
                note = ""
                if part == "save":
                    rates = [r["bytes"] / r["ms"]["save"] / 1e6 for r in runs]
                    note = f", {statistics.median(rates):.3f} GB/s with the fsyncs"
                print(f"time handoff {name} {part}: {_runs([r['ms'][part] for r in runs])}"
                      f"{note} [{card}; checkpoint on {fs}]", flush=True)
            print(f"time handoff {name} steady step in the new image: "
                  f"{_runs([r['steady_step_ms'] for r in runs])} [{card}]", flush=True)
            del params, leaves
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


# --- phase 7: dp x tp and expert parallelism, 4 ranks sharing the card ---


def _one_process_step(cfg, params, tokens, device) -> tuple:
    """The one-process make_train_step on this rank's device: (new params,
    loss)."""
    new, loss = make_train_step(cfg, TRAIN["LR"])(
        tree_map(lambda t: t.to(device), params), tokens.to(device))
    return new, loss.item()


def _against_one_process(what, mesh, one_process, new_full, loss, loss_atol) -> dict:
    """Rank 0: new_full (whole params) and loss against the one-process
    step's (new params, loss) (``entry.against_one_process``)."""
    if mesh.rank != 0:
        return {}
    return against_one_process(what, new_full, loss, *one_process, loss_atol)


def _timed_ms(fn, runs: int) -> list[float]:
    """Host ms of `runs` calls of fn() on this rank, each from a barrier of
    every rank to its end, synchronized."""
    times = []
    for _ in range(runs):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _sharded_vs_one_process(name, cfg, mesh, params, tokens, new_local, loss) -> dict:
    """Rank 0: the one-process step on the same card, weights and tokens,
    against the sharded step's gathered new params (every rank gathers)."""
    gathered = gather_params(new_local, mesh, cfg)
    one = _one_process_step(cfg, params, tokens, mesh.device) if mesh.rank == 0 else None
    return _against_one_process(f"sharded {name} step", mesh, one, gathered, loss,
                                ONE_PROCESS_LOSS_ATOL[name])


def _sharded_grads_vs_plain(cfg, mesh, local, tokens) -> tuple[float, str]:
    """Each rank's shards of the grads through the kernels against those
    through the plain attention on the mesh, as a share of each leaf's max
    |grad| (GRAD_RTOL_OF_MAX, phase 3's limit), the kernels on this rank's
    H/tp q and H_kv/tp kv heads; returns the worst."""
    heads = []

    def recording(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return flash_attention(q, k, v, **kw)

    _, grads = loss_and_grads(local, tokens, cfg, attention=recording, mesh=mesh)
    _, plain = loss_and_grads(local, tokens, cfg, attention=attention_plain, mesh=mesh)
    if heads != [local_heads(cfg, mesh)] * cfg.n_layers:
        raise RuntimeError(f"rank {mesh.rank}: attention ran on (q, kv) heads {heads}")
    worst = (0.0, "")
    for leaf, g, w in zip(tree_names(local), tree_leaves(grads), tree_leaves(plain)):
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        if not (torch.isfinite(g).all() and share <= GRAD_RTOL_OF_MAX):
            raise RuntimeError(f"rank {mesh.rank}: sharded grads of {leaf} differ from the "
                               f"plain attention's by {share} of max |grad| > {GRAD_RTOL_OF_MAX}")
        worst = max(worst, (share, leaf))
    return worst


def _sharded_times(cfg, mesh, local, tokens) -> dict:
    """ms of TIMED sharded SGD steps on this rank (host clock from a
    barrier to the step's end, synchronized), of one gloo all-reduce of an
    activation over "model" (the payload of each f and g), and of the
    step's gradient sums over "data" (one all-reduce a leaf of this rank's
    shards)."""
    step = make_train_step(cfg, TRAIN["LR"], mesh)
    step(local, tokens)  # warm-up
    steps = _timed_ms(lambda: step(local, tokens), SHARDED["TIMED"])
    act = torch.ones((tokens.shape[0] // mesh.size("data"), tokens.shape[1], cfg.d_model),
                     dtype=cfg.dtype, device=mesh.device)
    reduces = _timed_ms(lambda: all_reduce(act, mesh, "model"), 5)
    grads = [t.clone() for t in tree_leaves(local)]
    sums = _timed_ms(lambda: [all_reduce(g, mesh, "data") for g in grads], SHARDED["TIMED"])
    return {"step_ms": steps, "all_reduce_ms": reduces, "all_reduce_bytes": act.nbytes,
            "grad_sums_ms": sums, "grad_bytes": sum(g.nbytes for g in grads)}


def _sharded_rank() -> dict:
    """One rank of phase 7; returns numbers and no tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(SHARDED["SHAPE"], device="cuda")
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(mesh.device),
           "dialect": tp_checks(mesh)}
    # The dialect's two sharded steps (dense, MoE) are on the main path.
    launches = {k: v + out["dialect"]["moe_launches"][k]
                for k, v in out["dialect"]["launches"].items()}
    for name, n_experts in (("dense", None), ("MoE", MOE_EXPERTS)):
        cfg = full_width_config(n_experts)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(SHARDED["SEED"]).integers(
            0, cfg.vocab, (TRAIN["B"], TRAIN["L"])))
        result = sharded_step_check(cfg, mesh, params, tokens, TRAIN["LR"])
        for k, v in result["launches"].items():
            launches[k] += v
        record = {"loss": result["loss"], "launches": result["launches"],
                  "collectives": result["collectives"],
                  **_sharded_vs_one_process(name, cfg, mesh, params, tokens,
                                            result["local"], result["loss"])}
        del result
        local = shard_params(params, mesh, cfg)
        if n_experts is None:
            record["grads_vs_plain"] = _sharded_grads_vs_plain(cfg, mesh, local, tokens)
        record["times"] = _sharded_times(cfg, mesh, local, tokens)
        out[name] = record
        del local
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def phase_sharded(card: str) -> dict:
    """Phase 7 (see the module's docstring): starts the 4 ranks once,
    checks what they report, and returns the training kernels' launches
    on its main path (every rank's sharded steps)."""
    torch.cuda.empty_cache()  # this process's cache, for the ranks' sake
    world = SHARDED["SHAPE"][0] * SHARDED["SHAPE"][1]
    t0 = time.perf_counter()
    ranks = run_ranks(_sharded_rank, world, backend=SHARDED["BACKEND"], timeout_s=900.0)
    label = (f"{world} ranks sharing one H100 over {SHARDED['BACKEND']}, not a {world}-GPU "
             f"figure; mesh {SHARDED['SHAPE']} (data, model) [{card}]")
    print(f"sharded: {world} ranks on a {SHARDED['SHAPE']} (data, model) mesh, one process "
          f"each, all on {ranks[0]['device']}, over {SHARDED['BACKEND']} (NCCL refuses two "
          f"ranks on one device; gloo's all-reduce takes CUDA tensors by way of the host); "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start", flush=True)
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    for r in ranks:
        d = r["dialect"]
        print(f"sharded rank {r['rank']} {r['coords']}: train_check's dialect: loss "
              f"{d['loss']:.4f}, grads through the kernels vs the plain attention on the mesh "
              f"max abs err {d['max_grad_err']:.3g} (limit 5e-3), attention on (q, kv) heads "
              f"{d['heads']}, launches a step {d['launches']}, collectives {d['collectives']}; "
              f"MoE flagship loss {d['moe_loss']:.4f}, collectives {d['moe_collectives']}; "
              f"make_moe_step over (data, expert) losses "
              f"{', '.join(f'{x:.4f}' for x in d['moe_step_losses'])}", flush=True)
        for name in ("dense", "MoE"):
            rec = r[name]
            line = (f"sharded rank {r['rank']} full-width {name} SGD step: loss "
                    f"{rec['loss']:.4f}, launches {rec['launches']} (n_layers each), "
                    f"collectives {rec['collectives']}")
            if "loss_one_process" in rec:
                line += (f"; the one-process step on the card: loss "
                         f"{rec['loss_one_process']:.4f} (|diff| {rec['loss_err']:.3g}, limit "
                         f"{ONE_PROCESS_LOSS_ATOL[name]}), gathered params worst "
                         f"{rec['worst_param'][1]} at {rec['worst_param'][0]:.3g} of its max "
                         f"|value| (limit {SHARDED_PARAM_OF_MAX:.3g})")
            if "grads_vs_plain" in rec:
                share, leaf = rec["grads_vs_plain"]
                line += (f"; grads vs the plain attention on the mesh, worst {leaf} at "
                         f"{share:.3g} of its max |grad| (limit {GRAD_RTOL_OF_MAX}), the "
                         f"kernels on {full_width_config().n_heads // SHARDED['SHAPE'][1]} of "
                         f"{full_width_config().n_heads} heads")
            print(line, flush=True)
            t = rec["times"]
            print(f"time sharded {name} SGD step, rank {r['rank']}: {_runs(t['step_ms'])}; "
                  f"one gloo all-reduce of {t['all_reduce_bytes'] / 1e6:.1f} MB over model "
                  f"(8 a step): {_runs(t['all_reduce_ms'])}; the gradient sums over data "
                  f"({t['grad_bytes'] / 1e6:.1f} MB in one all-reduce a leaf): "
                  f"{_runs(t['grad_sums_ms'])} [{label}]", flush=True)
        for k in total:
            total[k] += r["launches"][k]
    for name in ("dense", "MoE"):
        if len({r[name]["loss"] for r in ranks}) != 1:
            raise RuntimeError(f"sharded {name}: the ranks' losses differ: "
                               f"{[r[name]['loss'] for r in ranks]}")
    print(f"sharded: launches on its main path (every rank's sharded steps): {total}",
          flush=True)
    return total


# --- phase 8: sequence and pipeline parallelism, 4 ranks sharing the card ---


def _kernel_counts_of(fn) -> tuple:
    """(fn()'s value, the training kernels' launches in it), the counts set
    to 0 just before and read just after."""
    reset_kernel_launches()
    value = fn()
    torch.cuda.synchronize()
    return value, kernel_launches()


def _grads_within(what, got, want, limit) -> float:
    """The worst of |got − want| over max |want|, tensor by tensor; raises
    beyond `limit` or where got is not finite."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        if not (torch.isfinite(g).all() and share <= limit):
            raise RuntimeError(f"{what}: {share} of max |grad| > {limit}")
        worst = max(worst, share)
    return worst


def _ring_vs_one_process(mesh) -> dict:
    """Ring attention over the mesh's seq axis at the full-width chunk
    shapes (B4 H8 L2048 D128 bf16, a chunk of L/n a rank) against
    flash_attention over the whole sequence on this rank: the output
    within BF16_TOL, dq, dk, dv of sum(out · do) within GRAD_RTOL_OF_MAX
    of each one's max |grad| (phase 3's limit); the launches of the
    rank's ring (c + 1 each at seq coordinate c); the times of the ring
    forward and backward, of one shift of its k and v chunks, and of one
    flash_attention call over the whole sequence, forward and backward."""
    gen = torch.Generator().manual_seed(SEQ_PIPE["SEED"])
    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    full = [torch.randn((b, h, l, d), generator=gen).to(mesh.device, torch.bfloat16)
            for _ in range(4)]
    q, k, v, do = (shard_qkv(t, mesh) for t in full)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out, fwd_launches = _kernel_counts_of(lambda: ring_attention(*leaves, mesh))
    grads, bwd_launches = _kernel_counts_of(lambda: torch.autograd.grad(out, leaves, do))
    whole = [t.clone().requires_grad_() for t in full[:3]]
    want = flash_attention(*whole, causal=True)
    want_grads = [shard_qkv(g, mesh) for g in torch.autograd.grad(want, whole, full[3])]
    err = _check_close(f"rank {mesh.rank}: ring attention vs flash_attention over the "
                       f"whole sequence", out, shard_qkv(want.detach(), mesh), BF16_TOL)
    grad_share = _grads_within(f"rank {mesh.rank}: ring attention grads", grads,
                               want_grads, GRAD_RTOL_OF_MAX)
    kv = (k.detach(), v.detach())
    with torch.no_grad():
        fwd_ms = _timed_ms(lambda: ring_attention(q, k, v, mesh), SEQ_PIPE["TIMED"])
    times = {"ring_fwd_ms": fwd_ms,
             "ring_fwd_bwd_ms": _timed_ms(
                 lambda: torch.autograd.grad(ring_attention(*leaves, mesh), leaves, do),
                 SEQ_PIPE["TIMED"]),
             "shift_ms": _timed_ms(lambda: ring_shift(kv, mesh, "seq"), 5),
             "shift_bytes": sum(t.nbytes for t in kv)}
    if mesh.rank == 0:  # the other ranks wait at the next collective
        with torch.no_grad():
            times["whole_fwd_ms"] = _time_ms(lambda: flash_attention(*full[:3], causal=True), 10)
        times["whole_fwd_bwd_ms"] = _time_ms(
            lambda: torch.autograd.grad(flash_attention(*whole, causal=True), whole, full[3]), 10)
    return {"max_abs_err": err, "grad_share": grad_share, "fwd_launches": fwd_launches,
            "bwd_launches": bwd_launches, "times": times}


def _replicas_equal(params: dict, mesh) -> None:
    """Raises unless every leaf is bit-equal on every rank of the mesh."""
    for axis in mesh.axis_names:
        _check_equal_over(params, mesh, axis)


def _seq_steps(mesh, shape) -> dict:
    """The full-width dense and MoE SGD steps over a (data, seq) mesh of
    this shape, window None: collectives as ``step_collectives``, each
    training kernel (c + 1)·n_layers times at seq coordinate c, replicas
    bit-equal on all ranks, and rank 0 holds them to the one-process step
    (``_against_one_process``); then TIMED steps on each rank."""
    out = {}
    for name, n_experts in (("dense", None), ("MoE", MOE_EXPERTS)):
        cfg = dataclasses.replace(full_width_config(n_experts), attn_parallel="seq")
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(SEQ_PIPE["SEED"]).integers(
            0, cfg.vocab, (TRAIN["B"], TRAIN["L"])))
        local = shard_params(params, mesh, cfg)
        step = make_train_step(cfg, TRAIN["LR"], mesh)
        mesh.reset_counts()
        (new, loss), launches = _kernel_counts_of(lambda: step(local, tokens))
        counts = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
        expected = step_collectives(cfg, mesh, local, tuple(tokens.shape))
        c = mesh.coord("seq")
        want_launches = dict.fromkeys(("flash_fwd", "dq", "dkv"), (c + 1) * cfg.n_layers)
        if counts != expected or launches != want_launches:
            raise RuntimeError(f"rank {mesh.rank} {shape} {name} seq step: collectives "
                               f"{counts}, expected {expected}; launches {launches}, expected "
                               f"{want_launches}")
        _replicas_equal(new, mesh)
        one = (_one_process_step(dataclasses.replace(cfg, attn_parallel="heads"), params,
                                 tokens, mesh.device) if mesh.rank == 0 else None)
        record = {"loss": loss.item(), "launches": launches, "collectives": counts,
                  **_against_one_process(f"{shape} {name} seq step", mesh, one, new,
                                         loss.item(), ONE_PROCESS_LOSS_ATOL[name])}
        del new, one
        record["step_ms"] = _timed_ms(lambda: step(local, tokens), SEQ_PIPE["TIMED"])
        out[name] = record
        del local
        torch.cuda.empty_cache()
    return out


def _shift_wait_ms(fn) -> tuple:
    """(fn()'s value, host ms this rank spent in the ring's point-to-point
    exchanges during it): every exchange is timed from a synchronize, so
    the time is the copies through the host and the wait for the peer, not
    the compute queued before it."""
    spent = [0.0]
    exchange = collectives._exchange

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exchange(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += (time.perf_counter() - t0) * 1e3
        return got

    collectives._exchange = timed
    try:
        return fn(), spent[0]
    finally:
        collectives._exchange = exchange


def _pipeline_steps(mesh) -> dict:
    """GPipe (P 4, n_layers 4) and the interleaved schedule (P 4, v 2,
    n_layers 8) at full width, n_micro 4 on B4 L2048: each training kernel
    n_micro·v·(layers a chunk) times a step on every rank, the embedding
    bit-equal on all ranks, and rank 0 holds the gathered stages and the
    loss to the one-process step; then TIMED steps, and one more with the
    time spent in the shifts."""
    p = mesh.size("pipe")
    out = {}
    for name, v in (("GPipe", 1), ("interleaved", SEQ_PIPE["VIRTUAL"])):
        cfg = dataclasses.replace(full_width_config(), n_layers=p * v)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(SEQ_PIPE["SEED"]).integers(
            0, cfg.vocab, (TRAIN["B"], TRAIN["L"])))
        local = shard_pipeline_params(to_pipeline_params(params, p, v), mesh)
        step = make_pipeline_train_step(mesh, cfg, SEQ_PIPE["N_MICRO"], TRAIN["LR"],
                                        n_virtual=v)
        (new, loss), launches = _kernel_counts_of(lambda: step(local, tokens))
        per = cfg.n_layers // (p * v)
        want_launches = dict.fromkeys(("flash_fwd", "dq", "dkv"), SEQ_PIPE["N_MICRO"] * v * per)
        if launches != want_launches:
            raise RuntimeError(f"rank {mesh.rank} {name} pipeline step: launches {launches}, "
                               f"expected {want_launches}")
        _check_equal_over({"embed": new["embed"], "blocks": []}, mesh, "pipe")
        stages = {k: torch.cat(all_gather(t, mesh, "pipe")) for k, t in new["stages"].items()}
        one = None
        if mesh.rank == 0:
            new_one, loss_one = _one_process_step(cfg, params, tokens, mesh.device)
            one = ({"embed": new_one["embed"],
                    "stages": to_pipeline_params(new_one, p, v)["stages"]}, loss_one)
        record = {"loss": loss.item(), "launches": launches,
                  "bubble_fraction": schedule_info(SEQ_PIPE["N_MICRO"], p, v)["bubble_fraction"],
                  **_against_one_process(f"{name} pipeline step", mesh, one,
                                         {"embed": new["embed"], "stages": stages},
                                         loss.item(), NLL_ATOL)}
        del new, stages, one
        record["step_ms"] = _timed_ms(lambda: step(local, tokens), SEQ_PIPE["TIMED"])
        dist.barrier()
        t0 = time.perf_counter()
        _, record["shift_wait_ms"] = _shift_wait_ms(lambda: step(local, tokens))
        torch.cuda.synchronize()
        record["shift_wait_step_ms"] = (time.perf_counter() - t0) * 1e3
        out[name] = record
        del local
        torch.cuda.empty_cache()
    return out


def _seq_pipe_rank() -> dict:
    """One rank of phase 8; returns numbers and no tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {shape: build_mesh(shape, ("data", "seq"), "cuda") for shape in SEQ_PIPE["SEQ_SHAPES"]}
    pipe = build_mesh((SEQ_PIPE["WORLD"],), ("pipe",), "cuda")
    ring_mesh = meshes[(1, SEQ_PIPE["WORLD"])]
    out = {"rank": pipe.rank, "device": str(pipe.device), "ring": _ring_vs_one_process(ring_mesh)}
    torch.cuda.empty_cache()
    out["seq"] = {shape: _seq_steps(mesh, shape) for shape, mesh in meshes.items()}
    out["pipeline"] = _pipeline_steps(pipe)
    launches = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    for record in [*(r for steps in out["seq"].values() for r in steps.values()),
                   *out["pipeline"].values()]:
        for k in launches:
            launches[k] += record["launches"][k]
    out["launches"] = launches
    return out


def phase_seq_pipeline(card: str) -> dict:
    """Phase 8 (see the module's docstring): starts the 4 ranks once,
    prints what they measured, and returns the training kernels' launches
    on its main path (every rank's dp x sp and pipeline steps)."""
    torch.cuda.empty_cache()
    world = SEQ_PIPE["WORLD"]
    t0 = time.perf_counter()
    ranks = run_ranks(_seq_pipe_rank, world, backend=SEQ_PIPE["BACKEND"], timeout_s=900.0)
    label = (f"{world} ranks sharing one H100 over {SEQ_PIPE['BACKEND']}, not a {world}-GPU "
             f"figure [{card}]")
    print(f"seq/pipeline: {world} ranks, one process each, all on {ranks[0]['device']}, over "
          f"{SEQ_PIPE['BACKEND']} (point-to-point by way of host buffers: gloo's send and recv "
          f"take no CUDA tensor); {time.perf_counter() - t0:.1f} s with the ranks' start",
          flush=True)
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    for r in ranks:
        ring, t = r["ring"], r["ring"]["times"]
        print(f"seq/pipeline rank {r['rank']}: ring attention B{b} H{h} L{l} (4 chunks of "
              f"{l // world}) D{d} bf16 vs flash_attention over the whole sequence: max abs err "
              f"{ring['max_abs_err']:.3g} (atol {BF16_TOL['atol']}, rtol {BF16_TOL['rtol']}), "
              f"dq/dk/dv worst {ring['grad_share']:.3g} of max |grad| (limit "
              f"{GRAD_RTOL_OF_MAX}); launches forward {ring['fwd_launches']}, backward "
              f"{ring['bwd_launches']}", flush=True)
        print(f"time ring attention a layer, rank {r['rank']}: forward {_runs(t['ring_fwd_ms'])}, "
              f"forward + backward {_runs(t['ring_fwd_bwd_ms'])}; one shift of its k and v "
              f"chunks ({t['shift_bytes'] / 1e6:.1f} MB) {_runs(t['shift_ms'])} [{label}]",
              flush=True)
        if "whole_fwd_ms" in t:
            print(f"time flash_attention over the whole sequence (one process, B{b} H{h} L{l} "
                  f"D{d}, device time): forward {t['whole_fwd_ms']:.3f} ms, forward + backward "
                  f"{t['whole_fwd_bwd_ms']:.3f} ms [{card}]", flush=True)
        for shape, steps in r["seq"].items():
            for name, rec in steps.items():
                line = (f"seq/pipeline rank {r['rank']} {shape} (data, seq) full-width {name} SGD "
                        f"step: loss {rec['loss']:.4f}, launches {rec['launches']}, collectives "
                        f"{rec['collectives']}")
                if "loss_one_process" in rec:
                    line += (f"; the one-process step: loss {rec['loss_one_process']:.4f} (|diff| "
                             f"{rec['loss_err']:.3g}, limit {ONE_PROCESS_LOSS_ATOL[name]}), params "
                             f"worst {rec['worst_param'][1]} at {rec['worst_param'][0]:.3g} of "
                             f"its max |value| (limit {SHARDED_PARAM_OF_MAX:.3g})")
                print(line, flush=True)
                print(f"time seq {shape} {name} SGD step, rank {r['rank']}: "
                      f"{_runs(rec['step_ms'])} [{label}]", flush=True)
        for name, rec in r["pipeline"].items():
            line = (f"seq/pipeline rank {r['rank']} {name} pipeline step (P {world}, n_micro "
                    f"{SEQ_PIPE['N_MICRO']}): loss {rec['loss']:.4f}, launches {rec['launches']}")
            if "loss_one_process" in rec:
                line += (f"; the one-process step: loss {rec['loss_one_process']:.4f} (|diff| "
                         f"{rec['loss_err']:.3g}, limit {NLL_ATOL}), params worst "
                         f"{rec['worst_param'][1]} at {rec['worst_param'][0]:.3g} of its max "
                         f"|value| (limit {SHARDED_PARAM_OF_MAX:.3g})")
            print(line, flush=True)
            print(f"time {name} pipeline step, rank {r['rank']}: {_runs(rec['step_ms'])}; "
                  f"schedule_info bubble fraction {rec['bubble_fraction']:.3f} against "
                  f"{rec['shift_wait_ms']:.1f} ms in the shifts of a "
                  f"{rec['shift_wait_step_ms']:.1f} ms step "
                  f"({rec['shift_wait_ms'] / rec['shift_wait_step_ms']:.3f}; each exchange "
                  f"timed from a synchronize) [{label}]", flush=True)
        for k in total:
            total[k] += r["launches"][k]
    for what, losses in (
            *((f"seq {shape} {name}", [r["seq"][shape][name]["loss"] for r in ranks])
              for shape in SEQ_PIPE["SEQ_SHAPES"] for name in ("dense", "MoE")),
            *((f"{name} pipeline", [r["pipeline"][name]["loss"] for r in ranks])
              for name in ("GPipe", "interleaved"))):
        if len(set(losses)) != 1:
            raise RuntimeError(f"{what}: the ranks' losses differ: {losses}")
    print(f"seq/pipeline: launches on its main path (every rank's dp x sp and pipeline steps): "
          f"{total}", flush=True)
    return total


# --- phase 9: the mesh-growing hot-add and the multichip dryrun ---


def _add_launches(total: dict, launches: dict) -> None:
    for k in total:
        total[k] += launches[k]


def _expect_launches(what: str, got: dict, n: int) -> None:
    want = dict.fromkeys(("flash_fwd", "dq", "dkv"), n)
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def phase_grow(card: str) -> dict:
    """Phase 9a: ``entry.grow_check`` at full width, dense then MoE, from
    GROW["OLD"] to GROW["NEW"] ranks on the card: its checks (restored
    shards bit-equal, gathered again bit-equal, the first step against one
    process), the launches of every rank's steps (n_layers a step), and the
    host-clock parts of the hot-add. Returns the training kernels'
    launches on its main path (every rank's steps in both worlds)."""
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    old, new = GROW["OLD"], GROW["NEW"]
    n_old, n_new = math.prod(old), math.prod(new)
    label = (f"ranks sharing one H100 over {GROW['BACKEND']}, not a multi-GPU figure; "
             f"{old} -> {new} (data, model) [{card}]")
    for name, n_experts in (("dense", None), ("MoE", MOE_EXPERTS)):
        cfg = full_width_config(n_experts)
        torch.cuda.empty_cache()
        root = tempfile.mkdtemp()
        try:
            t0 = time.perf_counter()
            result = grow_check(old, new, backend=GROW["BACKEND"], path=os.path.join(root, "ckpt"),
                                cfg=cfg, steps=GROW["STEPS"], batch=(TRAIN["B"], TRAIN["L"]),
                                timeout_s=GROW["TIMEOUT_S"])
            seconds = time.perf_counter() - t0
            fs = _filesystem(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        for world, n_steps in (("old", GROW["STEPS"][0]), ("new", GROW["STEPS"][1])):
            for r in result[world]:
                _expect_launches(f"grow {name}, {world} world, rank {r['rank']}", r["launches"],
                                 cfg.n_layers * n_steps)
                _add_launches(total, r["launches"])
        a, b = result["old"][0], result["new"][0]
        one = b["one_process"]
        print(f"grow {name}: {n_old} -> {n_new} ranks, full width, AdamW; losses before the "
              f"hot-add {', '.join(f'{x:.4f}' for x in a['losses'])}, after "
              f"{', '.join(f'{x:.4f}' for x in b['losses'])} (every rank's equal); restored "
              f"params and both moments bit-equal to shard_params of the packed state, gathered "
              f"again bit-equal; the first step against one process from the same state: loss "
              f"{one['loss_one_process']:.4f} (|diff| {one['loss_err']:.3g}, limit "
              f"{ONE_PROCESS_LOSS_ATOL[name]}), its update with the step's gradients worst "
              f"{one['worst_param'][1]} at {one['worst_param'][0]:.3g} of its max |value| "
              f"(limit {SHARDED_PARAM_OF_MAX:.3g}); launches a rank {a['launches']} then "
              f"{b['launches']}; {seconds:.1f} s with both worlds' start", flush=True)
        times = {"pack (with its gather), rank 0": a["times"]["pack"],
                 f"save, rank 0 ({fs})": a["times"]["save"]}
        for r in result["new"]:
            for part in ("load", "restore", "optimizer"):
                times[f"{part}, rank {r['rank']}"] = r["times"][part]
        parts = "; ".join(f"{k} {_runs(v)}" for k, v in times.items())
        firsts = ", ".join(f"{r['times']['first_step']:.1f}" for r in result["new"])
        print(f"time grow {name}: {parts}; the new world's start (spawn to its last rank's "
              f"entry) {result['start_s'] * 1e3:.0f} ms; the first step, ranks 0-{n_new - 1}: "
              f"{firsts} ms [{label}]", flush=True)
    print(f"grow: launches on its main path (every rank's steps in both worlds): {total}",
          flush=True)
    return total


def phase_dryrun(card: str) -> dict:
    """Phase 9b: ``entry.dryrun_multichip(DRYRUN["N"])`` on the card, the
    reference's sections on N ranks, then the 16-rank stretch over the H100
    plan; each section's loss and errors against its limit, the launches
    of each kernel per rank (each section's count checked), and the time
    of each spawn with the ranks' start. Returns the launches on its main
    path (every rank's sharded steps, as phases 7-8 count theirs)."""
    torch.cuda.empty_cache()
    n = DRYRUN["N"]
    result = dryrun_multichip(n, backend=DRYRUN["BACKEND"], timeout_s=DRYRUN["TIMEOUT_S"])
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    n_layers = check_config().n_layers
    dp, sp = result["seq_shape"]
    secs = result["seconds"]
    print(f"dryrun: {n} ranks, then the stretch's {result['plan'].total_gpus} "
          f"({result['plan'].mesh_shape} (data, model): {result['plan'].num_hosts} hosts of "
          f"{result['plan'].gpus_per_host} {result['plan'].accel_type}), all on one card over "
          f"{DRYRUN['BACKEND']}; sections {secs['sections']:.1f} s, stretch {secs['stretch']:.1f} s, "
          f"each with its ranks' start [{card}]", flush=True)
    for r in result["sections"]:
        tp, seq, pipe = r["tp"], r["seq"], r["pipeline"]
        _expect_launches(f"dryrun tp_checks rank {r['rank']}", tp["launches"], n_layers)
        _expect_launches(f"dryrun MoE flagship rank {r['rank']}", tp["moe_launches"], n_layers)
        _expect_launches(f"dryrun seq_checks rank {r['rank']}", seq["launches"],
                         (r["rank"] % sp + 1) * n_layers)
        line = (f"dryrun rank {r['rank']}: tp_checks loss {tp['loss']:.4f}, grads through the "
                f"kernels vs the plain attention max abs err {tp['max_grad_err']:.3g} (limit "
                f"{TRAIN_GRAD_ATOL}), (q, kv) heads {tp['heads'][0]}, MoE flagship loss "
                f"{tp['moe_loss']:.4f}, make_moe_step losses "
                f"{', '.join(f'{x:.4f}' for x in tp['moe_step_losses'])}, launches "
                f"{tp['launches']} + {tp['moe_launches']}; seq_checks on ({dp}, {sp}) loss "
                f"{seq['loss']:.4f} vs unsharded |diff| {seq['loss_err']:.3g} (limit "
                f"{SHARDED_LOSS_ATOL}), ring {seq['ring_err']:.3g} and ring-flash "
                f"{seq['ring_flash_err']:.3g} (limit {RING_TOL['atol']}), launches {seq['launches']}")
        for k in total:
            total[k] += tp["launches"][k] + tp["moe_launches"][k] + seq["launches"][k]
        if pipe is not None:
            _expect_launches(f"dryrun pipeline_checks rank {r['rank']}", pipe["launches"],
                             pipe["n_micro"] * 2)
            line += (f"; pipeline_checks ({result['pipe_stages']} stages, n_micro "
                     f"{pipe['n_micro']}) loss {pipe['loss']:.4f} vs unsharded |diff| "
                     f"{pipe['loss_err']:.3g} (limit {SHARDED_LOSS_ATOL}), GPipe err "
                     f"{pipe['gpipe_err']:.3g} (limit 1e-6), launches {pipe['launches']}")
            _add_launches(total, pipe["launches"])
        print(line, flush=True)
    for r in result["stretch"]:
        _expect_launches(f"dryrun stretch rank {r['rank']}", r["launches"], n_layers)
        _add_launches(total, r["launches"])
        print(f"dryrun stretch rank {r['rank']} {r['coords']}: loss {r['loss']:.4f} vs unsharded "
              f"{r['loss_unsharded']:.4f} (|diff| {r['loss_err']:.3g}, limit "
              f"{SHARDED_LOSS_ATOL}), launches {r['launches']}, collectives "
              f"{r['collectives']['calls']}", flush=True)
    print(f"dryrun: launches on its main path (every rank's sharded steps): {total}", flush=True)
    return total


def phase_forward_timing(cfg, params, tokens, card, what="forward") -> None:
    fwd_ms = _time_ms(lambda: forward(params, tokens, cfg), 5, warmup=1)
    tok_s = tokens.numel() / (fwd_ms / 1e3)
    print(f"time {what} B{tokens.shape[0]} L{tokens.shape[1]}: {fwd_ms:.3f} ms, "
          f"{tok_s:.0f} tokens/s [{card}]", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--handoff-child"]:
        _handoff_child(json.loads(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    stages = ["1 (build)"]
    t0 = time.perf_counter()
    try:
        _phases(stages, t0)
    except Exception as err:
        message = f"chip_smoke: FAILED in phase {stages[-1]}: {type(err).__name__}: {err}"
        print(message, flush=True)
        print(message, file=sys.stderr, flush=True)
        raise
    return 0


def _phases(stage: list, t0: float) -> None:
    """Every phase in order; the name of each is appended to `stage` before
    it runs, so that a failure names it. t0: the script's start (host
    clock), for the whole run's time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    phase_build(card)
    stage.append("2 (kernels against their plain versions)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs_err = phase_kernel_vs_plain(gen)
    decode_err = phase_decode_vs_plain(gen)
    bwd_errs = phase_bwd_vs_plain(gen)

    stage.append("3 (dense main paths: forward, serving)")
    cfg = full_width_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (FULL["B"], FULL["L"]))).cuda()
               for _ in range(3)]
    launches = phase_main_path(cfg, params, batches)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE["B"], SERVE["T0"]))).cuda()
    prefill_launches, decode_launches, tokens, ref = phase_serving(cfg, params, prompt)
    stage.append("4 (captured decode step, then the MoE paths)")
    graph_step_ms = phase_graph(cfg, params, tokens, ref, card)
    del ref
    stage.append("3 (dense training)")
    train_fwd, train_dq, train_dkv = phase_train(cfg, params, batches)

    stage.append("4 (the MoE paths)")
    moe_cfg = full_width_config(n_experts=MOE_EXPERTS)
    moe_params = init_params(moe_cfg, torch.Generator().manual_seed(0), "cuda")
    moe_ffn_err = phase_moe_ffn_vs_plain(gen)
    moe_launches = phase_moe_forward(moe_cfg, moe_params, batches)
    moe_prefill, moe_decode, moe_tokens, moe_ref = phase_moe_serving(moe_cfg, moe_params, prompt)
    moe_graph_ms = phase_graph(moe_cfg, moe_params, moe_tokens, moe_ref, card)
    del moe_ref
    moe_fwd, moe_dq, moe_dkv = phase_moe_train(moe_cfg, moe_params, batches)

    stage.append("5 (timings)")
    times = phase_timings(gen, cfg, params, batches[0], card)
    bwd_times = phase_bwd_timings(gen, card)
    phase_train_timings(cfg, params, batches[0], card)
    phase_train_profile(cfg, params, batches[0], card)
    decode_times = phase_decode_timings(gen, card)
    phase_serving_timings(cfg, params, prompt, graph_step_ms, card)
    phase_forward_timing(moe_cfg, moe_params, batches[0], card, "MoE forward")
    phase_train_timings(moe_cfg, moe_params, batches[0], card)
    phase_train_profile(moe_cfg, moe_params, batches[0], card)
    phase_serving_timings(moe_cfg, moe_params, prompt, moe_graph_ms, card)
    del moe_params, params
    stage.append("6 (the handoff)")
    handoff_launches = phase_handoff(card)
    stage.append("7 (dp x tp and expert parallelism, 4 ranks sharing the card)")
    sharded_launches = phase_sharded(card)
    stage.append("8 (sequence and pipeline parallelism, 4 ranks sharing the card)")
    seq_pipe_launches = phase_seq_pipeline(card)
    stage.append("9 (the mesh-growing hot-add and the multichip dryrun, ranks sharing the card)")
    grow_launches = phase_grow(card)
    dryrun_launches = phase_dryrun(card)
    sharded = {k: sharded_launches[k] + seq_pipe_launches[k] + grow_launches[k]
               + dryrun_launches[k] for k in sharded_launches}

    stage.append("the kernels line")
    print(f"launches on the main paths: flash_fwd {launches} (forward) + "
          f"{prefill_launches} (prefill) + {train_fwd} (training), flash_decode "
          f"{decode_launches}, flash_bwd dq {train_dq} and dk/dv {train_dkv} (training); "
          f"MoE paths: flash_fwd {moe_launches} (forward) + {moe_prefill} (prefill) + "
          f"{moe_fwd} (training), flash_decode {moe_decode}, flash_bwd dq {moe_dq} and dk/dv "
          f"{moe_dkv}; moe_ffn vs moe_ffn_plain bf16 max abs err {moe_ffn_err:.3g}; the "
          f"handoff phase (its children and the uninterrupted runs): {handoff_launches}; "
          f"the sharded phase (every rank's sharded steps): {sharded_launches}; the "
          f"seq/pipeline phase (every rank's dp x sp and pipeline steps): {seq_pipe_launches}; "
          f"the grow phase (every rank's steps in both worlds): {grow_launches}; the dryrun "
          f"(every rank's sharded steps): {dryrun_launches}", flush=True)
    print(f"chip_smoke: phases 1-9 took {time.perf_counter() - t0:.1f} s, the kernels' build "
          f"included [{card}]", flush=True)
    bwd_source = "gpumounter_tpu_torch/ops/csrc/flash_bwd.cu"
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "gpumounter_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "gpumounter_tpu/ops/flash_attention.py:84",
        "launches": (launches + prefill_launches + train_fwd + moe_launches + moe_prefill
                     + moe_fwd + handoff_launches["flash_fwd"] + sharded["flash_fwd"]),
        "max_abs_err": max_abs_err, **times}, {
        "name": "flash_bwd_dq", "route": "cuda", "source": bwd_source,
        "replaces": "gpumounter_tpu/ops/flash_attention.py:182",
        "launches": train_dq + moe_dq + handoff_launches["dq"] + sharded["dq"],
        "max_abs_err": bwd_errs[0], **bwd_times["dq"]}, {
        "name": "flash_bwd_dkv", "route": "cuda", "source": bwd_source,
        "replaces": "gpumounter_tpu/ops/flash_attention.py:236",
        "launches": train_dkv + moe_dkv + handoff_launches["dkv"] + sharded["dkv"],
        "max_abs_err": bwd_errs[1], **bwd_times["dkv"]}, {
        "name": "flash_decode", "route": "cuda",
        "source": "gpumounter_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "gpumounter_tpu/ops/flash_decode.py:48",
        "launches": decode_launches + moe_decode + handoff_launches["flash_decode"],
        "max_abs_err": decode_err,
        **decode_times}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
